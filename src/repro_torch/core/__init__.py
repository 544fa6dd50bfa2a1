"""The paper's primary contribution, in PyTorch: collaborative
cluster-configuration optimization — runtime prediction models, dynamic
model selection, the confidence-based configurator, and the shared-data
machinery."""
from repro_torch.core.configurator import (ClusterChoice, Configurator,
                                           choose_machine_type,
                                           confidence_margin)
from repro_torch.core.datastore import RuntimeDataStore, ValidationReport
from repro_torch.core.features import JobSchema, RuntimeData
from repro_torch.core.hub import Hub, JobRepo
from repro_torch.core.predictor import (DEFAULT_MODELS, C3OPredictor,
                                        evaluate_split)
from repro_torch.core.service import ConfigurationService
