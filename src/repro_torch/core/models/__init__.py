"""Runtime models (paper §V), batched over a leading fold axis."""
from repro_torch.core.models import ernest, gbm, linear, optimistic  # noqa: F401
from repro_torch.core.models.api import (FittedModel, ModelSpec, get_model,
                                         model_names, register_model)
