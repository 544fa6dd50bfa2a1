"""C3O Hub emulation (paper §III-B): job repositories carrying code +
shared runtime data + optional maintainer-supplied custom models.

A JobRepo is what a user "downloads" in workflow step (2): it bundles the
job's schema, the shared RuntimeDataStore, the candidate model list (default
models plus any maintainer custom models registered under the common model
API), and metadata for discovery on the hub.

Fits run on the device named by ``predictor_kw["device"]`` (default
"cuda"); the repo's store validates contributions on its own ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.configurator import Configurator
from repro_torch.core.datastore import RuntimeDataStore, ValidationReport
from repro_torch.core.features import JobSchema, RuntimeData
from repro_torch.core.models.api import ModelSpec, get_model, register_model
from repro_torch.core.predictor import DEFAULT_MODELS, C3OPredictor


@dataclass
class JobRepo:
    job: str
    algorithm: str                       # hub metadata: underlying algorithm
    schema: JobSchema
    store: RuntimeDataStore
    model_names: List[str] = field(default_factory=lambda: list(DEFAULT_MODELS))
    maintainer_machine_type: Optional[str] = None   # paper §IV-A
    # extra C3OPredictor constructor kwargs (fixed per repo, so they need
    # no cache-key slot): ``device`` ("cuda" unless asked otherwise) and
    # ``pad_rows``
    predictor_kw: Dict = field(default_factory=dict)
    # fitted-predictor cache, keyed on everything the fit depends on:
    # (machine_type, seed, datastore version, trust version, model list).
    # ``contribute`` bumps the store version only when data is accepted —
    # and the TRUST version whenever a judged contribution moved a
    # reputation — so hub traffic triggers a refit exactly when the data
    # or the reputation-derived row weights changed.
    _fit_cache: Dict[tuple, C3OPredictor] = field(default_factory=dict,
                                                  repr=False, compare=False)

    @property
    def device(self):
        """Where this repo's predictors fit and predict."""
        return self.predictor_kw.get("device", "cuda")

    def add_custom_model(self, spec: ModelSpec) -> None:
        """Maintainers ship job-specific models behind the common API
        (paper §III-C.c); they join the predictor's CV selection pool."""
        register_model(spec)
        if spec.name not in self.model_names:
            self.model_names.append(spec.name)

    def predictor_for(self, machine_type: str, seed: int = 0) -> C3OPredictor:
        # key on the spec OBJECTS, not names: re-registering a custom model
        # under an existing name must invalidate the cached fit.  The trust
        # version rides in the key because a REJECTED contribution changes
        # reputation (hence the row weights of rows already stored) without
        # bumping the data version.
        key = (machine_type, seed, self.store.version,
               self.store.trust_version,
               tuple(get_model(n) for n in self.model_names))
        pred = self._fit_cache.get(key)
        if pred is None:
            d = self.store.data.machine_view(machine_type)
            pred = C3OPredictor(model_names=tuple(self.model_names),
                                seed=seed, **self.predictor_kw) \
                .fit_data(d, row_weight=self.store.row_weights(d))
            # stale versions can never be requested again: evict them
            self._fit_cache = {
                k: v for k, v in self._fit_cache.items()
                if k[2] == self.store.version
                and k[3] == self.store.trust_version}
            self._fit_cache[key] = pred
        return pred

    def model_errors(self, machine_type: str, test: RuntimeData,
                     track_models: Optional[Sequence[str]] = None,
                     seed: int = 0) -> tuple:
        """Held-out (MAPE, MAE) of every tracked model on ``test`` plus the
        C3O predictor itself (paper §VI-C protocol: individual models refit
        on the shared store; the ``"c3o"`` row additionally runs LOO-CV
        model selection via ``predictor_for`` first).

        Returns ``({model: (mape, mae)}, selected_model_name)``.
        ``track_models`` may include baselines outside the repo's selection
        pool (e.g. ``"linreg"``)."""
        from repro_torch.core import engine
        specs = [get_model(n) for n in
                 (self.model_names if track_models is None else track_models)]
        tr = self.store.data.machine_view(machine_type)
        te = test.machine_view(machine_type)
        errs = engine.holdout_errors(specs, tr.X, tr.y, te.X, te.y,
                                     device=self.device)
        pred = self.predictor_for(machine_type, seed=seed)
        yhat = np.nan_to_num(pred.predict(te.X), nan=1e12, posinf=1e12,
                             neginf=-1e12)
        ae = np.abs(yhat - te.y)
        errs["c3o"] = (float(np.mean(ae / np.maximum(np.abs(te.y), 1e-9))),
                       float(np.mean(ae)))
        return errs, pred.selected

    def configurator(self, machine_type: str, prices: Dict[str, float],
                     scaleouts: Sequence[int], **kw) -> Configurator:
        return Configurator(self.predictor_for(machine_type), machine_type,
                            prices, scaleouts, **kw)

    def contribute(self, rows: RuntimeData,
                   contributor: Optional[str] = None) -> ValidationReport:
        """Workflow step (6): captured runtime data flows back, validated.
        ``contributor`` stamps the rows with the collaborator's identity
        (see ``RuntimeDataStore.contribute``)."""
        return self.store.contribute(rows, contributor=contributor)


class Hub:
    """The discovery index (paper Fig. 4, step 1)."""

    def __init__(self):
        self._repos: Dict[str, JobRepo] = {}

    def publish(self, repo: JobRepo) -> None:
        self._repos[repo.job] = repo

    def search(self, algorithm: str) -> List[JobRepo]:
        q = algorithm.lower()
        return [r for r in self._repos.values()
                if q in r.algorithm.lower() or q in r.job.lower()]

    def get(self, job: str) -> JobRepo:
        return self._repos[job]

    def jobs(self) -> List[str]:
        return sorted(self._repos)
