"""The C3O runtime predictor (paper §V): dynamic model selection.

On every (re)fit, all candidate models are cross-validated on the current
training data with leave-one-out folds (capped, paper §VI-C: the selection
phase must be bounded as data grows) and the lowest-MAPE model is selected.
The CV residuals of the selected model calibrate the Gaussian error model
(mu, sigma) the configurator's confidence formula consumes (paper §IV-B).

Every model's folds refit as one batched fit on ``device`` through the
engine (``repro_torch.core.engine.cv_select``), with one host pull at the
end.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.models.api import FittedModel, get_model, tree_map

DEFAULT_MODELS = ("ernest", "gbm", "bom", "ogb")


@dataclass
class C3OPredictor:
    model_names: Sequence[str] = DEFAULT_MODELS
    max_cv_folds: int = 30
    seed: int = 0
    # pad the training rows to power-of-two buckets (0-weight rows are
    # inert for every weighted model), as the JAX package does for stores
    # that grow row by row.  Off by default: unpadded numerics stay the
    # reference.
    pad_rows: bool = False
    # where fits and predictions run; "cpu" must be asked for
    device: str = "cuda"

    # set by fit():
    selected: Optional[str] = None
    cv_mape: Dict[str, float] = field(default_factory=dict)
    mu: float = 0.0
    sigma: float = 0.0

    def fit_data(self, data, row_weight=None) -> "C3OPredictor":
        """Fit from a columnar ``RuntimeData`` view (typically a cached
        ``machine_view``)."""
        return self.fit(data.X, data.y, row_weight=row_weight)

    def fit(self, X: np.ndarray, y: np.ndarray,
            row_weight: Optional[np.ndarray] = None) -> "C3OPredictor":
        """``row_weight`` (fractional, [n]) down-weights suspect rows in
        CV selection AND the final fit — the trust plane derives it from
        contributor reputation (``RuntimeDataStore.row_weights``).  None
        keeps the unweighted path."""
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        n = len(y)
        if row_weight is not None:
            row_weight = np.asarray(row_weight, np.float64)
            if row_weight.shape != (n,):
                raise ValueError(f"row_weight has shape {row_weight.shape},"
                                 f" expected ({n},)")
        rng = np.random.default_rng(self.seed)
        folds = (np.arange(n) if n <= self.max_cv_folds
                 else rng.choice(n, self.max_cv_folds, replace=False))
        w = row_weight
        if self.pad_rows:
            # always hand cv_select a weight vector — even when n already
            # sits on a bucket boundary — so the fold axis is bucketed too
            b = engine.bucket_rows(n)
            Xp = np.zeros((b, X.shape[1]), np.float64)
            Xp[:n] = X
            yp = np.ones(b, np.float64)           # inert targets (w=0)
            yp[:n] = y
            w = np.zeros(b, np.float64)
            w[:n] = 1.0 if row_weight is None else row_weight
            X, y = Xp, yp
        specs = [get_model(name) for name in self.model_names]
        best, mapes, mu, sigma = engine.cv_select(specs, X, y, folds,
                                                  row_weight=w,
                                                  device=self.device)
        self.cv_mape.update(mapes)
        self.selected = best
        self.mu = mu
        self.sigma = sigma
        self._fitted = FittedModel(get_model(best), X, y, w,
                                   device=self.device)
        return self

    # ------------------- warm-start persistence ---------------------------
    def export_state(self) -> Dict:
        """Everything a fresh process needs to serve predictions without
        refitting: selected model, its fitted params (numpy leaves with the
        leading fold axis of 1), and the CV calibration."""
        if self.selected is None:
            raise ValueError("predictor not fitted; nothing to export")
        params_np = tree_map(lambda a: a.detach().cpu().numpy(),
                             self._fitted.params)
        return {"model_names": tuple(self.model_names),
                "max_cv_folds": self.max_cv_folds,
                "seed": self.seed,
                "selected": self.selected,
                "cv_mape": dict(self.cv_mape),
                "mu": self.mu,
                "sigma": self.sigma,
                "params": params_np}

    @classmethod
    def _restore(cls, state: Dict, X: np.ndarray, params,
                 device) -> "C3OPredictor":
        pred = cls(model_names=tuple(state["model_names"]),
                   max_cv_folds=int(state["max_cv_folds"]),
                   seed=int(state["seed"]), device=device)
        pred.selected = state["selected"]
        pred.cv_mape = dict(state["cv_mape"])
        pred.mu = float(state["mu"])
        pred.sigma = float(state["sigma"])
        pred._fitted = FittedModel.from_params(
            get_model(pred.selected), np.asarray(X, np.float64), params,
            device=device)
        return pred

    @classmethod
    def from_state(cls, state: Dict, X: np.ndarray,
                   device="cuda") -> "C3OPredictor":
        """Rebuild a fitted predictor from ``export_state`` output plus the
        training data it was fitted on.  No fit or CV runs — only
        ``make_aux``."""
        return cls._restore(state, X, state["params"], device)

    @classmethod
    def from_reference_state(cls, state: Dict, X: np.ndarray,
                             device="cuda") -> "C3OPredictor":
        """Rebuild a fitted predictor from the JAX package's
        ``C3OPredictor.export_state()`` output, its params carried over by
        ``repro_torch.core.convert``."""
        from repro_torch.core.convert import params_from_reference
        return cls._restore(state, X,
                            params_from_reference(state["params"], device),
                            device)

    def predict_device(self, X) -> torch.Tensor:
        """Device-resident batched prediction (no host sync); grid sweeps
        use this to queue predictions across predictors."""
        return self._fitted.predict_device(np.asarray(X, np.float64))

    def predict(self, X) -> np.ndarray:
        return self._fitted.predict(np.asarray(X, np.float64))

    def predict_with_error(self, X) -> Tuple[np.ndarray, float, float]:
        """(predictions, mu, sigma) — sigma from CV residuals (paper §IV-B)."""
        return self.predict(X), self.mu, self.sigma


def evaluate_split(model_names, X_tr, y_tr, X_te, y_te,
                   include_c3o: bool = True, max_cv_folds: int = 20,
                   seed: int = 0, device="cuda") -> Dict[str, float]:
    """MAPE of each model (and the C3O predictor) for one train/test split.

    This is the evaluation protocol of paper §VI-C: individual models are fit
    on the train split and scored on the test split; the C3O row additionally
    runs model selection (LOO on the train split) before scoring.
    """
    out = {}
    pending = []                # dispatch every model before the first pull
    for name in model_names:
        fm = FittedModel(get_model(name), X_tr, y_tr, device=device)
        pending.append((name, fm.predict_device(np.asarray(X_te, np.float64))))
    for name, p in pending:
        pred = np.nan_to_num(p.detach().cpu().numpy().astype(np.float64),
                             nan=1e12, posinf=1e12, neginf=-1e12)
        out[name] = float(np.mean(np.abs(pred - y_te)
                                  / np.maximum(np.abs(y_te), 1e-9)))
    if include_c3o:
        p = C3OPredictor(model_names=model_names, max_cv_folds=max_cv_folds,
                         seed=seed, device=device).fit(X_tr, y_tr)
        pred = np.nan_to_num(p.predict(X_te), nan=1e12, posinf=1e12,
                             neginf=-1e12)
        out["c3o"] = float(np.mean(np.abs(pred - y_te)
                                   / np.maximum(np.abs(y_te), 1e-9)))
        out["c3o_selected"] = p.selected
    return out
