"""Common runtime-model API (paper §III-C.c: custom models share one API).

Models are plain functions on tensors, batched over a leading FOLD axis:
leave-one-out cross-validation is one weighted refit per fold, and every
fold shares the data rows, so the fold weights ``W`` [F, n] carry the only
per-fold input.  A single fit is F = 1.

Each model is three functions:

  make_aux(X_np, device)    -> dict of tensors on ``device`` (sort orders,
                               group one-hots, ...), computed with numpy
  fit(X, y, W, aux)         -> params, a NamedTuple of tensors with a
                               leading [F] axis (W = 0 drops a sample)
  predict(params, X, aux)   -> yhat [F, m]; X is [m, d] (shared by every
                               fold) or [F, m, d]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ModelSpec:
    name: str
    make_aux: Callable          # (X np [n,d], device) -> aux dict
    fit: Callable               # (X, y, W, aux) -> params
    predict: Callable           # (params, X, aux) -> yhat


_REGISTRY: Dict[str, ModelSpec] = {}


def register_model(spec: ModelSpec) -> ModelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_model(name: str) -> ModelSpec:
    from repro_torch.core.models import ernest, gbm, linear, optimistic  # noqa: F401
    return _REGISTRY[name]


def model_names():
    from repro_torch.core.models import ernest, gbm, linear, optimistic  # noqa: F401
    return sorted(_REGISTRY)


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA where there is no
    card raises here rather than deep inside the first allocation."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def tree_map(fn: Callable, params):
    """Apply ``fn`` to every tensor (or array) leaf of a params tree of
    NamedTuples."""
    if isinstance(params, tuple) and hasattr(params, "_fields"):
        return type(params)(*(tree_map(fn, p) for p in params))
    return fn(params)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a (possibly device) tensor as float64 numpy."""
    return t.detach().cpu().numpy().astype(np.float64)


class FittedModel:
    """Object wrapper for single-fit use (configurator, examples).

    Holds params with a leading fold axis of 1 on ``device``."""

    def __init__(self, spec: ModelSpec, X: np.ndarray, y: np.ndarray,
                 w: Optional[np.ndarray] = None, device="cuda"):
        from repro_torch.core import engine   # local import: engine imports us
        X = np.asarray(X, np.float64)
        self.spec = spec
        self.device = as_device(device)
        self.aux = spec.make_aux(X, self.device)
        w = np.ones(len(y)) if w is None else w
        self.params = engine.fit(spec, X, y, w, self.aux, self.device)
        self.name = spec.name

    @classmethod
    def from_params(cls, spec: ModelSpec, X: np.ndarray, params,
                    device="cuda") -> "FittedModel":
        """Rebuild a fitted model from the port's params (tensor or numpy
        leaves, leading fold axis of 1) WITHOUT fitting: ``aux`` is
        recomputed from the training features."""
        self = cls.__new__(cls)
        X = np.asarray(X, np.float64)
        self.spec = spec
        self.device = as_device(device)
        self.aux = spec.make_aux(X, self.device)
        self.params = tree_map(
            lambda a: torch.as_tensor(a, device=self.device), params)
        self.name = spec.name
        return self

    def predict_device(self, X) -> torch.Tensor:
        """Device-resident prediction (no host sync) — lets grid sweeps
        queue many predictions before pulling results."""
        from repro_torch.core import engine
        return engine.predict(self.spec, self.params, X, self.aux,
                              device=self.device)

    def predict(self, X) -> np.ndarray:
        return to_numpy(self.predict_device(X))
