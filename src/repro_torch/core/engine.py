"""Prediction engine: fit, model selection by leave-one-out CV, holdout
validation and candidate-grid scoring, in PyTorch on an explicit device.

This is the port of ``repro/core/engine.py``.  The JAX engine kept one
jitted executable per ``ModelSpec``; PyTorch runs eagerly, so there is no
executable cache here.  What stays is the dispatch pattern:

``cv_select``
    builds the fold-weight matrix ``W = 1 - onehot(folds)`` [F, n] once,
    refits every model on all folds as ONE batched fit (the leading axis of
    every model's params is the fold axis; the JAX engine ``vmap``-ed it),
    reduces MAPE and residual moments on the device, and pulls a few
    scalars per model at the end.
``holdout_errors``
    fused fit + masked holdout (MAPE, MAE) per model, inputs zero-padded to
    power-of-two row buckets with 0-weight / invalid masks, exactly as the
    JAX engine pads them, so both see the same rows in the same order.
``predict``
    GBM predictors (``GBM_SPEC``, matched by identity) on a CUDA device go
    through the hand-written ensemble kernel
    (``repro_torch.kernels.gbm_predict``); everything else, and every model
    on the CPU, through the model's own PyTorch predict.  The device
    decides; there is no switch.

``cache_stats`` / ``cache_clear`` count fit, predict, CV and validation
dispatches (the JAX engine counted cached executables): a warm start that
restores fitted predictors shows zero fit and CV work.

Float32 throughout, as in the JAX package: host data in float64 is cast to
float32 before it reaches the device.  TF32 is switched off below, so the
normal equations of ridge and ernest and the optimistic models' group
products run in full fp32 on the card, as on the CPU.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.models.api import ModelSpec, as_device, to_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_COUNTS = {"fit": 0, "predict": 0, "cv": 0, "val": 0}


def cache_stats() -> Dict[str, int]:
    """Dispatch counters since the last ``cache_clear``."""
    return dict(_COUNTS)


def cache_clear() -> None:
    """Reset the dispatch counters (tests emulate a fresh process with this:
    after a warm-start restore, zero fit/cv counts prove no refit)."""
    for k in _COUNTS:
        _COUNTS[k] = 0


def _f32(a, device) -> torch.Tensor:
    """float32 tensor on ``device`` (the cast happens on the host)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _nan_to_num(t: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(t, nan=1e12, posinf=1e12, neginf=-1e12)


def _bucket(n: int, lo: int = 32) -> int:
    """Next power-of-two shape bucket >= n."""
    b = lo
    while b < n:
        b *= 2
    return b


def bucket_rows(n: int, lo: int = 32) -> int:
    """Public row-bucketing policy (``C3OPredictor(pad_rows=True)`` pads
    training batches to this)."""
    return _bucket(n, lo)


# --------------------------------------------------------------------------
# Fit and prediction
# --------------------------------------------------------------------------

def fit(spec: ModelSpec, X: np.ndarray, y: np.ndarray, w: np.ndarray, aux,
        device):
    """One weighted fit; params carry a leading fold axis of 1."""
    device = as_device(device)
    _COUNTS["fit"] += 1
    return spec.fit(_f32(X, device), _f32(y, device),
                    _f32(w, device)[None, :], aux)


def predict(spec: ModelSpec, params, X, aux, device) -> torch.Tensor:
    """Batched prediction [m] on ``device`` (no host sync).

    GBM predictors on a CUDA device route through the ensemble kernel; the
    match is on spec identity, not name, so a maintainer model re-registered
    as "gbm" (with foreign params) never reaches the kernel."""
    from repro_torch.core.models.gbm import GBM_SPEC
    device = as_device(device)
    _COUNTS["predict"] += 1
    Xt = _f32(X, device)
    if spec is GBM_SPEC and device.type == "cuda":
        from repro_torch.kernels.gbm_predict import gbm_predict
        return gbm_predict(Xt.contiguous(), params.feat[0].contiguous(),
                           params.thr[0].contiguous(),
                           params.leaf[0].contiguous(), params.f0,
                           params.y_scale)
    return spec.predict(params, Xt, aux)[0]


# --------------------------------------------------------------------------
# Holdout validation
# --------------------------------------------------------------------------

def holdout_errors(specs: Sequence[ModelSpec], X_tr: np.ndarray,
                   y_tr: np.ndarray, X_te: np.ndarray, y_te: np.ndarray,
                   row_weight: Optional[np.ndarray] = None, *,
                   device="cuda") -> Dict[str, Tuple[float, float]]:
    """Held-out (MAPE, MAE) per model: a weighted fit on the training split
    and a masked error on the test split, each model dispatched before the
    single host pull at the end.

    Both splits are zero-padded to power-of-two row buckets with 0-weight /
    invalid rows, as the JAX engine pads them.  ``row_weight`` (fractional,
    [n_tr]) scales each training row's weight; None keeps every real row at
    1.0."""
    device = as_device(device)
    X_tr64 = np.asarray(X_tr, np.float64)
    n_tr, n_te = len(y_tr), len(y_te)
    b_tr, b_te = _bucket(n_tr), _bucket(n_te)
    Xp = np.zeros((b_tr, X_tr64.shape[1]), np.float64)
    Xp[:n_tr] = X_tr64
    yp = np.ones(b_tr, np.float32)
    yp[:n_tr] = y_tr
    w = np.zeros(b_tr, np.float32)
    w[:n_tr] = 1.0 if row_weight is None else row_weight
    Xq = np.zeros((b_te, Xp.shape[1]), np.float64)
    Xq[:n_te] = np.asarray(X_te, np.float64)
    yq = np.ones(b_te, np.float32)
    yq[:n_te] = y_te
    valid = np.zeros(b_te, np.float32)
    valid[:n_te] = 1.0
    Xtr, ytr, W = _f32(Xp, device), _f32(yp, device), _f32(w, device)[None]
    Xte, yte, vt = _f32(Xq, device), _f32(yq, device), _f32(valid, device)
    cnt = vt.sum().clamp_min(1.0)
    pending = []
    for spec in specs:
        _COUNTS["val"] += 1
        aux = spec.make_aux(Xp, device)
        pred = _nan_to_num(spec.predict(spec.fit(Xtr, ytr, W, aux), Xte,
                                        aux)[0])
        err = torch.abs(pred - yte)
        ape = err / torch.abs(yte).clamp_min(1e-9)
        pending.append(torch.stack([(ape * vt).sum() / cnt,
                                    (err * vt).sum() / cnt]))
    host = to_numpy(torch.stack(pending)) if pending else []   # one pull
    return {spec.name: (float(m), float(a))
            for spec, (m, a) in zip(specs, host)}


def holdout_mape(specs: Sequence[ModelSpec], X_tr: np.ndarray,
                 y_tr: np.ndarray, X_te: np.ndarray, y_te: np.ndarray,
                 row_weight: Optional[np.ndarray] = None, *,
                 device="cuda") -> float:
    """Best (lowest) held-out MAPE over the model pool (§III-C.b
    contribution validation consumes exactly this scalar)."""
    errs = holdout_errors(specs, X_tr, y_tr, X_te, y_te,
                          row_weight=row_weight, device=device)
    return min(mape for mape, _ in errs.values())


# --------------------------------------------------------------------------
# Fused multi-model cross-validation / selection
# --------------------------------------------------------------------------

def _cv(spec: ModelSpec, X, y, W, fold_idx, valid, aux):
    """LOO-CV of one model: every fold's weighted refit as one batched fit,
    each fold predicting its own held-out row -> (mape, mu, sigma) as
    device scalars."""
    params = spec.fit(X, y, W, aux)
    pred = _nan_to_num(spec.predict(params, X[fold_idx][:, None, :],
                                    aux)[:, 0])
    y_f = y[fold_idx]
    ape = torch.abs(pred - y_f) / torch.abs(y_f).clamp_min(1e-9)
    resid = pred - y_f
    cnt = valid.sum().clamp_min(1.0)
    mape = (ape * valid).sum() / cnt
    mu = (resid * valid).sum() / cnt
    sigma = torch.sqrt(((resid * resid * valid).sum() / cnt - mu * mu)
                       .clamp_min(0.0))
    return torch.stack([mape, mu, sigma])


def cv_select(specs: Sequence[ModelSpec], X: np.ndarray, y: np.ndarray,
              folds: np.ndarray, *, row_weight: Optional[np.ndarray] = None,
              device="cuda") -> Tuple[str, Dict[str, float], float, float]:
    """LOO-CV every model; returns (selected name, {name: mape}, resid mu,
    resid sigma of the selected).

    ``row_weight`` (per row of ``X``) multiplies every fold's weights, so
    callers (``C3OPredictor(pad_rows=True)``) may zero-pad the data rows;
    the fold list is then padded to a power-of-two bucket too, masked by
    ``valid``, as in the JAX engine.  Folds must index real rows."""
    device = as_device(device)
    X64 = np.asarray(X, np.float64)
    Xt = _f32(X64, device)
    yt = _f32(y, device)
    folds = np.asarray(folds)
    F = len(folds)
    F_pad = _bucket(F, 8) if row_weight is not None else F
    folds_p = np.concatenate([folds, np.zeros(F_pad - F, folds.dtype)])
    valid = _f32(np.concatenate([np.ones(F, np.float32),
                                 np.zeros(F_pad - F, np.float32)]), device)
    fold_t = torch.as_tensor(folds_p.astype(np.int64), device=device)
    W = 1.0 - torch.nn.functional.one_hot(fold_t, len(yt)).float()
    if row_weight is not None:
        W = W * _f32(row_weight, device)[None, :]
    pending = []
    for spec in specs:
        _COUNTS["cv"] += 1
        pending.append(_cv(spec, Xt, yt, W, fold_t, valid,
                           spec.make_aux(X64, device)))
    host = to_numpy(torch.stack(pending))                     # one pull
    mapes = {s.name: float(r[0]) for s, r in zip(specs, host)}
    stats = {s.name: (float(r[1]), float(r[2])) for s, r in zip(specs, host)}
    best = min(mapes, key=mapes.get)        # ties: first in model order
    mu, sigma = stats[best]
    return best, mapes, mu, sigma + 1e-12


# --------------------------------------------------------------------------
# Grid-scored configuration
# --------------------------------------------------------------------------

def grid_rows(scaleouts: Sequence[int], contexts: np.ndarray) -> np.ndarray:
    """[S*C, 1+k] feature rows for the (scale-out x context) grid,
    scale-out-major (row s*C + c pairs scaleouts[s] with contexts[c])."""
    contexts = np.atleast_2d(np.asarray(contexts, np.float64))
    S = np.asarray(scaleouts, np.float64)
    C, k = contexts.shape
    rows = np.empty((len(S), C, k + 1), np.float64)
    rows[..., 0] = S[:, None]
    rows[..., 1:] = contexts[None, :, :]
    return rows.reshape(-1, k + 1)


def _predict_rows(predictor, rows: np.ndarray):
    """Prefer the device-level (non-syncing) predict when available so
    multi-predictor sweeps queue every prediction before the first pull."""
    dev = getattr(predictor, "predict_device", None)
    return dev(rows) if dev is not None else predictor.predict(rows)


def _host(p) -> np.ndarray:
    return to_numpy(p) if isinstance(p, torch.Tensor) \
        else np.asarray(p, np.float64)


def score_grid(predictor, scaleouts: Sequence[int], contexts: np.ndarray
               ) -> Tuple[np.ndarray, float, float]:
    """Runtime predictions for the whole (scale-out x context) grid in ONE
    predictor call: -> (t [C, S], mu, sigma)."""
    contexts = np.atleast_2d(np.asarray(contexts, np.float64))
    rows = grid_rows(scaleouts, contexts)
    t, mu, sigma = predictor.predict_with_error(rows)
    t = np.asarray(t, np.float64).reshape(len(scaleouts), len(contexts)).T
    return t, mu, sigma


def machine_grid_runtimes(predictors: Dict[str, object],
                          scaleouts: Sequence[int],
                          contexts: np.ndarray
                          ) -> Tuple[List[str], np.ndarray]:
    """Runtime predictions for the (machine x scale-out x context) grid:
    every machine's prediction is queued before the first host pull.
    Returns (machine names, t [M, C, S]) with runtimes clamped at >= 0 (a
    negative runtime would make a negative cost win every cheapest-choice
    selection downstream)."""
    contexts = np.atleast_2d(np.asarray(contexts, np.float64))
    rows = grid_rows(scaleouts, contexts)
    names, pending = [], []
    for m, pred in predictors.items():
        names.append(m)
        pending.append(_predict_rows(pred, rows))           # async dispatch
    t = np.stack([_host(p).reshape(len(scaleouts), len(contexts)).T
                  for p in pending])
    return names, np.maximum(t, 0.0)


def machine_grid_costs(predictors: Dict[str, object],
                       prices: Dict[str, float],
                       scaleouts: Sequence[int],
                       contexts: np.ndarray
                       ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Score the full (machine x scale-out x context) grid; returns
    (machine names, t [M, C, S], cost [M, C, S])."""
    names, t = machine_grid_runtimes(predictors, scaleouts, contexts)
    S = np.asarray(scaleouts, np.float64)
    cost = np.stack([prices[m] for m in names])[:, None, None] \
        * (t / 3600.0) * S[None, None, :]
    return names, t, cost


def placement_grid_costs(predictors: Dict[str, object], book,
                         scaleouts: Sequence[int], contexts: np.ndarray,
                         zones=None, options=None):
    """Score the (machine x placement x context x scale-out) grid.

    The placement axis is numpy broadcasting over the same runtime
    predictions as ``machine_grid_costs``: predicted runtime does not
    depend on where the cluster is bought.  ``book`` is a
    ``repro_torch.core.market.PriceBook``; returns

        (names, placements, t [M, C, S],
         et [M, P, C, S], naive [M, P, C, S], adjusted [M, P, C, S])

    where ``et`` is the interruption-adjusted expected completion time,
    ``naive`` the listed-price cost and ``adjusted`` the
    interruption-adjusted expected cost."""
    from repro_torch.core.market import expected_completion_time_s
    names, t = machine_grid_runtimes(predictors, scaleouts, contexts)
    placements = book.resolve(zones, options)
    prices = book.price_matrix(names, placements)           # [M, P]
    rates = book.rates(placements)                          # [P]
    S = np.asarray(scaleouts, np.float64)
    et = expected_completion_time_s(t[:, None, :, :],
                                    rates[None, :, None, None],
                                    book.restart_overhead_s)
    # same op order as machine_grid_costs so a flat (single-placement,
    # rate-0) book reproduces the static cost bit-for-bit
    p4 = prices[:, :, None, None]
    naive = p4 * (t[:, None, :, :] / 3600.0) * S[None, None, None, :]
    adjusted = p4 * (et / 3600.0) * S[None, None, None, :]
    return names, placements, t, et, naive, adjusted
