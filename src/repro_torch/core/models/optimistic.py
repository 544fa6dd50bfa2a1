"""Optimistic models (paper §V-B): SSM (x) IBM factorization, batched over
folds.

Assumes runtime-influencing factors are pairwise independent:
    t(s, ctx) = IBM(ctx) * g(s),   g(1) = 1
The scale-out-to-speedup model (SSM) g is learned from *context groups* —
sets of runs identical in every feature except the scale-out (column 0).
Groups with fewer than two (weighted) members carry no scale-out signal and
are excluded from the SSM fit.

  BOM: third-degree-polynomial SSM, linear-regression IBM
  OGB: GBM SSM, GBM IBM

The group one-hot is padded to [n, n] columns (numpy, in ``make_aux``).
Per-fold group sums are products with it (W [F, n] @ onehot [n, n]), so the
[F, n, n] per-fold weighted one-hot is never materialized.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.models.api import ModelSpec, register_model
from repro_torch.core.models.gbm import gbm_fit, gbm_predict
from repro_torch.core.models.linear import ridge_fit, ridge_predict

MIN_RATIO = 0.05


class OptimisticParams(NamedTuple):
    ssm: object               # RidgeParams (poly basis) or GBMParams
    ssm_ref: torch.Tensor     # [F] g(1) normalizer
    ibm: object               # RidgeParams or GBMParams


def _poly_feats(s):
    s = s.clamp_min(1e-6)
    return torch.stack([s, s * s, s * (s * s)], -1)


def _split(X):
    s = X[..., 0]
    ctx = X[..., 1:] if X.shape[-1] > 1 else torch.zeros_like(X[..., :1])
    return s, ctx


def _make_aux(X: np.ndarray, device):
    n = X.shape[0]
    ctx = np.round(X[:, 1:].astype(np.float64), 9)
    if ctx.shape[1] == 0:
        gid = np.zeros(n, np.int64)
    else:
        _, gid = np.unique(ctx, axis=0, return_inverse=True)
    onehot = np.zeros((n, n), np.float32)        # padded to n groups
    onehot[np.arange(n), gid.reshape(-1)] = 1.0
    s_np = X[:, :1]
    ctx_np = X[:, 1:] if X.shape[1] > 1 else np.zeros((n, 1))
    return {"onehot": torch.as_tensor(onehot, device=device),
            "ssm_orders": torch.as_tensor(np.argsort(s_np, axis=0).T,
                                          device=device),
            "ibm_orders": torch.as_tensor(np.argsort(ctx_np, axis=0).T,
                                          device=device)}


def _make(ssm_kind: str, ibm_kind: str, name: str):
    def ssm_fit(s, ratio, w, aux):
        if ssm_kind == "poly3":
            # cubic in log space: g(s) strictly positive; wild coefficients
            # (the small-data failure mode) still blow up via exp
            return ridge_fit(_poly_feats(s),
                             torch.log(ratio.clamp_min(1e-3)), w, lam=3e-3)
        return gbm_fit(s[:, None], ratio, w, aux["ssm_orders"],
                       n_trees=50, depth=2, lr=0.15, log_target=True)

    def ssm_eval(p, s):
        if ssm_kind == "poly3":
            return torch.exp(ridge_predict(p, _poly_feats(s))
                             .clamp(-4.0, 4.0))
        return gbm_predict(p, s[..., None])

    def ibm_fit(ctx, t1, w, aux):
        if ibm_kind == "linreg":
            return ridge_fit(ctx, t1, w)
        return gbm_fit(ctx, t1, w, aux["ibm_orders"], n_trees=100, depth=3,
                       lr=0.1, log_target=True)

    def ibm_eval(p, ctx):
        if ibm_kind == "linreg":
            return ridge_predict(p, ctx)
        return gbm_predict(p, ctx)

    def fit(X, y, W, aux):
        s, ctx = _split(X)
        onehot = aux["onehot"]
        W = W.float()
        logt = torch.log(y.clamp_min(1e-6))
        cnt = W @ onehot                                     # [F, G]
        beta = ((W * logt) @ onehot) / cnt.clamp_min(1e-12)
        eligible_g = (cnt >= 1.5).float()                    # >=2 members
        base = torch.exp(beta @ onehot.T)                    # [F, n]
        ratio = y / base.clamp_min(1e-9)
        w_ssm = W * (eligible_g @ onehot.T)
        ssm_p = ssm_fit(s, ratio, w_ssm, aux)
        g_raw = ssm_eval(ssm_p, s).clamp_min(MIN_RATIO)
        g1 = ssm_eval(ssm_p, torch.ones_like(s[:1]))[:, 0] \
            .clamp_min(MIN_RATIO)
        t1 = y / (g_raw / g1[:, None])                       # project s -> 1
        ibm_p = ibm_fit(ctx, t1, W, aux)
        return OptimisticParams(ssm_p, g1, ibm_p)

    def predict(p: OptimisticParams, X, aux):
        s, ctx = _split(X)
        g = ssm_eval(p.ssm, s).clamp_min(MIN_RATIO) / p.ssm_ref[:, None]
        return ibm_eval(p.ibm, ctx) * g

    return ModelSpec(name, _make_aux, fit, predict)


register_model(_make("poly3", "linreg", "bom"))
register_model(_make("gbm", "gbm", "ogb"))
