"""Weighted ridge regression (building block for BOM), batched over folds."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.models.api import ModelSpec, register_model, row_dot


class RidgeParams(NamedTuple):
    beta: torch.Tensor      # [F, d+1] (bias last)
    mu: torch.Tensor        # [F, d] feature means
    sd: torch.Tensor        # [F, d] feature stds


def _design(X, p_mu, p_sd):
    """[.., n, d] features -> standardized [F, n, d+1] with a bias column."""
    Xn = (X - p_mu[:, None, :]) / p_sd[:, None, :]
    return torch.cat([Xn, torch.ones_like(Xn[..., :1])], -1)


def ridge_fit(X, y, W, lam=1e-4) -> RidgeParams:
    """X [n, d] or [F, n, d]; y [n] or [F, n]; W [F, n] fold weights."""
    W = W.float()
    wsum = W.sum(-1).clamp_min(1e-12)                        # [F]
    mu = (W[..., None] * X).sum(-2) / wsum[:, None]
    var = (W[..., None] * torch.square(X - mu[:, None, :])).sum(-2) \
        / wsum[:, None]
    sd = torch.sqrt(var.clamp_min(1e-12))
    A = _design(X, mu, sd)                                   # [F, n, d+1]
    Aw = A * W[..., None]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    G = A.transpose(-1, -2) @ Aw + lam * eye
    b = (Aw.transpose(-1, -2) @ y[..., None])[..., 0]
    beta = torch.linalg.solve(G, b)
    return RidgeParams(beta, mu, sd)


def ridge_predict(p: RidgeParams, X) -> torch.Tensor:
    """X [m, d] or [F, m, d] -> [F, m]; a row's value does not depend on
    the other rows (``row_dot``)."""
    return row_dot(_design(X, p.mu, p.sd), p.beta)


register_model(ModelSpec(
    "linreg",
    lambda X, device: {},
    lambda X, y, W, aux: ridge_fit(X, y, W),
    lambda p, X, aux: ridge_predict(p, X)))
