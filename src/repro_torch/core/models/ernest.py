"""Ernest baseline (Venkataraman et al., NSDI'16), paper §VI baseline.

t(s, z) = θ0 + θ1 * z/s + θ2 * log(s) + θ3 * s,   θ >= 0  (NNLS)

Only understands dataset size (column 1) and scale-out (column 0).  NNLS by
a fixed count of projected-gradient steps on the normal equations
(Lipschitz step), batched over folds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.models.api import ModelSpec, register_model


class ErnestParams(NamedTuple):
    theta: torch.Tensor      # [F, 4] >= 0
    scale: torch.Tensor      # [F] target normalization


def _basis(X):
    """[.., n, d] -> [.., n, 4]."""
    s = X[..., 0].clamp_min(1.0)
    z = X[..., 1] if X.shape[-1] > 1 else torch.ones_like(s)
    return torch.stack([torch.ones_like(s), z / s, torch.log(s), s], -1)


def ernest_fit(X, y, W, iters: int = 400) -> ErnestParams:
    A = _basis(X)                                            # [n, 4]
    W = W.float()
    scale = ((W * torch.abs(y)).sum(-1) / W.sum(-1).clamp_min(1e-12)) \
        .clamp_min(1e-12)                                    # [F]
    yn = y / scale[:, None]                                  # [F, n]
    # column-normalize for conditioning
    cn = torch.sqrt((W[..., None] * A ** 2).sum(-2)).clamp_min(1e-12)
    An = A / cn[:, None, :]                                  # [F, n, 4]
    AnW = (An * W[..., None]).transpose(-1, -2)
    G = AnW @ An                                             # [F, 4, 4]
    b = (AnW @ yn[..., None])[..., 0]                        # [F, 4]
    L = torch.linalg.matrix_norm(G, ord=2) + 1e-6            # Lipschitz
    th = (b / torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-9)) \
        .clamp_min(0.0)
    for _ in range(iters):
        g = (G @ th[..., None])[..., 0] - b
        th = (th - g / L[:, None]).clamp_min(0.0)
    return ErnestParams(th / cn, scale)


def ernest_predict(p: ErnestParams, X) -> torch.Tensor:
    """X [m, d] or [F, m, d] -> [F, m]."""
    return (_basis(X) @ p.theta[..., None])[..., 0] * p.scale[:, None]


register_model(ModelSpec(
    "ernest",
    lambda X, device: {},
    lambda X, y, W, aux: ernest_fit(X, y, W),
    lambda p, X, aux: ernest_predict(p, X)))
