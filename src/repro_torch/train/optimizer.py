"""Optimizers that update parameters in place: AdamW and Adafactor.

Port of ``repro/train/optimizer.py``.  Parameters, gradients and optimizer
state are dicts keyed by parameter name (``dict(model.named_parameters())``
for a model).  The moments are float32 and the update is computed in
float32, then cast to the parameter's type, as the JAX package does; the
update is written into the parameter under ``torch.no_grad()``, one leaf at
a time, so the float32 temporaries are one leaf's.  The JAX package scans
large stacked leaves layer by layer to bound XLA's temporaries; the port's
leaves are per layer already, so it has no counterpart.

Adafactor factors the second moment of every leaf with two or more dims.
The JAX package's leaves under ``blocks`` are stacked over the scanned
blocks, so there a layer's vector (a norm, [n_blocks, d]) is factored over
(block, d) and the update's RMS clip is taken over all blocks of a leaf;
the port's per-layer leaves factor and clip per layer.  The two agree on
the same tree of leaves, which is what the tests compare.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    init: Callable            # (params) -> state
    update: Callable          # (grads, state, params) -> (params, state, gnorm)


def _global_norm(grads: Tensors) -> torch.Tensor:
    total = None
    for g in grads.values():
        s = g.float().square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tensors, max_norm: float):
    """(scale, norm), float32 scalars on the gradients' device: the scale is
    applied per leaf inside the update, so no float32 copy of the whole
    gradient exists at once."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return scale, norm


def _f32(x) -> float:
    return float(np.float32(x))


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01,
          max_grad_norm: float = 1.0) -> Optimizer:
    def init(params: Tensors) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": {n: zeros(p) for n, p in params.items()},
                "v": {n: zeros(p) for n, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(grads: Tensors, state: dict, params: Tensors):
        gscale, gnorm = clip_by_global_norm(grads, max_grad_norm)
        c = state["count"] + 1
        b1c = _f32(np.float32(1) - np.float32(b1) ** np.float32(c))
        b2c = _f32(np.float32(1) - np.float32(b2) ** np.float32(c))
        for n, p in params.items():
            g = grads[n].float() * gscale
            m, v = state["m"][n], state["v"][n]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square() * (1 - b2))
            step = (m / b1c) / (torch.sqrt(v / b2c) + eps)
            step = step + weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
        state["count"] = c
        return params, state, gnorm

    return Optimizer(init, update)


def adafactor(lr: float = 1e-2, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay_pow: float = 0.8, weight_decay: float = 0.0,
              max_grad_norm: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018), beta1 = 0."""

    def _factored(p) -> bool:
        return p.dim() >= 2

    def init(params: Tensors) -> dict:
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"leaves": {n: leaf(p) for n, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def update(grads: Tensors, state: dict, params: Tensors):
        gscale, gnorm = clip_by_global_norm(grads, max_grad_norm)
        c = state["count"] + 1
        beta2 = _f32(np.float32(1) - np.float32(c) ** np.float32(-decay_pow))
        for n, p in params.items():
            s = state["leaves"][n]
            g = grads[n].float() * gscale
            g2 = g.square() + eps
            if _factored(p):
                s["vr"].copy_(beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1))
                s["vc"].copy_(beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2))
                denom = torch.clamp(s["vr"].mean(dim=-1, keepdim=True),
                                    min=eps)
                v_hat = (s["vr"] / denom)[..., None] * s["vc"][..., None, :]
            else:
                v_hat = beta2 * s["v"] + (1 - beta2) * g2
                s["v"].copy_(v_hat)
            u = g * torch.rsqrt(v_hat + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
        state["count"] = c
        return params, state, gnorm

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name}")
