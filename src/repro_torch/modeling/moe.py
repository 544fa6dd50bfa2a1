"""Mixture-of-Experts FFN: a top-k router and capacity-bounded experts.

Port of the single-device semantics of ``repro/modeling/moe.py``.  The
reference's two implementations compute one function on one device:
``moe_apply_ep`` falls back to ``moe_apply_dense`` without a mesh, and its
stable sort by expert gives the same queue positions as the dense path's
cumsum.  So ``cfg.moe_impl`` selects nothing here.

  route     float32 logits, softmax, top-k, gates renormalised by
            max(sum, 1e-9), and the Switch load-balance aux
            E * sum_e f_e p_e
  capacity  C = ceil(T K / E * capacity_factor); an assignment's position
            in its expert's queue counts the earlier assignments in
            flattened (token, k) order, and positions >= C are dropped
  experts   one batched product over the [E, C, D] buffer (``torch.bmm``)
            in the activation type
  combine   each token sums its kept experts' outputs times its gates, cast
            to the activation type as the reference casts them

The reference's dense path builds one-hot dispatch and combine tensors of
[T, E, C]; at jamba-1.5-large's prefill (T = 16,384, E 16, C 2,560) that
is 1.34 GB in bf16 and 11 TFLOP per einsum.  The port dispatches and
combines by index instead: a stable sort gives the queue positions, one
indexed copy fills the buffer and a gather of each token's K rows brings
the outputs back.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def moe_shapes(cfg: ModelConfig) -> dict:
    """The layer's leaf shapes (``moe_defs``), all drawn normal."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    shapes = {"router": (d, e), "w_up": (e, d, f), "w_down": (e, f, d)}
    if cfg.act == "swiglu":
        shapes["w_gate"] = (e, d, f)
    return shapes


def route(cfg: ModelConfig, router_w, x) -> Tuple[torch.Tensor, ...]:
    """x [T, D] -> (expert ids [T, K], gates [T, K] float32, aux scalar)."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.n_experts_active, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = cfg.n_experts
    f_e = torch.bincount(ids.reshape(-1), minlength=e).float()
    f_e = f_e / torch.clamp(f_e.sum(), min=1.0)
    aux = e * torch.sum(f_e * probs.mean(dim=0))
    return ids, gates, aux


def capacity(cfg: ModelConfig, tokens: int) -> int:
    return max(int(math.ceil(tokens * cfg.n_experts_active / cfg.n_experts
                             * cfg.capacity_factor)), 1)


def queue_positions(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """ids [T, K] -> each assignment's position in its expert's queue, in
    flattened (t, k) order (the reference's cumsum of one-hots)."""
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) - \
        starts[flat[order]]
    return pos.reshape(ids.shape)


def expert_ffn(p: dict, xs: torch.Tensor, act: str) -> torch.Tensor:
    """xs [E, C, D] per-expert batches -> [E, C, D]."""
    dt = xs.dtype
    h = torch.bmm(xs, p["w_up"].to(dt))
    if act == "swiglu":
        h = F.silu(torch.bmm(xs, p["w_gate"].to(dt))) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["w_down"].to(dt))


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x [B, S, D] -> (out [B, S, D], aux float32 scalar)."""
    B, S, D = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.n_experts_active
    xt = x.reshape(T, D)
    ids, gates, aux = route(cfg, p["router"], xt)
    C = capacity(cfg, T)
    pos = queue_positions(ids, E)
    keep = pos < C
    # slot of each (t, k) in the [E * C] buffer; row E * C is a sink for
    # the dropped assignments (written, never read) and a zero row to
    # gather for them
    slot = torch.where(keep, ids * C + pos, E * C)
    buf = torch.zeros(E * C + 1, D, dtype=x.dtype, device=x.device)
    tok = torch.arange(T, device=x.device).repeat_interleave(K)
    buf[slot.reshape(-1)] = xt[tok]
    ys = expert_ffn(p, buf[:-1].view(E, C, D), cfg.act).reshape(E * C, D)
    ys = torch.cat([ys, ys.new_zeros(1, D)])
    g = gates.to(x.dtype)
    out = torch.zeros(T, D, dtype=torch.float32, device=x.device)
    for k in range(K):
        out += ys[slot[:, k]].float() * g[:, k, None].float()
    return out.to(x.dtype).reshape(B, S, D), aux


class MoE(nn.Module):
    """The MoE FFN of one layer as a module (``p``: router, w_up, w_down
    and, with swiglu, w_gate), so that a forward pre-hook can see its
    input.  ``forward`` returns (out, aux)."""

    def __init__(self, cfg: ModelConfig, p: dict):
        super().__init__()
        self.cfg = cfg
        self.p = nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                   for k, v in p.items()})

    def forward(self, x: torch.Tensor):
        return moe_apply(self.cfg, self.p, x)
