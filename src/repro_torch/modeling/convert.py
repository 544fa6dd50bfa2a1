"""Carry a JAX parameter tree into the port's model.

``params_from_jax(cfg, tree)`` takes the tree of ``repro.modeling.model.
init_params`` (or a checkpoint of it) with its leaves as numpy arrays.
Leaves under ``blocks`` are stacked on a leading [n_scan_blocks] axis;
layer i = b * period + j is block b, slot j, and tail slot j is layer
n_scan_blocks * period + j.  The layouts are the same on both sides, so
carrying a weight is a copy, and a layer's sub-trees (attn, mamba, rwkv's
tm and cm, ffn or moe, the norms) are carried as they are.  bfloat16
arrays (numpy's ml_dtypes type) go through float32, which holds them
exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.models.api import as_device
from repro_torch.modeling.model import Model, check_supported


def _tensor(a, dtype, device) -> torch.Tensor:
    a = np.array(a)           # a writable copy: jax arrays are read-only
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_tree(cfg: ModelConfig, tree: dict, i: int) -> dict:
    """Layer i's sub-tree of the JAX parameters, unstacked."""
    period, nb = cfg.pattern_period, cfg.n_scan_blocks
    if i >= nb * period:
        return tree["tail"][f"l{i - nb * period}"]
    b, j = divmod(i, period)
    if "blocks" in tree:
        return _map(lambda a: np.asarray(a)[b], tree["blocks"][f"l{j}"])
    return tree["blocks_unrolled"][f"b{b}"][f"l{j}"]


def params_from_jax(cfg: ModelConfig, tree: dict, device="cuda") -> Model:
    """The port's ``Model`` holding the JAX tree's weights, in
    ``cfg.param_dtype`` on ``device``."""
    check_supported(cfg)
    dev = as_device(device)
    dt = getattr(torch, cfg.param_dtype)
    conv = lambda a: _tensor(a, dt, dev)          # noqa: E731
    params = {"embed": conv(tree["embed"]),
              "final_norm": conv(tree["final_norm"]),
              "layers": [_map(conv, layer_tree(cfg, tree, i))
                         for i in range(cfg.n_layers)]}
    if "lm_head" in tree:
        params["lm_head"] = conv(tree["lm_head"])
    return Model(cfg, params)
