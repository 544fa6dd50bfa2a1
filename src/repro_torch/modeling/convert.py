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

``train_state_from_jax(cfg, state)`` carries a JAX ``init_train_state``
tree (params, optimizer state, step) into the port's train state, so that
a step on both sides starts from the same numbers: AdamW's m and v leaf
for leaf; Adafactor's vr / vc sliced per layer like the weights, except
for a layer's vector leaf (a norm, [n_blocks, d] in the stacked JAX tree),
which the JAX package factors over (block, d) and the port's per-layer
leaf does not: its v is carried as the JAX package's second-moment
estimate for that block, vr[b] / max(mean(vr), eps) * vc.
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


def param_paths(cfg: ModelConfig, tree: dict) -> dict:
    """{port parameter name (``Model.named_parameters``): (path of keys in
    the JAX tree, block index or None)}: layer i = block b, slot j of the
    stacked ``blocks`` (index b), an unrolled block or a tail layer."""
    out = {"embed": (("embed",), None), "final_norm": (("final_norm",), None)}
    if "lm_head" in tree:
        out["lm_head"] = (("lm_head",), None)
    period, nb = cfg.pattern_period, cfg.n_scan_blocks
    for i in range(cfg.n_layers):
        if i >= nb * period:
            base, b = ("tail", f"l{i - nb * period}"), None
        elif "blocks" in tree:
            base, b = ("blocks", f"l{i % period}"), i // period
        else:
            base, b = ("blocks_unrolled", f"b{i // period}",
                       f"l{i % period}"), None
        layer = tree
        for k in base:
            layer = layer[k]
        for part, sub in layer.items():
            if part.startswith("ln"):
                out[f"layers.{i}.norms.{part}"] = (base + (part,), b)
                continue
            mod = "moe.p" if part == "moe" else part
            for k in sub:
                out[f"layers.{i}.{mod}.{k}"] = (base + (part, k), b)
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def train_state_from_jax(cfg: ModelConfig, state: dict, device="cuda"):
    """The port's train state ({"model", "opt", "step"}, as
    ``repro_torch.train.train_step.init_train_state`` makes it) holding a
    JAX train state's numbers, its leaves as numpy arrays."""
    dev = as_device(device)
    model = params_from_jax(cfg, state["params"], dev).trainable()
    paths = param_paths(cfg, state["params"])

    def f32(a, b):
        a = np.asarray(a)
        return _tensor(a if b is None else a[b], torch.float32, dev)

    opt = state["opt"]
    if "m" in opt:
        ostate = {"m": {n: f32(_at(opt["m"], p), b)
                        for n, (p, b) in paths.items()},
                  "v": {n: f32(_at(opt["v"], p), b)
                        for n, (p, b) in paths.items()}}
    else:
        leaves = {}
        for n, (p, b) in paths.items():
            s = _at(opt["leaves"], p)
            stacked_vector = (b is not None and "vr" in s
                              and np.ndim(_at(state["params"], p)) == 2)
            if stacked_vector:          # factored in JAX, not per layer
                vr, vc = np.asarray(s["vr"]), np.asarray(s["vc"])
                v = vr[b] / max(float(vr.mean()), 1e-30) * vc
                leaves[n] = {"v": f32(v, None)}
            else:
                leaves[n] = {k: f32(a, b) for k, a in s.items()}
        ostate = {"leaves": leaves}
    ostate["count"] = int(np.asarray(opt["count"]))
    return {"model": model, "opt": ostate, "step": int(np.asarray(state["step"]))}
