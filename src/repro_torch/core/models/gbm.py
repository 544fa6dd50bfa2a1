"""Gradient-boosted regression trees in PyTorch (paper §V-A), batched over
a leading fold axis.

Exact greedy splits over presorted features; weighted samples (w = 0
excludes a sample, which is how the leave-one-out folds refit).  Trees are
a level-order array layout: internal node ``i`` has children ``2i+1`` and
``2i+2``; a row goes right when ``x[feat] > thr``.  Boosting rounds are a
Python loop of small tensor ops.

The split search follows the reference op for op, so that both frameworks
pick the same split: features are visited in sort orders computed by the
same numpy call, left sums are ``cumsum`` along a non-innermost axis (a
sequential scan on both the CPU and the GPU, so positions separated only
by zero-weight rows tie exactly), and ties go to the first position and
the first feature, as ``argmax`` does in both frameworks.

Leaf values are computed from predict-consistent routing (samples routed
with the same (feature, threshold, <=) rule used at inference).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.models.api import ModelSpec, register_model

NEG = -1e30


class GBMParams(NamedTuple):
    f0: torch.Tensor          # [F] base prediction
    feat: torch.Tensor        # [F, T, n_internal] int32
    thr: torch.Tensor         # [F, T, n_internal] f32 (inf: unsplittable)
    leaf: torch.Tensor        # [F, T, n_leaves] f32 (learning rate folded in)
    y_scale: torch.Tensor     # [F] normalization (0: log target)


def _row_values(X, f):
    """X [n, d] or [F, n, d]; f [F, ...n] feature index per row -> x[f]."""
    if X.dim() == 2:
        X = X.expand(f.shape[0], *X.shape)
    return X.gather(-1, f[..., None])[..., 0]


def _route(feat, thr, X):
    """Route rows down trees.  feat/thr [F, T, n_int]; X [m, d] or
    [F, m, d] -> leaf-local index [F, T, m]."""
    F, T, n_int = feat.shape
    m = X.shape[-2]
    depth = int(np.log2(n_int + 1))
    Xb = X.expand(F, m, X.shape[-1]) if X.dim() == 2 else X
    Xb = Xb[:, None].expand(F, T, m, X.shape[-1])
    feat = feat.long()
    idx = torch.zeros((F, T, m), dtype=torch.long, device=X.device)
    for _ in range(depth):
        f = feat.gather(2, idx)
        t = thr.gather(2, idx)
        go_right = Xb.gather(3, f[..., None])[..., 0] > t
        idx = 2 * idx + 1 + go_right.long()
    return idx - n_int


def _presort(X, W, orders):
    """Per-feature sorted views that stay fixed over the boosting rounds:
    (orders, x sorted [d, n], next x [d, n], x steps up [d, n], W sorted
    [F, d, n])."""
    x_s = X.T.gather(1, orders)
    x_next = torch.cat([x_s[:, 1:], x_s[:, -1:]], 1)
    return orders, x_s, x_next, x_next > x_s, W[:, orders]


def _fit_tree(X, r, W, presorted, depth):
    """One regression tree per fold minimizing weighted MSE on residuals.

    X [n, d]; r, W [F, n] -> (feat, thr, leaf, leaf index of every
    row)."""
    n, d = X.shape
    F = W.shape[0]
    dev = X.device
    orders, x_s, x_next, step, w_s = presorted
    n_internal = 2 ** depth - 1
    feat = torch.zeros((F, n_internal), dtype=torch.int32, device=dev)
    thr = torch.full((F, n_internal), float("inf"), device=dev)
    node = torch.zeros((F, n), dtype=torch.long, device=dev)
    r_s = r[:, orders]                                       # [F, d, n]

    for level in range(depth):
        M = 2 ** level
        a_s = node[:, orders]                                # [F, d, n]
        oh = (a_s[..., None] == torch.arange(M, device=dev)).float()
        ws = w_s[..., None] * oh                             # [F, d, n, M]
        cw = torch.cumsum(ws, 2)
        cwr = torch.cumsum(ws * r_s[..., None], 2)
        tw, twr = cw[:, :, -1:], cwr[:, :, -1:]
        rw, rr = tw - cw, twr - cwr
        gain = (torch.square(cwr) / cw.clamp_min(1e-12)
                + torch.square(rr) / rw.clamp_min(1e-12)
                - torch.square(twr) / tw.clamp_min(1e-12))
        valid = (cw > 1e-9) & (rw > 1e-9) & step[None, :, :, None]
        gain = torch.where(valid, gain, NEG)
        gi = gain.argmax(2)                                  # [F, d, M]
        gv = gain.gather(2, gi[:, :, None])[:, :, 0]
        tv = 0.5 * (x_s.gather(1, gi.permute(1, 0, 2).reshape(d, -1))
                    + x_next.gather(1, gi.permute(1, 0, 2).reshape(d, -1)))
        tv = tv.reshape(d, F, M).permute(1, 0, 2)            # [F, d, M]
        # features in order, a later one only on a strictly larger gain:
        # the first maximum, which is what argmax over features returns
        bf = gv.argmax(1)                                    # [F, M]
        best_gain = gv.gather(1, bf[:, None])[:, 0].clamp_min(NEG)
        best_thr = tv.gather(1, bf[:, None])[:, 0]
        split = best_gain > NEG / 2
        best_feat = torch.where(split, bf, 0)
        t_lvl = torch.where(split, best_thr, float("inf"))
        base = 2 ** level - 1
        feat[:, base:base + M] = best_feat.int()
        # unsplittable nodes: thr=inf sends everything left
        thr[:, base:base + M] = t_lvl
        # descend
        f_cur = best_feat.gather(1, node)
        t_cur = t_lvl.gather(1, node)
        node = 2 * node + (_row_values(X, f_cur) > t_cur).long()

    # predict-consistent leaf values: after the last level ``node`` is the
    # leaf each row reaches under (feat, thr)
    n_leaves = 2 ** depth
    oh = (node[..., None] == torch.arange(n_leaves, device=dev)).float()
    sw = (W[..., None] * oh).sum(1)
    swr = (W[..., None] * oh * r[..., None]).sum(1)
    leaf = swr / sw.clamp_min(1e-12)
    return feat, thr, leaf, node


def gbm_fit(X, y, W, orders, *, n_trees=100, depth=3, lr=0.1,
            log_target=False) -> GBMParams:
    """X [n, d]; y [n] or [F, n]; W [F, n]; orders [d, n].

    log_target: fit log(y) (multiplicative runtime surfaces become
    additive, which piecewise-constant trees approximate far better)."""
    W = W.float()
    F = W.shape[0]
    wsum = W.sum(-1).clamp_min(1e-12)
    if log_target:
        yn = torch.log(y.clamp_min(1e-6))
        y_scale = torch.zeros(F, device=X.device)    # sentinel: log mode
    else:
        y_scale = ((W * torch.abs(y)).sum(-1) / wsum).clamp_min(1e-12)
        yn = y / y_scale[:, None]
    f0 = (W * yn).sum(-1) / wsum
    yn = yn.expand(F, X.shape[0])
    pred = f0[:, None].expand(F, X.shape[0])
    presorted = _presort(X, W, orders)
    feats, thrs, leaves = [], [], []
    for _ in range(n_trees):
        r = yn - pred
        feat, thr, leaf, leaf_idx = _fit_tree(X, r, W, presorted, depth)
        pred = pred + lr * leaf.gather(1, leaf_idx)
        feats.append(feat)
        thrs.append(thr)
        leaves.append(leaf)
    return GBMParams(f0, torch.stack(feats, 1), torch.stack(thrs, 1),
                     lr * torch.stack(leaves, 1), y_scale)


def gbm_predict(params: GBMParams, X) -> torch.Tensor:
    """X [m, d] or [F, m, d] -> [F, m]: f0 plus the leaves in tree order,
    then the target's normalization."""
    vals = params.leaf.gather(2, _route(params.feat, params.thr, X))
    out = params.f0[:, None].expand(vals.shape[0], vals.shape[2])
    for t in range(vals.shape[1]):
        out = out + vals[:, t]
    ys = params.y_scale[:, None]
    return torch.where(ys == 0.0, torch.exp(out.clamp(-30.0, 30.0)),
                       out * ys.clamp_min(1e-12))


def _make_aux(X: np.ndarray, device):
    return {"orders": torch.as_tensor(np.argsort(X, axis=0).T,
                                      device=device)}            # [d, n]


def _fit(X, y, W, aux):
    return gbm_fit(X, y, W, aux["orders"], n_trees=200, depth=3, lr=0.1,
                   log_target=True)


def _predict(params, X, aux):
    return gbm_predict(params, X)


# canonical spec object: the engine routes kernel inference on spec
# identity (a re-registered "gbm" with different params must not match)
GBM_SPEC = register_model(ModelSpec("gbm", _make_aux, _fit, _predict))
