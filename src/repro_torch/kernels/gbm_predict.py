"""Boosted-tree ensemble inference: the CUDA kernel's wrapper and its plain
PyTorch version.

``gbm_predict`` computes, for every row of X,

    epi(f0 + sum over trees t = 0..T-1 of leaf[t][leaf_of(t, x)])

where a row walks each tree in level order, ``idx = 2*idx + 1 + (x[feat[idx]]
> thr[idx])``, and ``epi`` is the engine's normalisation: ``exp(clip(r, -30,
30))`` when ``y_scale == 0`` (log target), else ``r * max(y_scale, 1e-12)``.
It is the port of ``repro/kernels/gbm_predict.py`` (the Pallas kernel) plus
the epilogue that ``repro/core/engine.py`` jits around it.

A CUDA tensor always launches the hand-written kernel
(``csrc/gbm_predict.cu``); a CPU tensor uses ``gbm_predict_plain``.  There is
no fallback from one to the other.  ``LAUNCHES`` counts kernel launches, so
that a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

MAX_FEATURES = 16          # the kernel keeps a row's features in registers
MAX_DEPTH = 10             # one tree's tables must fit a tile in shared memory
TILE_TREES = 128           # trees staged into shared memory at a time
_SMEM_BYTES = 48 * 1024    # static limit of a block's dynamic shared memory

LAUNCHES = 0


def _depth(n_int: int) -> int:
    depth = (n_int + 1).bit_length() - 1
    if n_int < 1 or (1 << depth) - 1 != n_int:
        raise ValueError(f"trees have {n_int} internal nodes; expected "
                         "2**depth - 1")
    return depth


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A one-element float32 tensor on ``like``'s device."""
    return torch.as_tensor(v, dtype=torch.float32,
                           device=like.device).reshape(1)


def _epilogue(raw: torch.Tensor, y_scale: torch.Tensor) -> torch.Tensor:
    return torch.where(y_scale == 0.0, torch.exp(raw.clamp(-30.0, 30.0)),
                       raw * y_scale.clamp_min(1e-12))


def gbm_predict_plain(X, feat, thr, leaf, f0, y_scale=1.0) -> torch.Tensor:
    """The same function in plain PyTorch: X [n, d]; feat, thr [T, n_int];
    leaf [T, n_int + 1]; f0, y_scale scalars -> [n] float32.  Leaves are
    added in tree order from f0, as in the kernel and the JAX oracle
    (``repro/kernels/ref.py:gbm_predict_ref``)."""
    X = X.float()
    n = X.shape[0]
    T, n_int = feat.shape
    depth = _depth(n_int)
    rows = torch.arange(n, device=X.device)
    featl = feat.long()
    idx = torch.zeros((T, n), dtype=torch.long, device=X.device)
    for _ in range(depth):
        f = featl.gather(1, idx)                             # [T, n]
        go_right = X[rows, f] > thr.float().gather(1, idx)
        idx = 2 * idx + 1 + go_right.long()
    vals = leaf.float().gather(1, idx - n_int)               # [T, n]
    out = _scalar(f0, X).expand(n)
    for t in range(T):
        out = out + vals[t]
    return _epilogue(out, _scalar(y_scale, X))


def _check(X, feat, thr, leaf):
    dev = X.device
    for name, t, dtype in (("X", X, torch.float32),
                           ("feat", feat, torch.int32),
                           ("thr", thr, torch.float32),
                           ("leaf", leaf, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, X on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    n, d = X.shape
    T, n_int = feat.shape
    if not 1 <= d <= MAX_FEATURES:
        raise ValueError(f"the kernel takes 1..{MAX_FEATURES} features, "
                         f"got {d}")
    if T < 1:
        raise ValueError("the ensemble has no trees")
    if tuple(thr.shape) != (T, n_int) or tuple(leaf.shape) != (T, n_int + 1):
        raise ValueError(f"tree tables disagree: feat {tuple(feat.shape)}, "
                         f"thr {tuple(thr.shape)}, leaf {tuple(leaf.shape)}")
    depth = _depth(n_int)
    if depth > MAX_DEPTH:
        raise ValueError(f"depth {depth} exceeds the kernel's {MAX_DEPTH}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed the kernel's int32 row index")
    return n, d, T, depth


def _lib():
    from repro_torch.kernels.build import load
    lib = load("gbm_predict")
    fn = lib.gbm_predict_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
    return fn


def gbm_predict(X, feat, thr, leaf, f0, y_scale=1.0) -> torch.Tensor:
    """Ensemble prediction [n] float32.  On a CUDA tensor this launches the
    kernel on the current stream (raising on anything it does not take);
    on a CPU tensor it is ``gbm_predict_plain``."""
    global LAUNCHES
    if X.device.type == "cpu":
        return gbm_predict_plain(X, feat, thr, leaf, f0, y_scale)
    if X.device.type != "cuda":
        raise ValueError(f"no gbm_predict for device {X.device}")
    n, d, T, depth = _check(X, feat, thr, leaf)
    f0_t, ys_t = _scalar(f0, X), _scalar(y_scale, X)
    n_int = (1 << depth) - 1
    per_tree = (3 * n_int + 1) * 4
    tile = min(T, TILE_TREES, _SMEM_BYTES // per_tree)
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(X.device).cuda_stream
    rc = _lib()(X.data_ptr(), feat.data_ptr(), thr.data_ptr(),
                leaf.data_ptr(), f0_t.data_ptr(), ys_t.data_ptr(),
                out.data_ptr(), n, d, T, depth, tile, X.device.index or 0,
                stream)
    if rc != 0:
        raise RuntimeError(f"gbm_predict kernel failed to launch: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return out
