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
(``csrc/gbm_predict.cu``) with the launch ``plan`` makes; a CPU tensor uses
``gbm_predict_plain``.  There is no fallback from one to the other.
``LAUNCHES`` counts kernel launches, so that a run can show that its main
path went through the kernel.  The serving lanes call the wrapper from
executor threads, several at once: the library's setup and the counter
are taken under ``_LOCK``.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

MAX_FEATURES = 16          # the kernel keeps a row's features in registers
MAX_DEPTH = 10             # one tree must fit a tile in shared memory

# The kernel's constants (csrc/gbm_predict.cu): kMaxThreads threads a block
# at most, and __launch_bounds__(kMaxThreads, 2) caps a thread at
# 65,536 / (2 * kMaxThreads) = 64 registers.
MAX_THREADS = 512
REGS_PER_THREAD = 64
# Hopper (sm_90): 2,048 threads, 65,536 registers and 228 KB of shared
# memory an SM, of which the runtime reserves 1 KB per resident block.
SM_THREADS = 2048
SM_REGS = 65536
SM_SMEM = 228 * 1024
BLOCK_RESERVED_SMEM = 1024
# A block takes at most half an SM's shared memory, so that two fit.
SMEM_BUDGET = SM_SMEM // 2 - BLOCK_RESERVED_SMEM
# Rows an SM below which the trees of a tile are split into slices: at
# fewer than 512 rows (16 warps) an SM, rows alone leave it short of
# independent chains.
SLICE_BELOW_ROWS_PER_SM = 512
MAX_SLICES = 4

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


def _rows_for(n: int, sms: int, limit: int) -> int:
    """Rows a block (a multiple of 32, at most ``limit``) that put the
    fewest rows on the busiest SM while every SM gets a block (as far as n
    allows); among equals, the most rows, so that fewer blocks stage the
    trees."""
    want_blocks = min(sms, -(-n // 32))
    best = (None, 32)
    for rows in range(32, limit + 1, 32):
        blocks = -(-n // rows)
        if blocks < want_blocks:
            break
        busiest = -(-blocks // sms) * rows
        if best[0] is None or busiest <= best[0]:
            best = (busiest, rows)
    return best[1]


def chains(d: int) -> int:
    """Trees a thread walks at once (``kChains``): 8 for up to 4 features,
    else 4."""
    return 8 if d <= 4 else 4


def tree_bytes(depth: int) -> int:
    """A staged tree's shared memory (``tree_bytes``): 8-byte nodes of
    levels 0..depth-2 from byte 8, then 2**(depth-1) 16-byte nodes of the
    last level, each with its two leaves."""
    return (8 << (depth - 1) if depth > 1 else 16) + (16 << (depth - 1))


def plan(n: int, d: int, T: int, depth: int, sms: int) -> dict:
    """The kernel's launch for n rows of d features and T trees of
    ``depth`` on a card of ``sms`` SMs: rows a block, slices (threads that
    split a row's trees), chains (trees a thread walks at once), tile trees
    (staged into shared memory at a time), tiles, dynamic shared-memory
    bytes, threads, resident blocks an SM and blocks (the grid; blocks loop
    over chunks of rows)."""
    slices = 1
    if n < SLICE_BELOW_ROWS_PER_SM * sms:
        slices = MAX_SLICES if n < SLICE_BELOW_ROWS_PER_SM * sms // 2 else 2
        slices = max(1, min(slices, T // chains(d)))
    rows = _rows_for(n, sms, MAX_THREADS // slices) if slices > 1 \
        else MAX_THREADS
    rows = min(rows, 32 * -(-n // 32))
    per_tree = tree_bytes(depth)

    def smem_of(tile):   # the tile's heaps, and the leaves of slices 1..
        return tile * per_tree + (tile - tile // slices) * rows * 4

    tile = min(T, SMEM_BUDGET // per_tree)
    while smem_of(tile) > SMEM_BUDGET:
        tile -= 1
    smem = smem_of(tile)
    threads = rows * slices
    per_sm = min(SM_THREADS // threads,
                 SM_REGS // (REGS_PER_THREAD * threads),
                 SM_SMEM // (smem + BLOCK_RESERVED_SMEM))
    chunks = -(-n // rows)
    return {"rows": rows, "slices": slices, "chains": chains(d),
            "tile_trees": tile, "tiles": -(-T // tile), "smem_bytes": smem,
            "threads": threads, "blocks_per_sm": per_sm,
            "blocks": min(chunks, sms * per_sm)}


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_LOCK = threading.Lock()
_FN = None                 # the launch entry point, its types set


def _lib():
    """The library's launch function, typed once: a thread never sees it
    before its ``argtypes`` are set."""
    global _FN
    if _FN is not None:             # set only once typed: no lock needed
        return _FN
    with _LOCK:
        if _FN is None:
            from repro_torch.kernels.build import load
            f = load("gbm_predict").gbm_predict_launch
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 \
                + [ctypes.c_void_p]
            _FN = f
        return _FN


def _count_launch() -> None:
    """One more launch on ``LAUNCHES``, atomic across threads."""
    global LAUNCHES
    with _LOCK:
        LAUNCHES += 1


def gbm_predict(X, feat, thr, leaf, f0, y_scale=1.0) -> torch.Tensor:
    """Ensemble prediction [n] float32.  On a CUDA tensor this launches the
    kernel on the current stream (raising on anything it does not take);
    on a CPU tensor it is ``gbm_predict_plain``."""
    if X.device.type == "cpu":
        return gbm_predict_plain(X, feat, thr, leaf, f0, y_scale)
    if X.device.type != "cuda":
        raise ValueError(f"no gbm_predict for device {X.device}")
    n, d, T, depth = _check(X, feat, thr, leaf)
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    _launch(X, feat, thr, leaf, _scalar(f0, X), _scalar(y_scale, X), out,
            plan(n, d, T, depth, _sms(_index(X.device))))
    return out


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _launch(X, feat, thr, leaf, f0, y_scale, out, p: dict) -> None:
    """One launch of the kernel under plan ``p`` on the current stream,
    on tensors ``gbm_predict`` has checked; raises if it is refused."""
    n, d = X.shape
    T, n_int = feat.shape
    depth = (n_int + 1).bit_length() - 1
    index = _index(X.device)
    rc = _lib()(X.data_ptr(), feat.data_ptr(), thr.data_ptr(),
                leaf.data_ptr(), f0.data_ptr(), y_scale.data_ptr(),
                out.data_ptr(), n, d, T, depth, p["rows"], p["slices"],
                p["tile_trees"], p["smem_bytes"], p["blocks"], index,
                torch.cuda.current_stream(X.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gbm_predict kernel failed to launch: CUDA "
                           f"error {rc}")
    _count_launch()
