"""The port's GBM-ensemble CUDA kernel replayed on the CPU.

``csrc/gbm_predict.cu`` cannot run here.  ``replay`` repeats its order of
work in float32 torch, under the launch that ``gbm_predict.plan`` makes: a
tile of trees staged as the kernel packs it in shared memory (``staged``:
per tree, the levels above the last as 8-byte (feature id, threshold)
nodes from byte 8, the last level as 16-byte (feature id, threshold, left
leaf, right leaf) nodes), walked with the kernel's byte-offset arithmetic
(a child at 2 o - base + 8 right, the last level at 4 o - 3 base - 8
2**(depth-1) + 16 right, the leaf picked by the last compare); blocks that
loop over chunks of ``rows`` rows; tiles of ``tile_trees`` trees in order;
in a tile, ``slices`` contiguous runs of trees, walked ``chains`` at a
time; slice 0 adding its leaves to the row's sum from f0, the other
slices' leaves added after it in tree order; rows past n never written.
It is held bit for bit against ``gbm_predict_plain``, and against the
Pallas kernel in interpret mode and ``ref.gbm_predict_ref`` at
``tests/test_torch_kernels.py``'s tolerance, rtol = atol = 1e-5 (those two
sum in the same order, but the Pallas kernel gathers by one-hot products).
As a control, the same replay with each slice's leaves summed on their own
and the partial sums merged afterwards must differ in bits somewhere: bit
parity is a property of the order, not of the inputs.

This checks the algorithm and its order of work, not the kernel: a fault
of the .cu cannot show here.  The kernel itself is held against its plain
version on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Inputs are made from a seed with numpy and handed to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gbm_predict import gbm_predict as pallas_gbm
from repro.kernels.ref import gbm_predict_ref
from repro_torch.kernels import gbm_predict as K

RTOL = ATOL = 1e-5
H100_SMS = 132


def _ensemble(seed, n, d, T, depth, nonfinite=False):
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    X = rng.uniform(0, 10, (n, d)).astype(np.float32)
    feat = rng.integers(0, d, (T, n_int)).astype(np.int32)
    thr = rng.uniform(0, 10, (T, n_int)).astype(np.float32)
    leaf = rng.normal(0, 0.1, (T, n_int + 1)).astype(np.float32)
    if nonfinite:
        thr[rng.random((T, n_int)) < 0.2] = np.inf
        m = rng.random(X.shape)
        X[m < 0.05] = np.inf
        X[(m >= 0.05) & (m < 0.1)] = -np.inf
        X[(m >= 0.1) & (m < 0.15)] = np.nan
    return X, feat, thr, leaf, np.float32(rng.normal(0.3, 0.1))


def staged(feat, thr, leaf):
    """Trees as the kernel stages them: [T, tree_bytes / 4] 32-bit words
    (feature ids as they are, floats by their bits)."""
    T, n_int = feat.shape
    depth = (n_int + 1).bit_length() - 1
    n_upper = 2 ** (depth - 1) - 1
    last = 8 << (depth - 1) if depth > 1 else 16
    w = torch.zeros(T, K.tree_bytes(depth) // 4, dtype=torch.int32)
    thr_bits, leaf_bits = thr.view(torch.int32), leaf.view(torch.int32)
    for k in range(n_int):
        off = 8 * (k + 1) if k < n_upper else last + 16 * (k - n_upper)
        w[:, off // 4] = feat[:, k]
        w[:, off // 4 + 1] = thr_bits[:, k]
    for k in range(n_int + 1):
        w[:, (last + 16 * (k >> 1) + 8 + 4 * (k & 1)) // 4] = leaf_bits[:, k]
    return w


def _walk(x, words, first, k, depth):
    """Leaf values [k, rows] of the k trees whose heaps start ``first``
    bytes into the staged tile ``words`` (flat), for rows x [rows, d]: the
    k chains a thread walks together."""
    stride = K.tree_bytes(depth)
    base = (first + stride * torch.arange(k))[:, None].expand(k, len(x))

    def node(o, word=0):
        return words[o // 4 + word]

    def right(o):                       # x[feature] > threshold
        v = x.gather(1, node(o).long().T).T
        return (v > node(o, 1).view(torch.float32)).long()

    o = base + (8 if depth > 1 else 16)
    if depth > 1:
        for _ in range(depth - 2):
            o = 2 * o - base + 8 * right(o)
        o = 4 * o - 3 * base - (8 << (depth - 1)) + 16 * right(o)
    return torch.where(right(o).bool(), node(o, 3).view(torch.float32),
                       node(o, 2).view(torch.float32))


def replay(X, feat, thr, leaf, f0, y_scale, p, merge_after=False):
    """The kernel's order of work under plan ``p``.  ``merge_after``: each
    slice sums its own leaves and the partial sums are added afterwards
    (the control)."""
    n = X.shape[0]
    T, n_int = feat.shape
    depth = (n_int + 1).bit_length() - 1
    stride = K.tree_bytes(depth)
    rows, S, tile, chains = p["rows"], p["slices"], p["tile_trees"], \
        p["chains"]
    out = torch.full((n,), float("nan"))
    written = torch.zeros(n, dtype=torch.bool)
    for b in range(p["blocks"]):
        for c in range(b, -(-n // rows), p["blocks"]):
            r = torch.arange(c * rows, min(c * rows + rows, n))  # ragged edge
            x = X[r]
            acc = torch.full((len(r),), float(f0))
            parts = [torch.zeros(len(r)) for _ in range(S)]
            for t0 in range(0, T, tile):
                nt = min(tile, T - t0)
                words = staged(feat[t0:t0 + nt], thr[t0:t0 + nt],
                               leaf[t0:t0 + nt]).reshape(-1)
                split = nt // S
                vals = torch.empty(nt - split, len(r))
                for s in range(S):
                    lo, hi = s * nt // S, (s + 1) * nt // S
                    t = lo
                    while t < hi:
                        k = chains if t + chains <= hi else 1
                        v = _walk(x, words, t * stride, k, depth)
                        for j in range(k):
                            if merge_after:
                                parts[s] = parts[s] + v[j]
                            elif s == 0:
                                acc = acc + v[j]
                            else:
                                vals[t + j - split] = v[j]
                        t += k
                if not merge_after:
                    for t in range(split, nt):
                        acc = acc + vals[t - split]
            if merge_after:
                for s in range(S):
                    acc = acc + parts[s]
            out[r] = K._epilogue(acc, K._scalar(y_scale, acc))
            written[r] = True
    assert bool(written.all())
    return out


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _bits(t):
    return t.numpy().view(np.int32)


# n, d, T, depth, SMs the plan is made for, y_scale, non-finite inputs.
# 132 SMs put these n in slices (4, or 2 when T // chains is 2); 1 SM
# plans one row a thread (n >= 512) or 2 slices (256 <= n < 512).
CASES = [
    (1, 3, 50, 3, H100_SMS, 250.0, False),
    (1000, 4, 50, 3, H100_SMS, 0.0, True),       # ragged: 31 chunks + 8
    (999, 16, 47, 4, H100_SMS, 1.0, True),       # 47 trees in 4 slices
    (700, 1, 10, 1, H100_SMS, 250.0, True),      # 2 slices
    (300, 2, 50, 2, 1, 250.0, True),             # 2 slices, 1 SM
    (1000, 3, 50, 10, 1, 250.0, False),          # 8 tiles, 2 blocks, 4 chunks
    (1000, 5, 33, 10, H100_SMS, 0.0, True),      # tiles of 7 in 4 slices
    (513, 8, 50, 1, 1, 1.0, True),               # one row a thread
    (257, 2, 1, 3, H100_SMS, 250.0, False),      # T = 1: no slices
]


@pytest.mark.parametrize("n,d,T,depth,sms,y_scale,nonfinite", CASES)
def test_replay_matches_plain_bit_for_bit(n, d, T, depth, sms, y_scale,
                                         nonfinite):
    X, feat, thr, leaf, f0 = _torch(*_ensemble(n + 31 * T + depth, n, d, T,
                                               depth, nonfinite))
    p = K.plan(n, d, T, depth, sms)
    got = replay(X, feat, thr, leaf, float(f0), y_scale, p)
    want = K.gbm_predict_plain(X, feat, thr, leaf, float(f0), y_scale)
    assert np.array_equal(_bits(got), _bits(want)), p


@pytest.mark.parametrize("n,d,T,depth,sms", [
    (1000, 3, 50, 3, H100_SMS), (300, 16, 30, 4, 1), (513, 2, 40, 1, 1),
    (200, 4, 20, 10, H100_SMS)])
def test_replay_matches_pallas_interpret(n, d, T, depth, sms):
    """Finite thresholds: the Pallas kernel clamps thr = inf (R2)."""
    X, feat, thr, leaf, f0 = _ensemble(n * 3 + d, n, d, T, depth)
    want = pallas_gbm(jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr),
                      jnp.asarray(leaf), f0, 1.0, interpret=True)
    got = replay(*_torch(X, feat, thr, leaf), float(f0), 1.0,
                 K.plan(n, d, T, depth, sms))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,d,T,depth,sms", [
    (1000, 4, 50, 3, H100_SMS), (600, 3, 45, 2, 1), (97, 16, 20, 10, 1)])
def test_replay_matches_oracle_on_nonfinite_inputs(n, d, T, depth, sms):
    """R2: thr = inf nodes stay unclamped, and NaN or +inf features go left
    at them, as in ``ref.gbm_predict_ref``."""
    X, feat, thr, leaf, f0 = _ensemble(n + d, n, d, T, depth,
                                       nonfinite=True)
    want = gbm_predict_ref(jnp.asarray(X), jnp.asarray(feat),
                           jnp.asarray(thr), jnp.asarray(leaf), f0)
    got = replay(*_torch(X, feat, thr, leaf), float(f0), 1.0,
                 K.plan(n, d, T, depth, sms))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_merging_slice_partials_breaks_bit_parity():
    """The control: the same walk with per-slice partial sums merged
    afterwards is not the plain version's sum."""
    differ = 0
    for seed in range(4):
        X, feat, thr, leaf, f0 = _torch(*_ensemble(seed, 1000, 3, 50, 3))
        p = K.plan(1000, 3, 50, 3, H100_SMS)
        assert p["slices"] == 4
        want = K.gbm_predict_plain(X, feat, thr, leaf, float(f0), 1.0)
        got = replay(X, feat, thr, leaf, float(f0), 1.0, p,
                     merge_after=True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
        differ += int(np.sum(_bits(got) != _bits(want)))
    assert differ > 0


@pytest.mark.parametrize("n,d,T,depth", [
    (24576, 3, 200, 3), (24576, 3, 203, 3), (2 ** 20, 3, 200, 3),
    (24576, 3, 2000, 3), (2 ** 20, 16, 2000, 3), (24576, 5, 200, 10),
    (2 ** 20, 3, 200, 10), (1, 1, 1, 1), (1000, 4, 200, 3),
    (50000, 8, 200, 4), (5000, 16, 1, 10)])
def test_plan_fits_the_card(n, d, T, depth):
    """Every plan stays within a block's 227 KB of shared memory and 512
    threads, and its blocks are resident at once."""
    p = K.plan(n, d, T, depth, H100_SMS)
    assert p["smem_bytes"] <= 227 * 1024
    assert p["rows"] % 32 == 0 and p["threads"] <= K.MAX_THREADS
    assert 1 <= p["tile_trees"] <= T and p["tiles"] * p["tile_trees"] >= T
    assert 1 <= p["slices"] <= max(1, p["tile_trees"])
    assert 1 <= p["blocks"] <= H100_SMS * p["blocks_per_sm"]
    assert p["blocks_per_sm"] * (p["smem_bytes"] + K.BLOCK_RESERVED_SMEM) \
        <= K.SM_SMEM


def test_plan_gives_every_sm_a_block_at_the_serving_shape():
    """4096 contexts x 6 scale-outs: 24,576 rows of 200 trees of depth 3
    reach all 132 SMs, each within one wave."""
    p = K.plan(24576, 3, 200, 3, H100_SMS)
    assert p["blocks"] >= H100_SMS
    assert p["blocks"] <= H100_SMS * p["blocks_per_sm"]
    assert p["tiles"] == 1 and p["slices"] > 1
