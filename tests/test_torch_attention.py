"""The port's attention kernels on the CPU: the plain versions of
``flash_attention`` and ``decode_attention`` against the JAX package's
Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs them),
their oracles in ``repro/kernels/ref.py`` and the model's attention paths
(``repro/modeling/attention.py``), including the ring-buffer slot map.  The
split-and-combine arithmetic of the CUDA decode kernel is replayed in numpy
against the plain version.  The CUDA kernels themselves are held against
the plain versions on the card by ``tests/test_torch_gpu.py``.

Inputs are made from a seed with numpy and handed to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.modeling import attention as JA
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.modeling.attention import EMPTY_SLOT, ring_positions

# tests/test_kernels.py's tolerances: atol 2e-5 in float32 (sums in another
# order), 3e-2 in bfloat16 (one rounding of the output); rtol ten times that
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)


def _t(a, dtype="float32"):
    return torch.as_tensor(a).to(TORCH_DT[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(dtype)


FLASH_CASES = [
    # (B, S, H, KV, hd, causal, window, cap, dtype): tests/test_kernels.py's
    # ATTN_CASES, then a ragged S, S = 1 and a windowed non-causal case
    (2, 256, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 384, 4, 1, 128, True, 64, 0.0, "float32"),
    (2, 128, 8, 8, 64, True, 0, 50.0, "float32"),
    (1, 256, 4, 4, 64, False, 0, 0.0, "float32"),
    (1, 256, 4, 2, 64, True, 128, 30.0, "bfloat16"),
    (1, 200, 4, 1, 64, True, 64, 0.0, "float32"),
    (2, 1, 4, 1, 32, True, 0, 0.0, "float32"),
    (1, 96, 2, 1, 32, False, 16, 0.0, "float32"),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_and_oracle(case):
    B, S, H, KV, hd, causal, window, cap, dt = case
    q, k, v = _arrays(S * 7 + hd, (B, S, H, hd), (B, S, KV, hd),
                      (B, S, KV, hd))
    got = FA.flash_attention_plain(_t(q, dt), _t(k, dt), _t(v, dt),
                                   causal=causal, window=window, softcap=cap)
    assert got.dtype == TORCH_DT[dt] and got.shape == (B, S, H, hd)
    pallas = pallas_flash(_j(q, dt), _j(k, dt), _j(v, dt), causal=causal,
                          window=window, softcap=cap, q_block=128,
                          kv_block=128, interpret=True)
    _close(got.float(), pallas, dt)
    oracle = R.attention_ref(_j(q, dt).astype(jnp.float32),
                             _j(k, dt).astype(jnp.float32),
                             _j(v, dt).astype(jnp.float32), causal=causal,
                             window=window, softcap=cap)
    _close(got.float(), oracle, dt)


@pytest.mark.parametrize("impl", ["reference", "blocked", "triangle",
                                  "banded"])
def test_flash_plain_is_every_model_attention_variant(impl):
    """The model's four prefill paths (``attention_impl``) compute the one
    function that the port routes to the kernel.  The banded path is held
    at one query head per kv head: with more it mis-orders its output axes
    (fault R4, ROADMAP.md §3), and the port follows the oracle."""
    B, S, H, hd = 2, 64, 4, 32
    KV = H if impl == "banded" else 2
    window = 24 if impl in ("banded", "reference") else 0
    q, k, v = _arrays(5, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    pos = jnp.arange(S)
    kw = dict(q_pos=pos, k_pos=pos, cap=20.0)
    if impl == "reference":
        want = JA.attention_reference(*map(_j, (q, k, v)), causal=True,
                                      window=window, **kw)
    elif impl == "blocked":
        want = JA.attention_blocked(*map(_j, (q, k, v)), causal=True,
                                    chunk=16, **kw)
    elif impl == "triangle":
        want = JA.attention_triangle(*map(_j, (q, k, v)), chunk=16, **kw)
    else:
        want = JA.attention_banded(*map(_j, (q, k, v)), window=window,
                                   chunk=16, **kw)
    got = FA.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                   window=window, softcap=20.0)
    _close(got, want)


DECODE_CASES = [
    # (B, L, KV, G, hd, pos, window, cap)
    (2, 256, 1, 4, 64, 135, 0, 0.0),
    (1, 384, 2, 2, 64, 199, 64, 0.0),
    (2, 128, 4, 1, 32, 0, 0, 0.0),
    (1, 256, 1, 4, 64, 255, 0, 50.0),
    (2, 212, 2, 4, 32, 100, 32, 30.0),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_pallas_and_oracle(case):
    B, L, KV, G, hd, pos, window, cap = case
    H = KV * G
    q, kc, vc = _arrays(L + pos, (B, H, hd), (B, L, KV, hd), (B, L, KV, hd))
    got = DA.decode_attention_plain(_t(q), _t(kc), _t(vc), pos,
                                    window=window, softcap=cap)
    pallas = pallas_decode(_j(q), _j(kc), _j(vc), jnp.int32(pos),
                           window=window, softcap=cap, block=64,
                           interpret=True)
    _close(got, pallas)
    oracle = R.decode_attention_ref(_j(q), _j(kc), _j(vc), pos=pos,
                                    window=window, softcap=cap)
    _close(got, oracle)


def _jax_ring_offsets(buf, pos):
    """The slot map of ``repro/modeling/attention.py:381-385``."""
    idx = jnp.arange(buf)
    slot, turn = pos % buf, pos // buf
    offs = jnp.where(idx <= slot, turn * buf + idx, (turn - 1) * buf + idx)
    return jnp.where(offs < 0, 2 ** 30, offs)


@pytest.mark.parametrize("buf,pos", [(16, 0), (16, 5), (16, 15), (16, 16),
                                     (16, 37), (64, 2100)])
def test_ring_positions_match_the_model(buf, pos):
    got = ring_positions(buf, pos, "cpu")
    assert got.dtype == torch.int32 and EMPTY_SLOT == 2 ** 30
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(_jax_ring_offsets(buf, pos)))


@pytest.mark.parametrize("buf,pos,G,cap", [(16, 5, 4, 0.0), (16, 37, 1, 0.0),
                                           (32, 32, 2, 50.0),
                                           (32, 100, 4, 0.0)])
def test_decode_plain_with_slot_map_matches_model_decode(buf, pos, G, cap):
    """A ring cache read through ``k_pos`` against the model's
    ``decode_attention`` with ``buf_offset``, window = ring length."""
    B, KV, hd = 2, 1, 32
    H = KV * G
    q, kc, vc = _arrays(buf + pos, (B, H, hd), (B, buf, KV, hd),
                        (B, buf, KV, hd))
    k_pos = ring_positions(buf, pos, "cpu")
    got = DA.decode_attention_plain(_t(q), _t(kc), _t(vc), pos, window=buf,
                                    softcap=cap, k_pos=k_pos)
    want = JA.decode_attention(_j(q)[:, None], _j(kc), _j(vc),
                               pos=jnp.asarray(pos), window=buf,
                               buf_offset=jnp.asarray(k_pos.numpy()),
                               cap=cap)
    _close(got, np.asarray(want)[:, 0])


def _split_and_combine(q, kc, vc, pos, window, cap, k_pos):
    """The CUDA decode kernels' arithmetic in numpy: the wrapper's slot
    range and parts, one warp's sequential online softmax per part, then
    the combine pass."""
    B, H, hd = q.shape
    L, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    lo, hi = DA.slot_range(L, pos, window, k_pos)
    per, n_parts = DA.split_plan(hi - lo, B, KV)
    out = np.zeros_like(q)
    kp = np.arange(L) if k_pos is None else k_pos.numpy()
    for b in range(B):
        for h in range(H):
            parts = []
            for i in range(n_parts):
                m, den, acc = np.float32(DA.NEG_INF), np.float32(0), 0.0
                for j in range(lo + i * per, min(hi, lo + (i + 1) * per)):
                    s = np.float32(q[b, h] * hd ** -0.5) @ kc[b, j, h // G]
                    if cap:
                        s = cap * np.tanh(s / cap)
                    ok = kp[j] <= pos and (not window or kp[j] > pos - window)
                    s = np.float32(s if ok else DA.NEG_INF)
                    m_new = max(m, s)
                    corr, p = np.exp(m - m_new), np.exp(s - m_new)
                    den, m = den * corr + p, m_new
                    acc = acc * corr + p * vc[b, j, h // G]
                parts.append((m, den, acc))
            M = max(p[0] for p in parts)
            w = [np.exp(p[0] - M) for p in parts]
            num = sum(wi * p[2] for wi, p in zip(w, parts))
            out[b, h] = num / max(sum(wi * p[1] for wi, p in zip(w, parts)),
                                  1e-30)
    return out, n_parts


@pytest.mark.parametrize("L,pos,window,ring,cap", [
    (300, 150, 0, False, 0.0), (300, 299, 64, False, 30.0),
    (300, 1000, 16, False, 0.0),      # no slot can be kept: uniform average
    (64, 40, 64, True, 0.0), (64, 200, 64, True, 0.0)])
def test_split_and_combine_replay_matches_plain(L, pos, window, ring, cap):
    B, KV, G, hd = 2, 1, 4, 32
    q, kc, vc = _arrays(L + pos, (B, KV * G, hd), (B, L, KV, hd),
                        (B, L, KV, hd))
    k_pos = ring_positions(L, pos, "cpu") if ring else None
    got, n_parts = _split_and_combine(q, kc, vc, pos, window, cap, k_pos)
    assert n_parts > 1
    want = DA.decode_attention_plain(_t(q), _t(kc), _t(vc), pos,
                                     window=window, softcap=cap, k_pos=k_pos)
    _close(got, want)


def test_slot_range_and_split_plan():
    assert DA.slot_range(100, 50, 0, None) == (0, 51)
    assert DA.slot_range(100, 50, 16, None) == (35, 51)
    assert DA.slot_range(100, 500, 0, None) == (0, 100)
    assert DA.slot_range(100, 500, 16, None) == (0, 100)
    assert DA.slot_range(64, 10, 64, torch.zeros(64)) == (0, 64)
    per, n = DA.split_plan(2049, 8, 1)
    assert per == DA.MIN_PER_PART and n == -(-2049 // per)
    per, n = DA.split_plan(100_000, 8, 1)
    assert per * n >= 100_000 and n * 8 <= DA.TARGET_WARPS + 8


def test_wrappers_use_the_plain_versions_on_cpu_tensors():
    q, k, v = (_t(a) for a in _arrays(3, (1, 8, 2, 32), (1, 8, 1, 32),
                                      (1, 8, 1, 32)))
    before = (FA.LAUNCHES, DA.LAUNCHES, DA.COMBINE_LAUNCHES)
    torch.testing.assert_close(FA.flash_attention(q, k, v, window=4),
                               FA.flash_attention_plain(q, k, v, window=4),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        DA.decode_attention(q[:, 0], k, v, 5),
        DA.decode_attention_plain(q[:, 0], k, v, 5), rtol=0, atol=0)
    assert (FA.LAUNCHES, DA.LAUNCHES, DA.COMBINE_LAUNCHES) == before
