"""The port's attention kernels on the CPU: the plain versions of
``flash_attention`` and ``decode_attention`` against the JAX package's
Pallas kernels (interpret mode, as ``tests/test_kernels.py`` runs them),
their oracles in ``repro/kernels/ref.py`` and the model's attention paths
(``repro/modeling/attention.py``), including the ring-buffer slot map.  The
arithmetic of the CUDA decode kernel (its plan of parts and warp runs,
tiles of slots with one online-softmax update each, P rounded to bf16 on
the bf16 route, and the merges of warps and parts inside the launch) is
replayed in torch against the plain version and the Pallas kernel.  The CUDA kernels themselves are held against
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


# the decode kernel's tile (kT of csrc/decode_attention.cu), the warps a
# block may have (Cfg::W), and a card's multiprocessors and resident blocks
# for the replayed plan (an H100's 132, one block an SM)
TILE_SLOTS = 32
BLOCK_WARPS = (1, 2, 4)
SMS, BLOCKS_PER_SM = 132, 1


def _split_and_combine(q, kc, vc, pos, window, cap, k_pos,
                       dtype=torch.float32, W=4, plan=None):
    """The CUDA decode kernel's arithmetic in torch, on q [B, H, hd] and
    caches [B, L, KV, hd] of ``dtype``: the wrapper's slot range and plan
    (``decode_plan``, or ``plan``, (slots per warp, parts)), W warps a
    part, each warp's run in tiles of TILE_SLOTS slots with one
    online-softmax update a tile (slots past the run weigh 0, masked ones
    score NEG_INF), then the block's warps merged, then the parts.  bf16:
    the scale after the float32 sum of bf16 products, P rounded to bf16
    before P.V.  float32: q * scale first.  Returns the output in
    ``dtype`` and the number of warp runs."""
    q, kc, vc = (torch.as_tensor(a).to(dtype) for a in (q, kc, vc))
    B, H, hd = q.shape
    L, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    scale = hd ** -0.5
    bf16 = dtype == torch.bfloat16
    T = TILE_SLOTS
    lo, hi = DA.slot_range(L, pos, window, k_pos)
    per_warp, n_parts = plan or DA.decode_plan(hi - lo, B, KV, W,
                                               BLOCKS_PER_SM, SMS)
    assert per_warp % 16 == 0 and n_parts * W * per_warp >= hi - lo
    kp = torch.arange(L) if k_pos is None else k_pos.long()
    ok = (kp <= pos) & ((kp > pos - window) if window else True)
    qg = q.float().reshape(B, KV, G, hd)
    if not bf16:
        qg = qg * scale
    kf, vf = kc.float().transpose(1, 2), vc.float().transpose(1, 2)

    def merge(ms, ls, accs):
        M = torch.stack(ms).amax(0)
        w = [torch.exp(m - M) for m in ms]
        return (M, sum(wi * li for wi, li in zip(w, ls)),
                sum(wi[..., None] * a for wi, a in zip(w, accs)))

    parts = []
    for i in range(n_parts):
        runs = []
        for w_ in range(W):
            j0 = lo + (i * W + w_) * per_warp
            j1 = min(hi, j0 + per_warp)
            m = torch.full((B, KV, G), DA.NEG_INF)
            lsum = torch.zeros(B, KV, G)
            acc = torch.zeros(B, KV, G, hd)
            for t0 in range(j0, j1, T):
                js = torch.arange(t0, min(t0 + T, j1))
                s = torch.einsum("bkgh,bksh->bkgs", qg, kf[:, :, js])
                if bf16:
                    s = s * scale
                if cap:
                    s = cap * torch.tanh(s / cap)
                s = torch.where(ok[js], s, torch.tensor(DA.NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                lsum = lsum * corr + p.sum(-1)
                if bf16:
                    p = p.to(torch.bfloat16).float()
                acc = acc * corr[..., None] + torch.einsum(
                    "bkgs,bksh->bkgh", p, vf[:, :, js])
                m = m_new
            runs.append((m, lsum, acc))
        parts.append(merge(*zip(*runs)))
    _, den, num = merge(*zip(*parts)) if n_parts > 1 else parts[0]
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, hd).to(dtype), n_parts * W


@pytest.mark.parametrize("L,pos,window,ring,cap", [
    (300, 150, 0, False, 0.0), (300, 299, 64, False, 30.0),
    (300, 1000, 16, False, 0.0),      # no slot can be kept: uniform average
    (64, 40, 64, True, 0.0), (64, 200, 64, True, 0.0)])
def test_split_and_combine_replay_matches_plain(L, pos, window, ring, cap):
    """The float32 route at the wrapper's plan (the ring's first turn gives
    a warp whose slots are all masked), and at a plan of two parts whose
    warps walk several tiles, against the plain version; without a slot
    map and with a slot kept, also against the Pallas kernel (which
    averages a fully masked row over its blocks of 64 slots, not over the
    cache)."""
    B, KV, G, hd = 2, 1, 4, 64
    q, kc, vc = _arrays(L + pos, (B, KV * G, hd), (B, L, KV, hd),
                        (B, L, KV, hd))
    k_pos = ring_positions(L, pos, "cpu") if ring else None
    want = DA.decode_attention_plain(_t(q), _t(kc), _t(vc), pos,
                                     window=window, softcap=cap, k_pos=k_pos)
    lo, hi = DA.slot_range(L, pos, window, k_pos)
    for W in BLOCK_WARPS:
        per_warp = 16 * -(-(hi - lo) // (16 * 2 * W))
        for plan in (None, (per_warp, 2)):
            got, runs = _split_and_combine(q, kc, vc, pos, window, cap,
                                           k_pos, W=W, plan=plan)
            assert runs > 1
            _close(got, want)
    if not ring and pos < L:
        _close(got, pallas_decode(_j(q), _j(kc), _j(vc), jnp.int32(pos),
                                  window=window, softcap=cap, block=64,
                                  interpret=True))


# the relative bound of bf16 decode (chip_smoke.py's DECODE_BF16_REL)
DECODE_BF16_REL = 5e-3


@pytest.mark.parametrize("B,L,KV,G,hd,pos,window,cap,ring", [
    (2, 300, 1, 4, 256, 150, 0, 0.0, False),
    (1, 700, 2, 8, 128, 650, 0, 0.0, False),     # jamba's G 8 and hd 128
    (2, 257, 1, 2, 64, 256, 64, 50.0, False),
    (2, 64, 1, 4, 256, 40, 64, 0.0, True),       # first turn, empty slots
    (1, 300, 1, 1, 64, 1000, 16, 0.0, False)])   # every slot masked
def test_bf16_decode_replay_matches_plain_and_pallas(B, L, KV, G, hd, pos,
                                                     window, cap, ring):
    """The bf16 route (tensor-core scores, P rounded to bf16) at the
    wrapper's plan and at a plan of two parts with several tiles a warp:
    within the bf16 tolerance and DECODE_BF16_REL of the plain version,
    and, without a slot map and with a slot kept, of the Pallas kernel (on
    the bf16 values in float32); P rounded to
    fp8 instead is beyond DECODE_BF16_REL where more than one slot is
    kept."""
    dt = torch.bfloat16
    q, kc, vc = (_t(a, "bfloat16") for a in _arrays(
        L * 3 + pos, (B, KV * G, hd), (B, L, KV, hd), (B, L, KV, hd)))
    k_pos = ring_positions(L, pos, "cpu") if ring else None
    want = DA.decode_attention_plain(q, kc, vc, pos, window=window,
                                     softcap=cap, k_pos=k_pos)
    lo, hi = DA.slot_range(L, pos, window, k_pos)
    for W in BLOCK_WARPS:
        per_warp = 16 * -(-(hi - lo) // (16 * 2 * W))
        for plan in (None, (per_warp, 2)):
            got, _ = _split_and_combine(q, kc, vc, pos, window, cap, k_pos,
                                        dt, W, plan)
            _close(got.float(), want.float(), "bfloat16")
            rel = float((got.double() - want.double()).norm() /
                        want.double().norm())
            assert rel <= DECODE_BF16_REL, rel
    if not ring and pos < L:
        _close(got.float(), pallas_decode(
            *(jnp.asarray(t.float().numpy()) for t in (q, kc, vc)),
            jnp.int32(pos), window=window, softcap=cap, block=64,
            interpret=True), "bfloat16")
    kept = int(DA._mask(k_pos, L, pos, window, "cpu").sum())
    if kept > 1:
        s = torch.einsum("bkgh,blkh->bkgl",
                         q.float().reshape(B, KV, G, hd) * hd ** -0.5,
                         kc.float())
        if cap:
            s = cap * torch.tanh(s / cap)
        s = torch.where(DA._mask(k_pos, L, pos, window, "cpu"), s,
                        torch.tensor(DA.NEG_INF))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bkgl,blkh->bkgh",
                         p.to(torch.float8_e4m3fn).float(), vc.float())
        o = (o / p.sum(-1, keepdim=True)).reshape(B, KV * G, hd).to(dt)
        rel = float((o.double() - want.double()).norm() /
                    want.double().norm())
        assert rel > DECODE_BF16_REL, rel


def test_slot_range_and_split_plan():
    assert DA.slot_range(100, 50, 0, None) == (0, 51)
    assert DA.slot_range(100, 50, 16, None) == (35, 51)
    assert DA.slot_range(100, 500, 0, None) == (0, 100)
    assert DA.slot_range(100, 500, 16, None) == (0, 100)
    assert DA.slot_range(64, 10, 64, torch.zeros(64)) == (0, 64)
    # jamba's decode step: 8 x 8 (batch, kv head) pairs, 2,081 slots,
    # blocks of 4 warps, one resident an SM of 132
    assert DA.decode_plan(2081, 8, 8, 4, 1, 132) == (272, 2)
    for args in [(2081, 8, 1, 2, 1, 132), (512, 8, 1, 2, 1, 132),
                 (1, 2, 1, 4, 2, 132), (100_000, 1, 1, 4, 2, 132),
                 (2081, 8, 8, 4, 1, 132), (31, 3, 4, 4, 2, 132),
                 (2081, 8, 8, 1, 8, 114), (5000, 1, 1, 2, 1, 8)]:
        n_slots, B, KV, W, per_sm, sms = args
        per, n = DA.decode_plan(*args)
        assert per % 16 == 0 and per >= 16
        assert n * W * per >= n_slots > (n - 1) * W * per
        assert 1 <= n <= DA.MAX_PARTS
        assert n * B * KV <= max(sms * per_sm, B * KV)   # one wave or fewer


def test_wrappers_use_the_plain_versions_on_cpu_tensors():
    q, k, v = (_t(a) for a in _arrays(3, (1, 8, 2, 32), (1, 8, 1, 32),
                                      (1, 8, 1, 32)))
    before = (FA.LAUNCHES, DA.LAUNCHES)
    torch.testing.assert_close(FA.flash_attention(q, k, v, window=4),
                               FA.flash_attention_plain(q, k, v, window=4),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        DA.decode_attention(q[:, 0], k, v, 5),
        DA.decode_attention_plain(q[:, 0], k, v, 5), rtol=0, atol=0)
    assert (FA.LAUNCHES, DA.LAUNCHES) == before
