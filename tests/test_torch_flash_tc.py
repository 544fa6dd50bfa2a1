"""The bf16 route of the port's flash-attention kernel, replayed on the CPU.

``csrc/flash_attention.cu`` runs bfloat16 inputs through a tensor-core
kernel (``tc::flash_fwd_wgmma_kernel``) that cannot run here.  ``replay``
repeats its arithmetic in torch: q tiles of kBQ rows split into two
64-row warpgroups, kv tiles of BK keys (both read from the kernel's
source, ``tc::Cfg``), the kv tiles the masks empty for the whole q tile
skipped, and those empty for a warpgroup's 64 rows skipped by that
warpgroup; bf16 operands with float32 sums, the scale (times log2 e) after
Q.K^T, exp2, P rounded to bf16 before P.V, and out = acc / max(l, 1e-30)
in bf16.  It is held against the plain version and the Pallas kernel in
interpret mode at the bf16 tolerance of ``tests/test_kernels.py`` and at
the relative bound FLASH_BF16_REL, and controls show that bound rejects P
rounded to fp8 or a scale off by 10%.

This checks the algorithm and its tiling, not the kernel: a fault of the
.cu cannot show here.  The kernel itself is held against the plain
version on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Inputs are made from a seed with numpy and handed to both frameworks.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as FA

# tests/test_kernels.py's bf16 tolerance: atol 3e-2, rtol ten times that
ATOL, RTOL = 3e-2, 3e-1
# ||got - want|| / ||want||, chip_smoke.py's FLASH_BF16_REL
FLASH_BF16_REL = 5e-3
WG_ROWS = 64                   # query rows of a consumer warpgroup (wgmma M)
LOG2E = 1.4426950408889634
NEG_INF = FA.NEG_INF
def rel_err(got, want):
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm())


def replay(q, k, v, *, causal=True, window=0, softcap=0.0,
           p_type=torch.bfloat16):
    """The bf16 kernel's arithmetic on bf16 [B, S, H, hd] tensors.  Returns
    the output and the number of (row, kv tile) steps in which a row saw
    only masked keys before it saw any kept one (p = 1 there, wiped later
    by corr = 0)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    cfg = FA.tile_config(hd)
    BQ, BK = cfg["kBQ"], cfg["BK"]
    scale_log2 = hd ** -0.5 * LOG2E
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    pad = math.ceil(S / BK) * BK + BQ - S      # TMA reads rows >= S as 0
    kf = torch.nn.functional.pad(kf, (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
    out = torch.empty(B, S, H, hd, dtype=torch.bfloat16)
    healed = 0
    for q0 in range(0, S, BQ):
        kv_hi = min(S, q0 + BQ) if causal else S
        kv_lo = max(0, q0 - window + 1) if window else 0
        t_lo, t_hi = kv_lo // BK, -(-kv_hi // BK)
        for row_lo in (q0, q0 + WG_ROWS):
            rows = torch.arange(row_lo, row_lo + WG_ROWS)
            qw = torch.nn.functional.pad(qf, (0, 0, 0, 0, 0, BQ))[:, rows]
            m = torch.full((B, WG_ROWS, H), NEG_INF)
            lsum = torch.zeros(B, WG_ROWS, H)
            acc = torch.zeros(B, WG_ROWS, H, hd)
            seen = torch.zeros(WG_ROWS, dtype=torch.bool)
            for t in range(t_lo, t_hi):
                k0 = t * BK
                if (causal and k0 > row_lo + WG_ROWS - 1) or \
                        (window and k0 + BK - 1 <= row_lo - window):
                    continue                  # empty for every row here
                keys = torch.arange(k0, k0 + BK)
                s = torch.einsum("bqhd,bkhd->bqhk", qw, kf[:, keys])
                if softcap:
                    x = softcap * torch.tanh(s * hd ** -0.5 / softcap) * LOG2E
                else:
                    x = s * scale_log2
                ok = (keys[None, :] < S).expand(WG_ROWS, BK)
                if causal:
                    ok = ok & (keys[None, :] <= rows[:, None])
                if window:
                    ok = ok & (keys[None, :] > rows[:, None] - window)
                live = rows < S
                healed += int((live & ~seen & ~ok.any(1)).sum()) * B * H
                seen |= ok.any(1)
                x = torch.where(ok[None, :, None, :], x,
                                torch.tensor(NEG_INF))
                m_new = torch.maximum(m, x.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new[..., None])
                lsum = lsum * corr + p.sum(-1)
                pv = torch.einsum("bqhk,bkhd->bqhd",
                                  p.to(p_type).float(),
                                  vf[:, keys])
                acc = acc * corr[..., None] + pv
                m = m_new
            o = acc / torch.clamp(lsum, min=1e-30)[..., None]
            n = min(WG_ROWS, S - row_lo)
            if n > 0:
                out[:, row_lo:row_lo + n] = o[:, :n].to(torch.bfloat16)
    return out, healed


CASES = [
    # (B, S, H, KV, hd, causal, window, cap, healed): ragged S below, at
    # and above one tile; a window of 16 across a kv-tile boundary, whose
    # rows 285 .. 319 see only masked keys in their first tile; the
    # softcap; GQA; hd 256 with its 64-key tiles; non-causal
    (1, 1, 2, 1, 64, True, 0, 0.0, False),
    (1, 129, 4, 2, 64, True, 0, 0.0, False),
    (2, 200, 4, 1, 128, True, 0, 0.0, False),
    (1, 384, 2, 1, 64, True, 16, 0.0, True),
    (1, 300, 4, 2, 128, True, 100, 30.0, True),
    (1, 160, 4, 1, 256, True, 0, 50.0, False),
    (1, 255, 2, 1, 256, True, 40, 0.0, True),
    (1, 192, 8, 1, 128, False, 0, 0.0, False),
]


def _inputs(case):
    B, S, H, KV, hd = case[:5]
    rng = np.random.default_rng(S * 31 + hd + H)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.parametrize("case", CASES)
def test_replay_matches_plain_and_pallas(case):
    B, S, H, KV, hd, causal, window, cap, healed = case
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(case))
    got, n_healed = replay(q, k, v, causal=causal, window=window,
                           softcap=cap)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, hd)
    assert (n_healed > 0) == healed, n_healed
    plain = FA.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=cap)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=ATOL, rtol=RTOL)
    assert rel_err(got, plain) <= FLASH_BF16_REL
    qj, kj, vj = (jnp.asarray(a).astype(jnp.bfloat16) for a in _inputs(case))
    pallas = pallas_flash(qj, kj, vj, causal=causal, window=window,
                          softcap=cap, q_block=128, kv_block=128,
                          interpret=True)
    pallas = torch.as_tensor(np.asarray(pallas, np.float32))
    np.testing.assert_allclose(got.float().numpy(), pallas.numpy(),
                               atol=ATOL, rtol=RTOL)
    assert rel_err(got, pallas) <= FLASH_BF16_REL


@pytest.mark.parametrize("case", [c for c in CASES if c[1] > 1])
def test_relative_bound_rejects_coarser_arithmetic(case):
    """P rounded to fp8 e4m3 before P.V, or a scale off by 10%, gives a
    relative error beyond FLASH_BF16_REL."""
    B, S, H, KV, hd, causal, window, cap, _ = case
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(case))
    kw = dict(causal=causal, window=window, softcap=cap)
    plain = FA.flash_attention_plain(q, k, v, **kw)
    fp8, _ = replay(q, k, v, p_type=torch.float8_e4m3fn, **kw)
    off = FA.flash_attention_plain(q, k, v, scale=1.1 * hd ** -0.5, **kw)
    for bad in (fp8, off):
        assert rel_err(bad, plain) > FLASH_BF16_REL


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_tile_config_read_from_the_kernel(hd):
    """The replay's reading of ``tc::Cfg``: two 64-row warpgroups per q
    tile, kv tiles that divide a q tile, and a block's shared memory within
    the 227 KB an H100 block may take."""
    cfg = FA.tile_config(hd)
    assert cfg["HD"] == hd and cfg["kBQ"] == 2 * WG_ROWS
    assert cfg["kBQ"] % cfg["BK"] == 0 and cfg["NS"] >= 2
    assert cfg["SMEM"] >= cfg["Q_BYTES"] + 2 * cfg["NS"] * cfg["KV_BYTES"]
    assert cfg["SMEM"] <= 227 * 1024

