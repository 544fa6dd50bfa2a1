"""Tests of the port that need a CUDA card: the hand-written GBM-ensemble
kernel against its plain PyTorch version, the engine's routing to it, and a
predictor fitted on the card against the same fit on the CPU; the
flash-attention and flash-decode kernels against their plain versions, and
a small LM served through them; the WKV6 kernel against both of its plain
versions, and a small RWKV6 model served through it; the selective-scan
kernel against its plain version, and a small jamba (mamba, attention and
MoE layers) served through it and the attention kernels.  They skip
without a card.  This file imports no JAX, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import engine
from repro_torch.core.models.api import ModelSpec
from repro_torch.core.models.gbm import GBM_SPEC
from repro_torch.core.predictor import C3OPredictor
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import gbm_predict as K
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import wkv6 as WK
from repro_torch.modeling.attention import ring_positions
from repro_torch.modeling.model import Model
from repro_torch.serve.serve_step import greedy_generate
from repro_torch.workloads import spark_emul as W

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _ensemble(seed, n, d, T, depth, device):
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    X = rng.uniform(0, 10, (n, d)).astype(np.float32)
    m = rng.random(X.shape)
    X[m < 0.05] = np.inf
    X[(m >= 0.05) & (m < 0.1)] = -np.inf
    X[(m >= 0.1) & (m < 0.15)] = np.nan
    feat = rng.integers(0, d, (T, n_int)).astype(np.int32)
    thr = rng.uniform(0, 10, (T, n_int)).astype(np.float32)
    thr[rng.random((T, n_int)) < 0.2] = np.inf
    leaf = rng.normal(0, 0.1, (T, n_int + 1)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (X, feat, thr, leaf)]


@pytest.mark.parametrize("n,d,T,depth", [
    (1, 1, 1, 1), (1, 3, 200, 3), (7, 2, 20, 2), (257, 4, 200, 3),
    (300, 16, 30, 4), (513, 1, 10, 1), (24576, 4, 200, 3)])
@pytest.mark.parametrize("y_scale", [0.0, 250.0])
def test_kernel_matches_plain(cuda_device, n, d, T, depth, y_scale):
    t = _ensemble(n + d, n, d, T, depth, cuda_device)
    before = K.LAUNCHES
    got = K.gbm_predict(*t, 0.3, y_scale)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.gbm_predict_plain(*t, 0.3, y_scale)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    X, feat, thr, leaf = _ensemble(0, 8, 3, 4, 2, cuda_device)
    with pytest.raises(ValueError):
        K.gbm_predict(torch.zeros(8, K.MAX_FEATURES + 1, device=cuda_device),
                      feat, thr, leaf, 0.0, 1.0)
    with pytest.raises(TypeError):
        K.gbm_predict(X, feat.long(), thr, leaf, 0.0, 1.0)
    with pytest.raises(ValueError):
        K.gbm_predict(X, feat, thr.cpu(), leaf, 0.0, 1.0)


def test_gbm_routes_through_kernel_on_spec_identity(cuda_device):
    v = W.generate_job_data("grep").machine_view("c5.xlarge")
    aux = GBM_SPEC.make_aux(v.X, cuda_device)
    params = engine.fit(GBM_SPEC, v.X, v.y, np.ones(len(v.y)), aux,
                        cuda_device)
    before = K.LAUNCHES
    got = engine.predict(GBM_SPEC, params, v.X, aux, cuda_device)
    assert K.LAUNCHES == before + 1
    clone = ModelSpec("gbm", GBM_SPEC.make_aux, GBM_SPEC.fit,
                      GBM_SPEC.predict)
    same = engine.predict(clone, params, v.X, aux, cuda_device)
    assert K.LAUNCHES == before + 1          # a look-alike is not routed
    np.testing.assert_allclose(got.cpu().numpy(), same.cpu().numpy(),
                               rtol=1e-6)


def test_cpu_fit_carried_to_card_predicts_the_same(cuda_device):
    v = W.generate_job_data("grep").machine_view("r5.xlarge")
    cpu = C3OPredictor(device="cpu").fit(v.X, v.y)
    card = C3OPredictor.from_state(cpu.export_state(), v.X, device="cuda")
    np.testing.assert_allclose(card.predict(v.X), cpu.predict(v.X),
                               rtol=1e-5)


# ------------------------------------------------------------ LM attention

# tests/test_kernels.py's tolerances: float32 2e-5, bfloat16 3e-2 (atol;
# rtol ten times that)
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# bf16 flash is also held to ||got - want|| / ||want||: TOL's atol is as
# large as a typical output at S 2048.  chip_smoke.py's FLASH_BF16_REL,
# set in PERF.md from the card's readings and from controls (P rounded to
# fp8, the scale off by 10%) that exceed it.
FLASH_BF16_REL = 5e-3


def _qkv(seed, B, S, H, KV, hd, dtype, device, L=None):
    rng = np.random.default_rng(seed)
    L = S if L is None else L
    t = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, S, H, hd), (B, L, KV, hd), (B, L, KV, hd))]
    return [torch.as_tensor(a, device=device).to(dtype) for a in t]


FLASH_CASES = [
    # (B, S, H, KV, hd, causal, window, cap)
    (2, 256, 4, 2, 64, True, 0, 0.0),
    (1, 384, 4, 1, 128, True, 64, 0.0),
    (2, 128, 8, 4, 256, True, 0, 50.0),
    (1, 256, 4, 4, 64, False, 0, 0.0),
    (1, 1000, 4, 1, 256, True, 512, 0.0),
    (2, 1, 4, 1, 256, True, 0, 0.0),
    (1, 77, 2, 2, 128, False, 16, 30.0),
    (2, 2048, 64, 8, 128, True, 0, 0.0),       # jamba's attention layer
    # the edges of the bf16 kernel's tiles (128 query rows, 128 keys at hd
    # 64 and 128, 64 at hd 256): ragged S above one tile and below two, a
    # single row
    (2, 129, 4, 1, 128, True, 0, 0.0),
    (1, 255, 4, 2, 64, True, 0, 0.0),
    (1, 1, 2, 1, 64, True, 0, 0.0),
    # a window of 16 across the kv tile at 256; rows 271 .. 319 see only
    # masked keys in their first visited tile (keys 128 .. 255) and heal
    (2, 384, 4, 1, 64, True, 16, 0.0),
    # hd 256 (64-key tiles): the same healing from row 168 on
    (1, 255, 2, 1, 256, True, 40, 0.0),
    (2, 1024, 4, 1, 256, True, 512, 50.0),
    (1, 512, 16, 2, 128, False, 0, 0.0),       # G 8, non-causal
    (8, 2048, 4, 1, 256, True, 0, 0.0),        # gemma3's global layer
    (8, 2048, 4, 1, 256, True, 512, 0.0),      # gemma3's local layer
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, case, dtype):
    B, S, H, KV, hd, causal, window, cap = case
    q, k, v = _qkv(S + hd, B, S, H, KV, hd, dtype, cuda_device)
    before = FA.LAUNCHES
    got = FA.flash_attention(q, k, v, causal=causal, window=window,
                             softcap=cap)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=cap)
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)
    if dtype == torch.bfloat16:
        g, w = got.double(), want.double()
        assert float((g - w).norm() / w.norm()) <= FLASH_BF16_REL


DECODE_CASES = [
    # (B, L, H, KV, hd, pos, window, cap, ring)
    (2, 300, 4, 1, 256, 150, 0, 0.0, False),
    (2, 300, 4, 4, 128, 0, 0, 0.0, False),
    (1, 257, 8, 1, 64, 256, 64, 50.0, False),
    (3, 64, 4, 2, 256, 70, 64, 0.0, True),     # full ring
    (2, 64, 4, 1, 256, 40, 64, 0.0, True),     # first turn: empty slots
    (2, 2120, 4, 1, 256, 2100, 0, 0.0, False),
    (8, 2120, 64, 8, 128, 2100, 0, 0.0, False),  # jamba's decode step
]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda_device, case, dtype):
    B, L, H, KV, hd, pos, window, cap, ring = case
    q, kc, vc = _qkv(L + pos, B, 1, H, KV, hd, dtype, cuda_device, L=L)
    q = q[:, 0].contiguous()
    k_pos = ring_positions(L, pos, cuda_device) if ring else None
    before = (DA.LAUNCHES, DA.COMBINE_LAUNCHES)
    got = DA.decode_attention(q, kc, vc, pos, window=window, softcap=cap,
                              k_pos=k_pos)
    torch.cuda.synchronize()
    assert (DA.LAUNCHES, DA.COMBINE_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    want = DA.decode_attention_plain(q, kc, vc, pos, window=window,
                                     softcap=cap, k_pos=k_pos)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)


def test_attention_kernels_raise_on_what_they_do_not_take(cuda_device):
    q, k, v = _qkv(0, 1, 64, 4, 1, 256, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        FA.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous())
    with pytest.raises(ValueError):
        FA.flash_attention(q.transpose(1, 2), k, v)
    k3 = torch.zeros(1, 64, 3, 256, device=cuda_device)
    with pytest.raises(ValueError):                  # 4 heads over 3
        FA.flash_attention(q, k3, k3)
    with pytest.raises(ValueError):
        DA.decode_attention(q[:, 0].contiguous(), k, v, torch.tensor(3))
    with pytest.raises(ValueError):
        DA.decode_attention(q[:, 0].contiguous(), k, v, 3,
                            k_pos=torch.arange(64, device=cuda_device))


def test_small_model_serves_through_the_kernels(cuda_device):
    """One prefill and a few decode steps of a reduced gemma3 (head_dim 64,
    window 16, prompt past the window) on the card, against the same
    seeded weights on the CPU: the kernels' launch counts grow, the
    last-position logits agree and the greedy tokens are the same."""
    cfg = smoke_config("gemma3-1b", head_dim=64)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40)))
    cpu = Model.from_seed(cfg, 0, "cpu")
    card = Model.from_seed(cfg, 0, cuda_device)
    before = (FA.LAUNCHES, DA.LAUNCHES)
    got = greedy_generate(card, prompt.to(cuda_device), 6, 48)
    torch.cuda.synchronize()
    assert FA.LAUNCHES - before[0] == cfg.n_layers
    assert DA.LAUNCHES - before[1] == 5 * cfg.n_layers
    want = greedy_generate(cpu, prompt, 6, 48)
    assert torch.equal(got.cpu(), want)
    with torch.inference_mode():
        lc, _ = card(prompt.to(cuda_device), mode="train")
        lp, _ = cpu(prompt, mode="train")
    np.testing.assert_allclose(lc.cpu().numpy(), lp.numpy(), atol=1e-4,
                               rtol=1e-4)


# ------------------------------------------------------------------- WKV6

# tests/test_kernels.py's wkv6 tolerance: atol 2e-4, rtol 1e-3
WKV_ATOL, WKV_RTOL = 2e-4, 1e-3


def _wkv_inputs(seed, B, S, H, hd, device, s0=False, log_w_min=None,
                zero_u=False):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, hd)) for _ in range(3))
    if log_w_min is None:
        x = np.clip(rng.standard_normal((B, S, H, hd)), -8.0, 2.0)
        w = np.exp(-np.exp(x))
    else:
        w = np.exp(rng.uniform(log_w_min, -0.01, (B, S, H, hd)))
    u = np.zeros((H, hd)) if zero_u else 0.3 * rng.standard_normal((H, hd))
    st = 0.5 * rng.standard_normal((B, H, hd, hd)) if s0 else None
    return [None if a is None else
            torch.as_tensor(a.astype(np.float32), device=device)
            for a in (r, k, v, w, u, st)]


def _wkv_close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=WKV_ATOL, rtol=WKV_RTOL)


WKV_CASES = [
    # (B, S, H, hd, s0 given, log w down to, u = 0)
    (2, 64, 4, 64, False, None, False),
    (2, 64, 4, 64, True, None, False),     # given s0
    (1, 32, 2, 64, True, None, False),     # two chunks
    (1, 48, 1, 64, False, None, False),    # B 1, H 1
    (2, 64, 4, 32, True, None, False),     # hd 32, the smoke width
    (2, 32, 2, 16, False, None, False),    # hd 16
    (2, 64, 4, 64, True, -12.0, False),    # decays past the clamp
    (1, 64, 2, 64, False, None, True),     # u = 0
]


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_kernel_matches_both_plain_versions(cuda_device, case):
    """Against the chunked plain version as it is, and against the exact
    recurrence on the clamped decays (log w >= -9), which is what the
    chunked form computes."""
    B, S, H, hd, has_s0, log_w_min, zero_u = case
    r, k, v, w, u, s0 = _wkv_inputs(S + hd + B, B, S, H, hd, cuda_device,
                                    has_s0, log_w_min, zero_u)
    before = WK.LAUNCHES
    y, s = WK.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert WK.LAUNCHES == before + 1
    assert y.shape == r.shape and s.shape == (B, H, hd, hd)
    y_p, s_p = WK.wkv6_plain(r, k, v, w, u, s0)
    _wkv_close(y, y_p)
    _wkv_close(s, s_p)
    w_c = torch.clamp(w, min=float(np.exp(WK.LOG_W_MIN)))
    y_q, s_q = WK.wkv6_sequential_plain(r, k, v, w_c, u, s0)
    _wkv_close(y, y_q)
    _wkv_close(s, s_q)


def test_wkv6_kernel_carries_state_across_calls(cuda_device):
    r, k, v, w, u, _ = _wkv_inputs(11, 2, 64, 4, 64, cuda_device)
    y, s = WK.wkv6(r, k, v, w, u)
    y1, s1 = WK.wkv6(*(t[:, :32].contiguous() for t in (r, k, v, w)), u)
    y2, s2 = WK.wkv6(*(t[:, 32:].contiguous() for t in (r, k, v, w)), u, s1)
    _wkv_close(torch.cat([y1, y2], 1), y)
    _wkv_close(s2, s)


def test_wkv6_raises_on_what_it_does_not_take(cuda_device):
    r, k, v, w, u, s0 = _wkv_inputs(0, 1, 32, 2, 64, cuda_device, s0=True)
    with pytest.raises(ValueError):                   # S % 16 != 0
        WK.wkv6(*(t[:, :20].contiguous() for t in (r, k, v, w)), u)
    with pytest.raises(TypeError):
        WK.wkv6(r.bfloat16(), k, v, w, u)
    with pytest.raises(TypeError):
        WK.wkv6(r, k, v, w, u, s0.double())
    with pytest.raises(ValueError):                   # a CPU tensor
        WK.wkv6(r, k.cpu(), v, w, u)
    with pytest.raises(ValueError):
        WK.wkv6(r, k, v, w, u.cpu())
    with pytest.raises(ValueError):                   # shapes disagree
        WK.wkv6(r, k[:, :, :1].contiguous(), v, w, u)
    with pytest.raises(ValueError):
        WK.wkv6(r, k, v, w, u[:1].contiguous())
    with pytest.raises(ValueError):
        WK.wkv6(r, k, v, w, u, s0[:, :1].contiguous())
    with pytest.raises(ValueError):                   # strided
        WK.wkv6(r.transpose(1, 2), k, v, w, u)
    r3 = torch.zeros(1, 32, 2, 48, device=cuda_device)
    with pytest.raises(ValueError):                   # hd 48
        WK.wkv6(r3, r3, r3, r3, torch.zeros(2, 48, device=cuda_device))


def test_small_rwkv_model_serves_through_the_kernel(cuda_device):
    """A 2-layer reduced rwkv6 (hd 32) on the card against the same seeded
    weights on the CPU: one prefill of 64 tokens launches the kernel once
    per layer, the decode steps never; logits of the prefill and of
    teacher-forced decode steps agree, and so do the greedy tokens."""
    cfg = smoke_config("rwkv6-3b", n_layers=2)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 64)))
    cpu = Model.from_seed(cfg, 0, "cpu")
    card = Model.from_seed(cfg, 0, cuda_device)
    before = WK.LAUNCHES
    got = greedy_generate(card, prompt.to(cuda_device), 6, 80)
    torch.cuda.synchronize()
    assert WK.LAUNCHES - before == cfg.n_layers
    want = greedy_generate(cpu, prompt, 6, 80)
    assert torch.equal(got.cpu(), want)
    with torch.inference_mode():
        cc, cp = card.init_cache(2, 80), cpu.init_cache(2, 80)
        lc, _ = card(prompt.to(cuda_device), mode="prefill", cache=cc)
        lp, _ = cpu(prompt, mode="prefill", cache=cp)
        steps = [(lc, lp)]
        for i in range(4):
            tok = prompt[:, i:i + 1]
            lc, _ = card(tok.to(cuda_device), mode="decode", pos0=64 + i,
                         cache=cc)
            lp, _ = cpu(tok, mode="decode", pos0=64 + i, cache=cp)
            steps.append((lc, lp))
    for a, b in steps:
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)


# ------------------------------------------------------------- mamba scan

# chip_smoke.py's mamba_scan tolerance: atol 1e-4, rtol 1e-3 (the kernel's
# ex2.approx is ~1e-6 relative from torch.exp, products in another order);
# y in bf16 gets one bf16 step (2**-7 relative)
SCAN_ATOL, SCAN_RTOL, SCAN_BF16_RTOL = 1e-4, 1e-3, 2.0 ** -7


def _scan_inputs(seed, B, S, D, N, device, h0=True, dt_max=None,
                 u_bf16=False):
    """u, B, C ~ N(0, 0.5^2), dt = softplus(N(0, 0.3^2)) or uniform in
    [0, dt_max], A = -exp(N(0, 0.3^2)) random in every entry."""
    rng = np.random.default_rng(seed)
    u = 0.5 * rng.standard_normal((B, S, D))
    dt = (np.logaddexp(0.3 * rng.standard_normal((B, S, D)), 0.0)
          if dt_max is None else rng.uniform(0.0, dt_max, (B, S, D)))
    A = -np.exp(0.3 * rng.standard_normal((D, N)))
    Bi, Ci = (0.5 * rng.standard_normal((B, S, N)) for _ in range(2))
    h = 0.5 * rng.standard_normal((B, D, N)) if h0 else None
    out = [None if a is None else
           torch.as_tensor(a.astype(np.float32), device=device)
           for a in (u, dt, A, Bi, Ci, h)]
    if u_bf16:
        out[0] = out[0].bfloat16()
    return out


def _scan_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        rtol = SCAN_BF16_RTOL if g.dtype == torch.bfloat16 else SCAN_RTOL
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), atol=SCAN_ATOL,
                                   rtol=rtol)


SCAN_CASES = [
    # (B, S, D, N, h0 given, dt up to, bf16 u)
    (8, 2048, 16384, 16, True, None, False),   # jamba's serving shape
    (2, 256, 2048, 16, False, None, False),    # h0 = None
    (2, 256, 2048, 8, True, None, False),      # N 8
    (1, 77, 100, 4, True, None, False),        # B 1, ragged D and S, N 4
    (2, 256, 2048, 16, True, None, True),      # bf16 u
    (2, 256, 2048, 16, True, 20.0, False),     # dt * A down to about -50
    (2, 128, 256, 16, True, None, False),      # the smoke width
]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_mamba_scan_kernel_matches_plain(cuda_device, case):
    B, S, D, N, h0, dt_max, bf16 = case
    ins = _scan_inputs(S + D + N, B, S, D, N, cuda_device, h0, dt_max, bf16)
    before = MS.LAUNCHES
    y, h = MS.mamba_scan(*ins)
    torch.cuda.synchronize()
    assert MS.LAUNCHES == before + 1
    assert y.dtype == ins[0].dtype and h.dtype == torch.float32
    _scan_close((y, h), MS.mamba_scan_plain(*ins))


def test_mamba_scan_kernel_carries_state_across_calls(cuda_device):
    u, dt, A, Bi, Ci, h0 = _scan_inputs(3, 2, 500, 2048, 16, cuda_device)
    y, h = MS.mamba_scan(u, dt, A, Bi, Ci, h0)
    cut = 197
    y1, h1 = MS.mamba_scan(*(t[:, :cut].contiguous() for t in (u, dt)), A,
                           *(t[:, :cut].contiguous() for t in (Bi, Ci)), h0)
    y2, h2 = MS.mamba_scan(*(t[:, cut:].contiguous() for t in (u, dt)), A,
                           *(t[:, cut:].contiguous() for t in (Bi, Ci)), h1)
    _scan_close((torch.cat([y1, y2], 1), h2), (y, h))


def test_mamba_scan_raises_on_what_it_does_not_take(cuda_device):
    u, dt, A, Bi, Ci, h0 = _scan_inputs(0, 1, 32, 256, 16, cuda_device)
    with pytest.raises(TypeError):
        MS.mamba_scan(u.double(), dt, A, Bi, Ci, h0)
    with pytest.raises(TypeError):
        MS.mamba_scan(u, dt.bfloat16(), A, Bi, Ci, h0)
    with pytest.raises(ValueError):                   # a CPU tensor
        MS.mamba_scan(u, dt, A.cpu(), Bi, Ci, h0)
    with pytest.raises(ValueError):                   # shapes disagree
        MS.mamba_scan(u, dt, A[:128].contiguous(), Bi, Ci, h0)
    with pytest.raises(ValueError):
        MS.mamba_scan(u, dt, A, Bi, Ci, h0[:, :1].contiguous())
    with pytest.raises(ValueError):                   # strided
        MS.mamba_scan(u.transpose(1, 2).contiguous().transpose(1, 2), dt,
                      A, Bi, Ci, h0)
    with pytest.raises(ValueError):                   # N 12
        MS.mamba_scan(u, dt, A[:, :12].contiguous(),
                      Bi[..., :12].contiguous(), Ci[..., :12].contiguous())


def test_small_jamba_model_serves_through_the_kernels(cuda_device):
    """jamba's 4-layer cut at smoke width (head_dim 64 for the attention
    kernels) on the card against the same seeded weights on the CPU: a
    prefill of 128 tokens launches the scan kernel once per mamba layer
    and flash attention once; the decode steps never launch the scan;
    the greedy tokens and the teacher-forced logits agree."""
    cfg = smoke_config("jamba-1.5-large-398b", n_layers=4, head_dim=64)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 128)))
    cpu = Model.from_seed(cfg, 0, "cpu")
    card = Model.from_seed(cfg, 0, cuda_device)
    before = (MS.LAUNCHES, FA.LAUNCHES, DA.LAUNCHES)
    got = greedy_generate(card, prompt.to(cuda_device), 6, 140)
    torch.cuda.synchronize()
    assert MS.LAUNCHES - before[0] == 3
    assert FA.LAUNCHES - before[1] == 1
    assert DA.LAUNCHES - before[2] == 5
    want = greedy_generate(cpu, prompt, 6, 140)
    assert torch.equal(got.cpu(), want)
    with torch.inference_mode():
        cc, cp = card.init_cache(2, 140), cpu.init_cache(2, 140)
        lc, _ = card(prompt.to(cuda_device), mode="prefill", cache=cc)
        lp, _ = cpu(prompt, mode="prefill", cache=cp)
        steps = [(lc, lp)]
        for i in range(4):
            tok = prompt[:, i:i + 1]
            lc, _ = card(tok.to(cuda_device), mode="decode", pos0=128 + i,
                         cache=cc)
            lp, _ = cpu(tok, mode="decode", pos0=128 + i, cache=cp)
            steps.append((lc, lp))
    for a, b in steps:
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)
