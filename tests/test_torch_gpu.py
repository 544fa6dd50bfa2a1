"""Tests of the port that need a CUDA card: the hand-written GBM-ensemble
kernel against its plain PyTorch version, the engine's routing to it, and a
predictor fitted on the card against the same fit on the CPU; the
flash-attention and flash-decode kernels against their plain versions, and
a small LM served through them; the WKV6 kernel against both of its plain
versions, and a small RWKV6 model served through it; the selective-scan
kernel against its plain version, and a small jamba (mamba, attention and
MoE layers) served through it and the attention kernels; the hub's
public surface on the card (a row predicted alone against inside batches
for every model kind, the lanes' answers against the inline ones with
their GBM launches counted, the fit sidecar); a tiny collaborative
replay on the card against the same replay on the CPU; the flash-attention
backward kernels against their plain version, the forward's bytes with and
without its log-sum-exp output, and one train step of a 2-layer
full-width gemma3 on the card against the same step on the CPU; the WKV6
and selective-scan backward kernels against their plain versions (bit
for bit on repeat, through their autograd Functions, and the wrappers'
refusals), and one train step of a reduced rwkv6 and jamba on the card
against the CPU; minicpm3's MLA kernels (the flash forward at q/k head
96 and v head 64, the MLA decode over the latent caches) against their
plain versions, bit for bit on repeat, the refusals of MLA training, and a
reduced minicpm3 at its attention widths served through them.  They skip
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
    (300, 16, 30, 4), (513, 1, 10, 1), (24576, 4, 200, 3),
    (24576, 3, 2000, 3),      # tiles of shared memory over 48 KB
    (24576, 5, 100, 10),      # the generic depth instance
    (24576, 3, 203, 3),       # not a multiple of the slices or chains
    (2 ** 20, 16, 200, 3)])   # one row a thread, blocks loop over chunks
@pytest.mark.parametrize("y_scale", [0.0, 250.0])
def test_kernel_matches_plain(cuda_device, n, d, T, depth, y_scale):
    """Bit for bit at y_scale != 0 (the same float32 sum in the same tree
    order, then one multiply); at y_scale == 0 within 1e-6, since expf and
    torch.exp may differ by an ulp."""
    t = _ensemble(n + d, n, d, T, depth, cuda_device)
    before = K.LAUNCHES
    got = K.gbm_predict(*t, 0.3, y_scale)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.gbm_predict_plain(*t, 0.3, y_scale)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    if y_scale != 0.0:
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


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
# bf16 decode likewise: chip_smoke.py's DECODE_BF16_REL
DECODE_BF16_REL = 5e-3


def _qkv(seed, B, S, H, KV, hd, dtype, device, L=None, hdv=None):
    rng = np.random.default_rng(seed)
    L = S if L is None else L
    hdv = hd if hdv is None else hdv
    t = [rng.standard_normal(s).astype(np.float32)
         for s in ((B, S, H, hd), (B, L, KV, hd), (B, L, KV, hdv))]
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
    # the kernel's tiles of 32 slots and runs of 16-slot multiples: runs
    # that end inside a tile; warps whose slots are all masked (the ring's
    # first turn, 411 empty slots)
    (2, 1000, 8, 4, 128, 999, 0, 0.0, False),
    (3, 333, 2, 1, 64, 332, 100, 0.0, False),
    (8, 512, 4, 1, 256, 100, 512, 0.0, True),
] + [(2, 777, 2 * g, 2, hd, 700, 0, 0.0, False)    # G 1, 2, 4, 8
     for g in (1, 2, 4, 8) for hd in (64, 128, 256)]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda_device, case, dtype):
    B, L, H, KV, hd, pos, window, cap, ring = case
    q, kc, vc = _qkv(L + pos, B, 1, H, KV, hd, dtype, cuda_device, L=L)
    q = q[:, 0].contiguous()
    k_pos = ring_positions(L, pos, cuda_device) if ring else None
    before = DA.LAUNCHES
    got = DA.decode_attention(q, kc, vc, pos, window=window, softcap=cap,
                              k_pos=k_pos)
    torch.cuda.synchronize()
    assert DA.LAUNCHES == before + 1
    want = DA.decode_attention_plain(q, kc, vc, pos, window=window,
                                     softcap=cap, k_pos=k_pos)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)
    if dtype == torch.bfloat16:
        g, w = got.double(), want.double()
        assert float((g - w).norm() / w.norm()) <= DECODE_BF16_REL
    # the kernel leaves its ticket counters zero for the next call
    assert not bool(DA._COUNTERS[q.device].any())


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_tiling_reported_by_the_library(cuda_device, hd, dtype):
    """The tiling the wrapper plans with comes from the library: tiles of
    32 slots, 1-4 warps a block, a block's shared memory within the
    227 KiB a Hopper block may take, at least one block resident an SM,
    the card's SM count, and jamba's decode step planned as one wave."""
    props = torch.cuda.get_device_properties(cuda_device)
    for G in DA.GROUPS:
        cfg = DA.tile_config(hd, dtype, G, cuda_device.index or 0)
        assert cfg["kT"] == 32 and cfg["W"] in (1, 2, 4)
        assert 0 < cfg["SMEM"] <= 227 * 1024
        assert cfg["blocks_per_sm"] >= 1
        assert cfg["sms"] == props.multi_processor_count
        per, n = DA.decode_plan(2081, 8, 8, cfg["W"], cfg["blocks_per_sm"],
                                cfg["sms"])
        assert n * 8 * 8 <= max(cfg["sms"] * cfg["blocks_per_sm"], 64)


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


# -------------------------------------------------------------------- MLA

MLA_SCALE = 96 ** -0.5
MLA_FLASH_CASES = [(2, 300), (1, 1), (2, 129), (1, 128), (8, 2048)]  # B, S


@pytest.mark.parametrize("B,S", MLA_FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_instance_matches_plain(cuda_device, B, S,
                                                    dtype):
    """The (96, 64) instance: 40 heads, causal, q/k heads of 96 and v heads
    of 64, within TOL (bf16 also FLASH_BF16_REL), a repeat bit for bit."""
    rng = np.random.default_rng(S)
    q, k = (torch.as_tensor(rng.standard_normal((B, S, 40, 96)).astype(
        np.float32), device=cuda_device).to(dtype) for _ in range(2))
    v = torch.as_tensor(rng.standard_normal((B, S, 40, 64)).astype(
        np.float32), device=cuda_device).to(dtype)
    before = FA.LAUNCHES
    got = FA.flash_attention(q, k, v, scale=MLA_SCALE)
    again = FA.flash_attention(q, k, v, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 2
    assert got.shape == (B, S, 40, 64) and got.dtype == dtype
    assert torch.equal(got, again)
    want = FA.flash_attention_plain(q, k, v, scale=MLA_SCALE)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)
    if dtype == torch.bfloat16 and S > 1:
        g, w = got.double(), want.double()
        assert float((g - w).norm() / w.norm()) <= FLASH_BF16_REL


# the (96, 64) instance with a window, a softcap, grouped kv heads, no
# causal mask and a negative scale (the max of -x): B, S, H, KV, causal,
# window, softcap, scale
MLA_FLASH_MASK_CASES = [
    (2, 700, 40, 40, True, 100, 0.0, MLA_SCALE),
    (2, 700, 40, 40, True, 0, 30.0, MLA_SCALE),
    (2, 333, 40, 8, False, 64, 20.0, MLA_SCALE),
    (2, 500, 40, 40, False, 0, 0.0, MLA_SCALE),
    (1, 400, 8, 8, True, 0, 0.0, -0.1)]


@pytest.mark.parametrize("B,S,H,KV,causal,window,cap,scale",
                         MLA_FLASH_MASK_CASES)
def test_flash_attention_mla_instance_masks_and_lse(cuda_device, B, S, H,
                                                    KV, causal, window, cap,
                                                    scale):
    """The (96, 64) bf16 instance against its plain version under every
    mask it takes, within TOL and FLASH_BF16_REL; its lse output (the
    instance MLA training will call) against flash_attention_lse_plain
    with the output's bits unchanged; each call repeated bit for bit."""
    rng = np.random.default_rng(S + H)
    q = torch.as_tensor(rng.standard_normal((B, S, H, 96)).astype(
        np.float32), device=cuda_device).bfloat16()
    k = torch.as_tensor(rng.standard_normal((B, S, KV, 96)).astype(
        np.float32), device=cuda_device).bfloat16()
    v = torch.as_tensor(rng.standard_normal((B, S, KV, 64)).astype(
        np.float32), device=cuda_device).bfloat16()
    kw = dict(causal=causal, window=window, softcap=cap, scale=scale)
    got = FA.flash_attention(q, k, v, **kw)
    again = FA.flash_attention(q, k, v, **kw)
    o, lse = FA.flash_attention_lse(q, k, v, **kw)
    o2, lse2 = FA.flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, o)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    want = FA.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16] * 10)
    g, w = got.double(), want.double()
    assert float((g - w).norm() / w.norm()) <= FLASH_BF16_REL
    lw = FA.flash_attention_lse_plain(q, k, **kw)
    np.testing.assert_allclose(lse.cpu().numpy(), lw.cpu().numpy(),
                               atol=1e-4, rtol=1e-5)


MLA_DECODE_CASES = [   # B, L, pos
    (8, 2120, 2080), (8, 2120, 0), (8, 2120, 1100), (1, 2120, 2080),
    (2, 300, 77), (3, 64, 63),
    (8, 2120, 63), (8, 2120, 64),       # the run ends on a tile's edge
    (8, 2120, 191), (8, 2120, 192),     # ... on a part's edge (192 slots)
    (16, 2120, 2080), (8, 2120, 2111)]


def _mla_inputs(seed, B, L, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                            device=device).to(dtype)
            for s in ((B, 40, 256), (B, 40, 32), (B, L, 256), (B, L, 32))]


@pytest.mark.parametrize("B,L,pos", MLA_DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_kernel_matches_plain(cuda_device, B, L, pos, dtype):
    ins = _mla_inputs(L + pos, B, L, dtype, cuda_device)
    before = DA.MLA_LAUNCHES
    got = DA.mla_decode_attention(*ins, pos, MLA_SCALE)
    again = DA.mla_decode_attention(*ins, pos, MLA_SCALE)
    torch.cuda.synchronize()
    assert DA.MLA_LAUNCHES == before + 2
    assert got.shape == (B, 40, 256) and got.dtype == dtype
    assert torch.equal(got, again)
    want = DA.mla_decode_attention_plain(*ins, pos, MLA_SCALE)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)
    if dtype == torch.bfloat16:
        g, w = got.double(), want.double()
        assert float((g - w).norm() / w.norm()) <= DECODE_BF16_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_decode_tiling_reported_by_the_library(cuda_device, dtype):
    """bf16: tiles of 64 slots, a producer and a consumer warpgroup, and
    the largest cluster of parts that fits; float32: tiles of 32, 4 warps,
    a merge launch of up to 1024 parts.  The serving call's plan is one
    wave of blocks."""
    dev = cuda_device.index or 0
    cfg = DA.mla_tile_config(dtype, dev)
    bf16 = dtype == torch.bfloat16
    assert cfg["TS"] == (64 if bf16 else 32)
    assert cfg["W"] == (8 if bf16 else 4) and 0 < cfg["SMEM"] <= 227 * 1024
    assert cfg["blocks_per_sm"] >= 1
    assert 8 <= cfg["max_parts"] <= 16 if bf16 else cfg["max_parts"] == 1024
    per, n = DA.mla_launch_plan(dtype, dev, 2081, 8)
    assert 8 * n <= cfg["sms"] * cfg["blocks_per_sm"]
    assert n <= cfg["max_parts"] and per % (64 if bf16 else 16) == 0


def test_mla_training_and_other_shapes_are_refused(cuda_device):
    """The flash backward at MLA's (96, 64) launches delta, dkdv and dq
    once each and matches its plain version; it refuses (96, 32) before it
    launches anything; the model trains MLA; the MLA decode takes only
    minicpm3's (40, 256, 32) and a pos inside the cache."""
    from repro_torch.modeling.model import check_trainable
    for dtype, limit in ((torch.float32, FLASH_BWD_F32_REL),
                         (torch.bfloat16, FLASH_BWD_BF16_REL)):
        q, k, v = _qkv(11, 1, 200, 8, 8, 96, dtype, cuda_device, hdv=64)
        o, lse = FA.flash_attention_lse(q, k, v)
        do = torch.randn_like(o)
        before = (FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES,
                  FA.DKDV_SUM_LAUNCHES)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        assert (FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES,
                FA.DKDV_SUM_LAUNCHES) == tuple(n + 1 for n in before[:3]) + \
            before[3:]
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do)
        for g, w in zip(got, want):
            assert g.shape == w.shape and _within(g, w, limit), _rel(g, w)
    q = torch.zeros(1, 64, 4, 96, device=cuda_device)
    v = torch.zeros(1, 64, 4, 32, device=cuda_device)
    o = torch.zeros(1, 64, 4, 32, device=cuda_device)
    lse = torch.zeros(1, 4, 64, device=cuda_device)
    before = (FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES)
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention_bwd(q, q, v, o, lse, torch.zeros_like(o))
    assert (FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES) == before
    check_trainable(smoke_config("minicpm3-4b"))
    ins = _mla_inputs(0, 2, 100, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        DA.mla_decode_attention(*ins, 100, MLA_SCALE)
    with pytest.raises(ValueError):
        DA.mla_decode_attention(ins[0][:, :32].contiguous(),
                                ins[1][:, :32].contiguous(), *ins[2:], 3,
                                MLA_SCALE)
    with pytest.raises(TypeError):
        DA.mla_decode_attention(*ins[:3], ins[3].bfloat16(), 3, MLA_SCALE)


def test_small_minicpm3_serves_through_the_mla_kernels(cuda_device):
    """A reduced minicpm3 (2 layers, d 256) at its attention widths (40
    heads, kv_lora 256, nope 64, rope 32, v 64) on the card in float32,
    against the same seeded weights on the CPU: one flash launch a layer
    in prefill, one MLA decode launch a layer and step, the greedy tokens
    and the logits the same."""
    cfg = smoke_config("minicpm3-4b", n_layers=2, d_model=256, n_heads=40,
                       n_kv_heads=40, q_lora_rank=128, kv_lora_rank=256,
                       qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64)
    prompt = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 70)))
    cpu = Model.from_seed(cfg, 0, "cpu")
    card = Model.from_seed(cfg, 0, cuda_device)
    before = (FA.LAUNCHES, DA.MLA_LAUNCHES, DA.LAUNCHES)
    got = greedy_generate(card, prompt.to(cuda_device), 6, 80)
    torch.cuda.synchronize()
    assert FA.LAUNCHES - before[0] == cfg.n_layers
    assert DA.MLA_LAUNCHES - before[1] == 5 * cfg.n_layers
    assert DA.LAUNCHES == before[2]
    want = greedy_generate(cpu, prompt, 6, 80)
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


# ------------------------------------------------- the hub's public surface

MODEL_KINDS = ("ernest", "gbm", "bom", "ogb", "linreg")


@pytest.mark.parametrize("kind", MODEL_KINDS)
def test_one_row_predicts_the_bits_of_a_batch(cuda_device, kind):
    """The predict lanes answer a row from inside a batch of any size; the
    answer must be the row's own bits, the same as predicted alone."""
    from repro_torch.core.models.api import FittedModel, get_model
    d = W.generate_job_data("grep")
    v = d.machine_view("c5.xlarge")
    fm = FittedModel(get_model(kind), v.X, v.y, device=cuda_device)
    rows = d.X[np.random.default_rng(0).integers(0, len(d), 256)]
    full = fm.predict(rows).astype(np.float32).view(np.int32)
    for n in (1, 2, 7, 33, 64, 255):
        part = fm.predict(rows[:n]).astype(np.float32).view(np.int32)
        np.testing.assert_array_equal(part, full[:n], err_msg=f"n={n}")
    for i in range(0, 256, 37):
        one = fm.predict(rows[i:i + 1]).astype(np.float32).view(np.int32)
        np.testing.assert_array_equal(one, full[i:i + 1], err_msg=f"row {i}")


@pytest.fixture(scope="module")
def card_gateway():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    from repro_torch.serve.edge import _demo_gateway, warm
    gw = _demo_gateway(("grep", "sort"), device="cuda")
    warm(gw)
    return gw


def _lane_requests(n=96, seed=3):
    from repro_torch.api import ChooseRequest, PredictRequest
    rng = np.random.default_rng(seed)
    out = []
    for job in ("grep", "sort"):
        d = W.generate_job_data(job)
        for i in rng.integers(0, len(d), n // 2):
            row = tuple(float(v) for v in d.X[i])
            out.append(PredictRequest(job, str(d.machine_type[i]), (row,)))
            out.append(ChooseRequest(job, row[1:],
                                     t_max=float(d.y[i] * 2.0)))
    return out


@pytest.mark.parametrize("timeout_s", [None, 60.0])
def test_lanes_answer_the_inline_bytes_on_the_card(card_gateway, timeout_s):
    """Coalesced predicts and chooses on the card encode to the bytes of
    the same request served alone; with ``timeout_s`` the lanes dispatch
    from executor threads, several lanes at once, and every GBM dispatch
    is counted: a grep predict launches the kernel once, a grep choose
    once per machine type (all three select gbm), sort (ernest) never."""
    import asyncio

    from repro_torch.api import AsyncHubGateway, encode
    gw = card_gateway
    reqs = _lane_requests()
    grep = gw.hub.get("grep")
    gbm_machines = [m for m in grep.store.data.present_machines()
                    if grep.predictor_for(m).selected == "gbm"]

    async def drive():
        async with AsyncHubGateway(gw, max_batch=64,
                                   timeout_s=timeout_s) as agw:
            before = K.LAUNCHES
            got = await asyncio.gather(*[agw.handle_async(q) for q in reqs])
            torch.cuda.synchronize()
            return got, K.LAUNCHES - before, dict(agw.lane_stats)

    got, launched, stats = asyncio.run(drive())
    assert all(r.ok for r in got)
    want = sum(s.batches for name, s in stats.items()
               if name.startswith("grep@")
               and name.split("@")[1] in gbm_machines) \
        + stats["grep"].batches * len(gbm_machines)
    assert launched == want
    assert any(s.requests > s.batches for s in stats.values())
    for q, r in zip(reqs, got):
        assert encode(r) == encode(gw.handle(q))


def test_fit_sidecar_round_trip_on_the_card(cuda_device, tmp_path):
    """save_fits on the card's fitted repo, load_fits into a fresh repo on
    cuda: no refit, and predictions with the fitted ones' bits."""
    from repro_torch.core import JobRepo, RuntimeDataStore
    d = W.generate_job_data("grep")
    kw = dict(pad_rows=True, max_cv_folds=15, device="cuda")
    repo = JobRepo("grep", "grep", d.schema,
                   RuntimeDataStore(d, seed=0, device="cuda"),
                   predictor_kw=kw)
    machines = d.present_machines()
    fitted = {m: repo.predictor_for(m) for m in machines}
    path = str(tmp_path / "grep.fits.npz")
    assert repo.save_fits(path) == len(machines)
    fresh = JobRepo("grep", "grep", d.schema,
                    RuntimeDataStore(d, seed=0, device="cuda"),
                    predictor_kw=kw)
    engine.cache_clear()
    assert fresh.load_fits(path) == len(machines)
    for m in machines:
        got = fresh.predictor_for(m)
        assert got.selected == fitted[m].selected
        assert (got.mu, got.sigma) == (fitted[m].mu, fitted[m].sigma)
        a = got.predict(d.X).astype(np.float32).view(np.int32)
        b = fitted[m].predict(d.X).astype(np.float32).view(np.int32)
        np.testing.assert_array_equal(a, b)
    stats = engine.cache_stats()
    assert stats["fit"] == 0 and stats["cv"] == 0, stats


def test_tiny_replay_on_the_card_gives_the_cpu_ports_rows(cuda_device):
    """The eval plane on the card: a tiny leave-one-user-out replay gives
    the CPU port's trajectory rows and selections, MAPE and MAE within the
    parity tolerances (linear models 1e-5 relative, rows with trees 2e-3),
    through the GBM kernel (sgd's selections include gbm, whose c3o rows
    predict through it)."""
    from repro_torch.eval import replay as R
    kw = dict(jobs=("sgd",), n_users=2, seed=0, chunks_per_user=2,
              max_cv_folds=8)
    cpu = R.run_replay(R.ReplayConfig(device="cpu", **kw))
    before = K.LAUNCHES
    card = R.run_replay(R.ReplayConfig(device="cuda", **kw))
    assert K.LAUNCHES > before
    keys = ("job", "held_out", "step", "store_rows", "rows_contributed",
            "epoch", "machine", "model", "selected")
    assert len(card.records) == len(cpu.records) > 0
    assert (card.contributions, card.accepted) == \
        (cpu.contributions, cpu.accepted)
    trees = ("gbm", "ogb", "bom")
    for a, b in zip(cpu.records, card.records):
        assert tuple(a[k] for k in keys) == tuple(b[k] for k in keys)
        tol = 2e-3 if a["model"] in trees or a["selected"] in trees \
            else 1e-5
        for col in ("mape", "mae"):
            assert abs(b[col] - a[col]) <= tol * abs(a[col]), (a, b, col)


# ----------------------------------------------------------- flash backward

# float32: the same float32 sums in another order, over up to 2048 terms
FLASH_BWD_F32_REL = 1e-5
# bfloat16: the wgmma kernels multiply bf16 operands into float32 sums,
# round P and dS to bf16 before their products (as the forward rounds P)
# and dq, dk and dv once at the end (2**-9 relative each); chip_smoke.py's
# train_kernel phase states the bound's controls
FLASH_BWD_BF16_REL = 5e-3

FLASH_BWD_CASES = [
    # (B, S, H, KV, hd, causal, window, cap[, hdv: v's head dim, else hd])
    (2, 256, 4, 1, 256, True, 0, 0.0),
    (1, 300, 4, 1, 256, True, 64, 0.0),       # ragged, window, G 4
    (2, 200, 8, 4, 128, True, 0, 30.0),       # softcap, G 2
    (1, 256, 4, 4, 64, False, 0, 0.0),        # non-causal, G 1
    (1, 130, 16, 2, 128, True, 17, 50.0),     # G 8, window across tiles
    (2, 1, 4, 1, 64, True, 0, 0.0),
    (1, 77, 2, 2, 256, False, 16, 0.0),       # non-causal with a window
    (2, 1024, 4, 1, 256, True, 512, 0.0),     # gemma3's local layer
    # MLA's (96, 64): minicpm3's 40 heads, grouped heads (the bf16 partials
    # summed at 96 and at 64), a window across tiles with a softcap,
    # ragged and non-causal S, S = 1
    (1, 512, 40, 40, 96, True, 0, 0.0, 64),
    (1, 300, 8, 2, 96, True, 100, 30.0, 64),
    (2, 129, 4, 4, 96, False, 0, 0.0, 64),
    (2, 1, 4, 1, 96, True, 0, 0.0, 64),
    # the bf16 (96, 64) kernels' items of 128 keys and 128 rows: the last
    # item's second warpgroup past S, a window that ends inside the second
    # warpgroup's keys, more pairs of items than SMs under G 4
    (1, 1050, 8, 8, 96, True, 0, 0.0, 64),
    (1, 1000, 8, 8, 96, True, 100, 0.0, 64),
    (2, 2048, 40, 10, 96, True, 0, 0.0, 64),
]


def _rel(got, want):
    g, w = got.double(), want.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-300))


def _within(got, want, rel):
    """||got - want|| <= rel ||want|| + 1e-6 sqrt(n): the absolute term
    covers gradients that are zero up to rounding (at S = 1, P = 1 and dP
    = delta, so dq and dk are float32 noise of order 1e-7)."""
    g, w = got.double(), want.double()
    return float((g - w).norm()) <= rel * float(w.norm()) \
        + 1e-6 * w.numel() ** 0.5


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_match_plain(cuda_device, case, dtype):
    """The three backward launches against ``flash_attention_bwd_plain``
    on the same inputs (the forward kernel's o and lse); the lse against
    its plain version; a second call gives the same bits (no atomics)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    B, S, H, KV, hd, causal, window, cap = case[:8]
    hdv = case[8] if len(case) > 8 else hd
    kw = dict(causal=causal, window=window, softcap=cap)
    q, k, v = _qkv(S + hd + 1, B, S, H, KV, hd, dtype, cuda_device,
                   hdv=hdv)
    do = torch.randn((B, S, H, hdv), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(S)
                     ).to(dtype)
    o, lse = FA.flash_attention_lse(q, k, v, **kw)
    lse_want = FA.flash_attention_lse_plain(q, k, **kw)
    np.testing.assert_allclose(lse.cpu().numpy(), lse_want.cpu().numpy(),
                               atol=1e-4, rtol=1e-5)
    before = (FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES, FA.DKDV_SUM_LAUNCHES,
              FA.DQ_LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    # bf16 with G > 1 sums the dkdv launch's per-head partials
    sums = 2 if dtype == torch.bfloat16 and H > KV else 0
    assert (FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES, FA.DKDV_SUM_LAUNCHES,
            FA.DQ_LAUNCHES) == (before[0] + 2, before[1] + 2,
                                before[2] + sums, before[3] + 2)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    limit = FLASH_BWD_F32_REL if dtype == torch.float32 \
        else FLASH_BWD_BF16_REL
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a), name
        assert bool(g.float().isfinite().all()), name
        assert _within(g, w, limit), (name, _rel(g, w))


@pytest.mark.parametrize("case", FLASH_CASES[:9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_bytes_do_not_depend_on_lse(cuda_device, case, dtype):
    B, S, H, KV, hd, causal, window, cap = case
    q, k, v = _qkv(S + hd, B, S, H, KV, hd, dtype, cuda_device)
    kw = dict(causal=causal, window=window, softcap=cap)
    plain = FA.flash_attention(q, k, v, **kw)
    with_lse, lse = FA.flash_attention_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(plain, with_lse)
    assert lse.shape == (B, H, S) and bool(lse.isfinite().all())


def test_flash_autograd_matches_autograd_of_plain(cuda_device):
    """``flash_attention`` with inputs that require grad goes through the
    autograd Function (one forward, three backward launches), and its
    gradients in float32 are autograd's of the plain version."""
    kw = dict(causal=True, window=48, softcap=20.0)
    q, k, v = (t.requires_grad_() for t in
               _qkv(5, 2, 160, 8, 2, 128, torch.float32, cuda_device))
    before = (FA.LAUNCHES, FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES,
              FA.DQ_LAUNCHES, FA.DKDV_SUM_LAUNCHES)
    o = FA.flash_attention(q, k, v, **kw)
    do = torch.randn_like(o)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert (FA.LAUNCHES, FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES,
            FA.DQ_LAUNCHES, FA.DKDV_SUM_LAUNCHES) == \
        tuple(n + 1 for n in before[:4]) + before[4:]
    want = torch.autograd.grad(FA.flash_attention_plain(q, k, v, **kw),
                               (q, k, v), do)
    for g, w in zip(grads, want):
        assert _rel(g, w) <= FLASH_BWD_F32_REL


@pytest.mark.parametrize("H,KV,hd", [(4, 1, 256), (8, 8, 128), (16, 2, 64)])
def test_flash_autograd_bf16_runs_the_wgmma_backward(cuda_device, H, KV, hd):
    """In bf16 the autograd Function's backward is the wgmma route: one
    launch each of delta, dkdv and dq, and the dkdv sum when G > 1; its
    gradients within FLASH_BWD_BF16_REL of autograd of the plain version
    on the same bf16 inputs."""
    kw = dict(causal=True, window=0 if hd == 256 else 100, softcap=0.0)
    q, k, v = (t.requires_grad_() for t in
               _qkv(hd + H, 2, 320, H, KV, hd, torch.bfloat16, cuda_device))
    before = (FA.LAUNCHES, FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES,
              FA.DQ_LAUNCHES, FA.DKDV_SUM_LAUNCHES)
    o = FA.flash_attention(q, k, v, **kw)
    do = torch.randn_like(o)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert (FA.LAUNCHES, FA.DELTA_LAUNCHES, FA.DKDV_LAUNCHES,
            FA.DQ_LAUNCHES, FA.DKDV_SUM_LAUNCHES) == \
        tuple(n + 1 for n in before[:4]) + (before[4] + (H > KV),)
    want = torch.autograd.grad(FA.flash_attention_plain(q, k, v, **kw),
                               (q, k, v), do)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        assert _within(g, w, FLASH_BWD_BF16_REL), _rel(g, w)


@pytest.mark.parametrize("B,S,H,KV,hd,hdv", [(2, 4096, 4, 1, 256, 256),
                                             (1, 77, 16, 2, 64, 64),
                                             (2, 130, 8, 4, 128, 128),
                                             (1, 300, 40, 8, 96, 64)])
def test_flash_bwd_dkdv_sum_matches_plain_bit_for_bit(cuda_device, B, S, H,
                                                      KV, hd, hdv):
    """The dkdv sum adds a group's heads in the order g = 0 .. G-1 in
    float32 and rounds once, as its plain version does: the same bits, dK
    at hd and dV at hdv."""
    g = torch.Generator(cuda_device).manual_seed(S)
    part = tuple(torch.randn(B, S, H, d, generator=g, device=cuda_device)
                 for d in (hd, hdv))
    before = FA.DKDV_SUM_LAUNCHES
    got = FA.flash_bwd_dkdv_sum(part, KV)
    torch.cuda.synchronize()
    assert FA.DKDV_SUM_LAUNCHES == before + 1
    want = FA.flash_bwd_dkdv_sum_plain(part, KV)
    for a, b, d in zip(got, want, (hd, hdv)):
        assert a.shape == (B, S, KV, d) and a.dtype == torch.bfloat16
        assert torch.equal(a, b)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One AdamW step of gemma3-1b at full width cut to 2 layers (batch 2,
    sequence 256, float32) on the card, through the attention kernels,
    against the same step on the CPU from the same weights: loss and grad
    norm within 1e-5, every gradient leaf within 1e-4 relative, and the
    parameters after the step within 1e-3 relative (chip_smoke.py's
    TRAIN_F32_REL) wherever the CPU's gradient is larger than twice the
    card's difference from it: AdamW's first step moves an element by lr
    times g / (|g| + eps), the sign of its gradient, so an element whose
    gradient is within the difference may flip, and one whose gradient is
    near eps moves by a fraction of lr that float32 noise changes.  Where
    the clipped gradient is also above 1e3 eps (the update's change with
    g is then under 1e-3 / |g|) the parameters agree to 1e-5
    (chip_smoke.py's TRAIN_F32_FAR_REL)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.modeling.model import init_params
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import make_batch
    from repro_torch.train.optimizer import get_optimizer
    cfg = dataclasses.replace(get_config("gemma3-1b", n_layers=2),
                              dtype="float32", param_dtype="float32",
                              grad_accum=1)
    params = init_params(cfg, 3, "cpu")
    batch = make_batch(cfg, 2, 256, 0, seed=3)
    out = {}
    for dev in ("cpu", cuda_device):
        def to(t):
            return t.to(dev, copy=True) if isinstance(t, torch.Tensor) else \
                ({k: to(x) for k, x in t.items()} if isinstance(t, dict)
                 else [to(x) for x in t])
        model = Model(cfg, to(params)).trainable()
        before = (FA.DKDV_LAUNCHES, FA.DKDV_SUM_LAUNCHES)
        grads, metrics = TS.compute_grads(model, to(batch))
        opt = get_optimizer("adamw")
        st = opt.init(TS.params_of(model))
        _, _, gnorm = opt.update(grads, st, TS.params_of(model))
        if dev != "cpu":
            torch.cuda.synchronize()
            # float32: the SIMT dkdv sums a group in registers, no sum launch
            assert (FA.DKDV_LAUNCHES, FA.DKDV_SUM_LAUNCHES) == \
                (before[0] + cfg.n_layers, before[1])
        out[str(dev)] = ({n: g.cpu() for n, g in grads.items()},
                         float(metrics["loss"]), float(gnorm),
                         {n: p.detach().cpu()
                          for n, p in TS.params_of(model).items()})
    (gc, lc, nc, pc), (gg, lg, ng, pg) = out["cpu"], out[str(cuda_device)]
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(ng - nc) <= 1e-5 * nc
    eps, clip = 1e-8, min(1.0, 1.0 / nc)     # adamw's eps, max norm 1.0
    for n in gc:
        assert _rel(gg[n], gc[n]) <= 1e-4, (n, _rel(gg[n], gc[n]))
        decided = gc[n].abs() > 2 * (gg[n] - gc[n]).abs()
        assert _rel(pg[n][decided], pc[n][decided]) <= 1e-3, \
            (n, _rel(pg[n][decided], pc[n][decided]))
        far = decided & ((gc[n] * clip).abs() > 1e3 * eps)
        if bool(far.any()):
            assert _rel(pg[n][far], pc[n][far]) <= 1e-5, \
                (n, _rel(pg[n][far], pc[n][far]))


# ------------------------------------------- RWKV and Mamba backward kernels

# wkv6_bwd / mamba_scan_bwd against their plain versions: float32 on both
# sides, sums in another order and MUFU exponentials (~1e-6 relative), in
# norm per output; dw = d(log w) / w is held as w dw (the 1 / w of a decay
# near the clamp scales float32 noise by up to 8,100) and dw itself to
# 1e-3, as chip_smoke.py's WKV_BWD_REL, WKV_BWD_DW_REL and SCAN_BWD_REL
SSM_BWD_REL, SSM_BWD_DW_REL = 1e-4, 1e-3


def _wkv_bwd_inputs(seed, B, S, H, hd, device, ds_end=True):
    r, k, v, w, u, s0 = _wkv_inputs(seed, B, S, H, hd, device, s0=True,
                                    log_w_min=-12.0)
    w[0, 1, 0, :4] = float(np.float32(np.exp(-9.0)))     # ties at -9
    g = torch.Generator(device=device).manual_seed(seed + 1)
    dy = 0.5 * torch.randn(B, S, H, hd, generator=g, device=device)
    dse = (0.5 * torch.randn(B, H, hd, hd, generator=g, device=device)
           if ds_end else None)
    return r, k, v, w, u, s0, dy, dse


# shapes whose segment plan (wkv6.bwd_segments on the card's SMs) must
# split the chunks unevenly, or keep them in one segment
WKV_BWD_PLANS = {(2, 1008, 8, 64): "ragged", (2, 784, 5, 32): "ragged",
                 (1, 16, 3, 64): "one", (8, 32, 40, 64): "one"}


@pytest.mark.parametrize("B,S,H,hd,ds_end", [
    (1, 64, 2, 16, True), (2, 96, 3, 32, False), (2, 256, 4, 64, True),
    (1, 512, 40, 64, False), (2, 1008, 8, 64, True), (2, 784, 5, 32, False),
    (1, 16, 3, 64, True), (8, 32, 40, 64, False)])
def test_wkv6_bwd_kernel_matches_plain(cuda_device, B, S, H, hd, ds_end):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    segs = WK.bwd_segments(B, S, H, sms, per_sm=WK.bwd_resident(hd)[2])
    plan = WKV_BWD_PLANS.get((B, S, H, hd))
    if plan == "ragged":
        assert segs > 1 and (S // 16) % segs, segs
    elif plan == "one":
        assert segs == 1, segs
    ins = _wkv_bwd_inputs(B + S + hd, B, S, H, hd, cuda_device, ds_end)
    w = ins[3]
    states = WK.wkv6_with_states(*ins[:6])[2]
    before = WK.LAUNCHES_BWD
    got = WK.wkv6_bwd(*ins, states=states)
    again = WK.wkv6_bwd(*ins, states=states)
    torch.cuda.synchronize()
    assert WK.LAUNCHES_BWD == before + 2
    want = WK.wkv6_bwd_plain(*ins)
    for i, (g, a, x) in enumerate(zip(got, again, want)):
        assert torch.equal(g, a)              # no atomics: bit for bit
        if i == 3:
            assert _rel(g * w, x * w) <= SSM_BWD_REL
            assert _rel(g, x) <= SSM_BWD_DW_REL
        else:
            assert _rel(g, x) <= SSM_BWD_REL, (i, _rel(g, x))


@pytest.mark.parametrize("B,S,D,N,dh_end", [
    (1, 100, 200, 4, True), (2, 128, 256, 8, False), (1, 256, 1000, 16, True),
    (1, 64, 64, 16, False), (2, 70, 520, 4, True), (2, 200, 300, 8, False),
    (1, 130, 129, 16, True)])
def test_mamba_scan_bwd_kernel_matches_plain(cuda_device, B, S, D, N,
                                             dh_end):
    u, dt, A, Bi, Ci, h0 = _scan_inputs(B + S + D, B, S, D, N, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(S)
    dy = 0.5 * torch.randn(B, S, D, generator=g, device=cuda_device)
    dhe = (0.5 * torch.randn(B, D, N, generator=g, device=cuda_device)
           if dh_end else None)
    ins = (u, dt, A, Bi, Ci, h0, dy, dhe)
    before = (MS.LAUNCHES, MS.LAUNCHES_BWD)
    chk = MS.mamba_scan_with_checkpoints(*ins[:6])[2]
    got = MS.mamba_scan_bwd(*ins, checkpoints=chk)
    again = MS.mamba_scan_bwd(*ins, checkpoints=chk)
    torch.cuda.synchronize()
    assert (MS.LAUNCHES, MS.LAUNCHES_BWD) == (before[0] + 1, before[1] + 2)
    want = MS.mamba_scan_bwd_plain(*ins)
    for i, (a, b, x) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b)
        assert _rel(a, x) <= SSM_BWD_REL, (i, _rel(a, x))


def test_autograd_functions_route_through_the_backward_kernels(cuda_device):
    """wkv6 and mamba_scan on inputs that require grad go through WKV6 and
    MambaScan: the forward's training instance, then the backward kernel,
    whose gradients equal the wrappers' on the same inputs and agree with
    autograd of the plain forwards."""
    r, k, v, w, u, s0, dy, _ = _wkv_bwd_inputs(3, 1, 128, 4, 64, cuda_device)
    leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u, s0)]
    before = (WK.LAUNCHES, WK.LAUNCHES_BWD)
    y, _ = WK.wkv6(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    assert (WK.LAUNCHES, WK.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    states = WK.wkv6_with_states(r, k, v, w, u, s0)[2]
    for a, b in zip(got, WK.wkv6_bwd(r, k, v, w, u, s0, dy, states=states)):
        assert torch.equal(a, b)
    leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u, s0)]
    want = torch.autograd.grad(WK.wkv6_plain(*leaves)[0], leaves, dy)
    for i, (a, b) in enumerate(zip(got, want)):
        if i != 3:
            assert _rel(a, b) <= SSM_BWD_REL, (i, _rel(a, b))
    u_, dt, A, Bi, Ci, h0 = _scan_inputs(4, 1, 192, 512, 16, cuda_device)
    dy = torch.randn_like(u_)
    leaves = [t.detach().requires_grad_() for t in (u_, dt, A, Bi, Ci, h0)]
    before = (MS.LAUNCHES, MS.LAUNCHES_BWD)
    y, _ = MS.mamba_scan(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    assert (MS.LAUNCHES, MS.LAUNCHES_BWD) == (before[0] + 1, before[1] + 1)
    leaves = [t.detach().requires_grad_() for t in (u_, dt, A, Bi, Ci, h0)]
    want = torch.autograd.grad(MS.mamba_scan_plain(*leaves)[0], leaves, dy)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a, b) <= SSM_BWD_REL, (i, _rel(a, b))


def test_backward_wrappers_raise_on_what_they_do_not_take(cuda_device):
    r, k, v, w, u, s0, dy, dse = _wkv_bwd_inputs(5, 1, 32, 2, 64,
                                                 cuda_device)
    states = WK.wkv6_with_states(r, k, v, w, u, s0)[2]
    with pytest.raises(TypeError):
        WK.wkv6_bwd(r, k, v, w, u, s0, dy.bfloat16(), states=states)
    with pytest.raises(ValueError):                   # states' shape
        WK.wkv6_bwd(r, k, v, w, u, s0, dy, states=states[:, :, :1]
                    .contiguous())
    with pytest.raises(ValueError):                   # ds_end's shape
        WK.wkv6_bwd(r, k, v, w, u, s0, dy, dse[:, :1].contiguous(),
                    states=states)
    with pytest.raises(ValueError):                   # a CPU tensor
        WK.wkv6_bwd(r, k, v, w, u, s0, dy.cpu(), states=states)
    with pytest.raises(ValueError):                   # strided
        WK.wkv6_bwd(r, k, v, w, u, s0, dy.transpose(1, 2), states=states)
    u_, dt, A, Bi, Ci, h0 = _scan_inputs(6, 1, 96, 256, 16, cuda_device)
    dy = torch.randn_like(u_)
    chk = MS.mamba_scan_with_checkpoints(u_, dt, A, Bi, Ci, h0)[2]
    with pytest.raises(TypeError):                    # bf16 u
        MS.mamba_scan_bwd(u_.bfloat16(), dt, A, Bi, Ci, h0, dy,
                          checkpoints=chk)
    with pytest.raises(TypeError):                    # ... also via autograd
        MS.mamba_scan(u_.bfloat16(), dt.requires_grad_(), A, Bi, Ci, h0)
    with pytest.raises(ValueError):                   # checkpoints' shape
        MS.mamba_scan_bwd(u_, dt, A, Bi, Ci, h0, dy,
                          checkpoints=chk[:, :1].contiguous())
    with pytest.raises(ValueError):                   # dh_end's shape
        MS.mamba_scan_bwd(u_, dt, A, Bi, Ci, h0, dy, h0[:, :8].contiguous(),
                          checkpoints=chk)
    with pytest.raises(TypeError):
        MS.mamba_scan_bwd(u_, dt, A, Bi, Ci, h0, dy.double(),
                          checkpoints=chk)


@pytest.mark.parametrize("arch,kw", [
    ("rwkv6-3b", {"n_layers": 2}),
    ("jamba-1.5-large-398b", {"n_layers": 4, "head_dim": 64}),
])
def test_rwkv_and_jamba_train_step_on_the_card_matches_the_cpu(
        cuda_device, arch, kw):
    """One train step of a 2-layer reduced rwkv6 and of jamba's 4-layer
    cut at smoke width (head_dim 64 for the flash kernels), batch 2 x 64,
    float32, remat full on the card (the forward kernel twice a layer, its
    backward once) against remat none on the CPU from the same weights:
    loss and grad norm within 1e-5, every gradient leaf within 1e-4
    relative (float32 sums in another order through the kernels)."""
    import dataclasses
    from repro_torch.modeling.model import init_params
    from repro_torch.train import train_step as TS
    from repro_torch.train.data import make_batch
    cfg = smoke_config(arch, **kw)
    params = init_params(cfg, 3, "cpu")
    batch = make_batch(cfg, 2, 64, 0, seed=3)
    out = {}
    for dev, remat in (("cpu", "none"), (cuda_device, "full")):
        c = dataclasses.replace(cfg, remat=remat)

        def to(t):
            return t.to(dev, copy=True) if isinstance(t, torch.Tensor) else \
                ({k: to(x) for k, x in t.items()} if isinstance(t, dict)
                 else [to(x) for x in t])
        model = Model(c, to(params)).trainable()
        before = (WK.LAUNCHES, WK.LAUNCHES_BWD, MS.LAUNCHES,
                  MS.LAUNCHES_BWD)
        grads, metrics = TS.compute_grads(model, to(batch))
        if dev != "cpu":
            torch.cuda.synchronize()
            kinds = [c.layer_kind(i) for i in range(c.n_layers)]
            n_r, n_m = kinds.count("rwkv"), kinds.count("mamba")
            assert (WK.LAUNCHES - before[0], WK.LAUNCHES_BWD - before[1],
                    MS.LAUNCHES - before[2], MS.LAUNCHES_BWD - before[3]) \
                == (2 * n_r, n_r, 2 * n_m, n_m)
        out[str(dev)] = ({n: g.cpu() for n, g in grads.items()},
                         float(metrics["loss"]), float(metrics["aux_loss"]))
    (gc, lc, ac), (gg, lg, ag) = out["cpu"], out[str(cuda_device)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert abs(ag - ac) <= 1e-5 * max(abs(ac), 1e-30)
    nc = sum(float(g.double().square().sum()) for g in gc.values()) ** 0.5
    ng = sum(float(g.double().square().sum()) for g in gg.values()) ** 0.5
    assert abs(ng - nc) <= 1e-5 * nc
    for n in gc:
        assert _rel(gg[n], gc[n]) <= 1e-4, (n, _rel(gg[n], gc[n]))
