"""The port's multi-head latent attention (MLA, minicpm3-4b) against the
JAX package on the CPU: ``mla_apply`` in train, prefill and teacher-forced
decode against ``repro.modeling.attention._mla_apply``, the latent caches
included; the plain MLA decode (``mla_decode_attention_plain``) against
the reference's decode attention over [ckv | krope] keys and ckv values,
at the smoke widths and at minicpm3-4b's (40 heads, latent 256, rope 32);
``flash_attention_plain`` at unequal q/k and v heads against
``attention_reference``; the kernel's launch plan and the merge of its
parts, replayed; the wrappers' refusals; the seven MLA leaves carried by
``params_from_jax``; the seeded init's distributions.

The layer tests draw every leaf from numpy, the two norms included
(``materialize`` starts them at zeros, which would leave their layout
untested), and hand the same arrays to both sides.  ``smoke_config
("minicpm3-4b", n_layers=2)``: float32, d 128, 4 heads, q_lora 32, kv_lora
16, nope 16, rope 8, v 16.  Tolerance: 1e-4 (atol and rtol) on float32
outputs of magnitude ~1, for sums taken in another order (observed
differences are below 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.modeling import attention as JA
from repro.modeling import model as M
from repro_torch.configs import smoke_config
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.modeling import attention as PA
from repro_torch.modeling.convert import layer_tree, params_from_jax
from repro_torch.modeling.model import MlaLayer, Model, check_trainable, \
    init_params

TOL = 1e-4
ARCH = "minicpm3-4b"
MLA_LEAVES = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _cfgs(**kw):
    return jax_smoke(ARCH, n_layers=2, **kw), smoke_config(ARCH, n_layers=2,
                                                           **kw)


def _layer_params(pcfg, seed=0):
    """One layer's MLA leaves as numpy float32, normals of std 1/sqrt(fan
    in) and the norms as noise of 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, kind, _) in PA.mla_defs(pcfg).items():
        if kind == "zeros":
            out[name] = 0.1 * rng.standard_normal(shape)
        else:
            out[name] = rng.standard_normal(shape) / np.sqrt(
                np.prod(shape[:-1]))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _x(pcfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, pcfg.d_model)).astype(np.float32)


def test_mla_defs_are_the_references():
    jcfg, pcfg = _cfgs()
    want = JA.attn_defs(jcfg)
    got = PA.mla_defs(pcfg)
    assert set(got) == set(want) == set(MLA_LEAVES)
    for name, (shape, kind, scale) in got.items():
        assert shape == want[name].shape, name
        assert kind == want[name].init and scale == want[name].scale, name


def test_mla_train_matches_reference():
    jcfg, pcfg = _cfgs()
    p = _layer_params(pcfg)
    x = _x(pcfg, 2, 24, 1)
    want, _ = JA._mla_apply(jcfg, jax.tree.map(jnp.asarray, p),
                            jnp.asarray(x), mode="train", pos0=0, cache=None)
    got = PA.mla_apply(pcfg, {k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x), mode="train", pos0=0, cache=None)
    assert got.shape == want.shape == (2, 24, pcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("B,S,L", [(2, 24, 30), (1, 1, 6), (3, 17, 17)])
def test_mla_prefill_and_decode_match_reference(B, S, L):
    """A prefill of S tokens into L-slot caches, then teacher-forced decode
    steps to the end of the cache: every output and both caches as
    ``_mla_apply`` gives them (jitted, each mode compiled once)."""
    jcfg, pcfg = _cfgs()
    p = _layer_params(pcfg, seed=B + S)
    jp = jax.tree.map(jnp.asarray, p)
    ref = {mode: jax.jit(lambda p, x, pos0, cache, mode=mode: JA._mla_apply(
        jcfg, p, x, mode=mode, pos0=pos0, cache=cache))
        for mode in ("prefill", "decode")}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    x = _x(pcfg, B, L, S)
    jcache = {"ckv": jnp.zeros((B, L, pcfg.kv_lora_rank)),
              "krope": jnp.zeros((B, L, pcfg.qk_rope_dim))}
    pcache = PA.init_mla_cache(pcfg, B, L, torch.float32, "cpu")
    want, jcache = ref["prefill"](jp, jnp.asarray(x[:, :S]), 0, jcache)
    got = PA.mla_apply(pcfg, tp, torch.as_tensor(x[:, :S]), mode="prefill",
                       pos0=0, cache=pcache)
    _close(got, want)
    for pos in range(S, L):
        for n in ("ckv", "krope"):
            _close(pcache[n], jcache[n])
        want, jcache = ref["decode"](jp, jnp.asarray(x[:, pos:pos + 1]),
                                     jnp.asarray(pos, jnp.int32), jcache)
        got = PA.mla_apply(pcfg, tp, torch.as_tensor(x[:, pos:pos + 1]),
                           mode="decode", pos0=pos, cache=pcache)
        assert got.shape == (B, 1, pcfg.d_model)
        _close(got, want)
    for n in ("ckv", "krope"):
        _close(pcache[n], jcache[n])


def _latents(seed, B, H, C, R, L):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, C), (B, H, R), (B, L, C), (B, L, R))]


@pytest.mark.parametrize("B,H,C,R,L,pos", [
    (2, 4, 16, 8, 40, 0), (2, 4, 16, 8, 40, 23), (2, 4, 16, 8, 40, 39),
    (1, 40, 256, 32, 300, 130), (2, 40, 256, 32, 129, 128)])
def test_mla_decode_plain_matches_reference(B, H, C, R, L, pos):
    """The absorbed decode is decode attention with one latent kv head:
    keys [ckv | krope], values ckv, scale (nope + rope)**-0.5; the
    reference's ``decode_attention`` computes it that way."""
    q_lat, q_rope, ckv, krope = _latents(pos + H, B, H, C, R, L)
    scale = 96 ** -0.5
    want = JA.decode_attention(
        jnp.asarray(np.concatenate([q_lat, q_rope], -1))[:, None],
        jnp.asarray(np.concatenate([ckv, krope], -1))[:, :, None],
        jnp.asarray(ckv)[:, :, None], pos=jnp.asarray(pos, jnp.int32),
        scale=scale)[:, 0]
    got = DA.mla_decode_attention_plain(*map(torch.as_tensor,
                                             (q_lat, q_rope, ckv, krope)),
                                        pos, scale)
    assert got.shape == (B, H, C)
    _close(got, want)
    # the wrapper on CPU tensors is the plain version
    same = DA.mla_decode_attention(*map(torch.as_tensor,
                                        (q_lat, q_rope, ckv, krope)),
                                   pos, scale)
    assert torch.equal(same, got)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV", [(2, 33, 4, 4), (1, 70, 8, 2)])
def test_flash_plain_at_unequal_heads_matches_reference(B, S, H, KV,
                                                        causal):
    """q/k heads of 96 and v heads of 64, MLA prefill's pair."""
    rng = np.random.default_rng(S)
    q, k = (rng.standard_normal((B, S, n, 96)).astype(np.float32)
            for n in (H, KV))
    v = rng.standard_normal((B, S, KV, 64)).astype(np.float32)
    pos = jnp.arange(S)
    want = JA.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_pos=pos, k_pos=pos,
                                  causal=causal)
    got = FA.flash_attention(*map(torch.as_tensor, (q, k, v)),
                             causal=causal)
    assert got.shape == (B, S, H, 64)
    _close(got, want)


def test_flash_and_mla_wrappers_check_their_shapes():
    """The checks run before any launch: the flash forward takes (96, 64)
    and no other unequal pair, its backward refuses (96, 64) with a clear
    error, and the MLA decode takes minicpm3's (40, 256, 32) only, pos in
    the cache."""
    f = torch.zeros
    FA._check(f(1, 8, 4, 96), f(1, 8, 2, 96), f(1, 8, 2, 64), 0)
    for hd, hdv in ((96, 96), (64, 96), (128, 64), (96, 32)):
        with pytest.raises(ValueError, match="head dims"):
            FA._check(f(1, 8, 4, hd), f(1, 8, 2, hd), f(1, 8, 2, hdv), 0)
    q, k, v = f(1, 8, 4, 96), f(1, 8, 2, 96), f(1, 8, 2, 64)
    with pytest.raises(ValueError, match="MLA training"):
        FA._check_bwd(q, k, v, f(1, 8, 4, 96), f(1, 4, 8), f(1, 4, 8), 0)
    good = [f(2, 40, 256), f(2, 40, 32), f(2, 50, 256), f(2, 50, 32)]
    assert DA._mla_check(*good, 49) == (2, 50)
    with pytest.raises(ValueError, match="pos"):
        DA._mla_check(*good, 50)
    with pytest.raises(ValueError, match="kernel takes"):
        DA._mla_check(f(2, 32, 256), f(2, 32, 32), *good[2:], 3)
    with pytest.raises(ValueError, match="shapes disagree"):
        DA._mla_check(good[0], f(2, 40, 16), *good[2:], 3)
    with pytest.raises(TypeError):
        DA._mla_check(*good[:3], good[3].double(), 3)


@pytest.mark.parametrize("n_slots,B,bps,sms", [
    (2081, 8, 1, 132), (1, 8, 1, 132), (2081, 1, 1, 132), (300, 8, 2, 132),
    (5000, 64, 1, 132)])
def test_mla_decode_plan_covers_the_slots(n_slots, B, bps, sms):
    """The MLA wrapper's parts: decode_plan's runs of a one-warp block
    over one kv head."""
    per_part, n_parts = DA.decode_plan(n_slots, B, 1, 1, bps, sms)
    assert per_part % 16 == 0 and per_part > 0
    assert n_parts * per_part >= n_slots > (n_parts - 1) * per_part
    assert n_parts <= max(1, sms * bps // B)


def _replay(q_lat, q_rope, ckv, krope, pos, scale, per_part, n_parts, ts):
    """The kernel's order of work in float32: each part walks tiles of
    ``ts`` slots with one online-softmax update per tile, then the parts
    merge in order p = 0 .. n - 1."""
    s = (torch.einsum("bhc,blc->bhl", q_lat, ckv)
         + torch.einsum("bhr,blr->bhl", q_rope, krope)) * scale
    parts = []
    for p in range(n_parts):
        j0, j1 = p * per_part, min(pos + 1, (p + 1) * per_part)
        m = torch.full(s.shape[:2], -2.0e38)
        lsum = torch.zeros(s.shape[:2])
        acc = torch.zeros(q_lat.shape)
        for t0 in range(j0, j1, ts):
            st = s[..., t0:min(j1, t0 + ts)]
            m_new = torch.maximum(m, st.amax(-1))
            corr = torch.exp(m - m_new)
            pr = torch.exp(st - m_new[..., None])
            lsum = lsum * corr + pr.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhl,blc->bhc", pr, ckv[:, t0:t0 + st.shape[-1]])
            m = m_new
        parts.append((m, lsum, acc))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - big) for m, _, _ in parts]
    den = sum(lsum * wi for (_, lsum, _), wi in zip(parts, w))
    num = sum(acc * wi[..., None] for (_, _, acc), wi in zip(parts, w))
    return num / den.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("B,L,pos,ts", [(8, 700, 650, 64), (2, 129, 128, 32),
                                        (1, 64, 0, 64), (3, 300, 200, 32)])
def test_mla_decode_replay_of_parts_and_merge_matches_plain(B, L, pos, ts):
    """The kernel's tiles, parts (from ``decode_plan`` on an H100's 132
    SMs, one block an SM) and merge give the plain version's answer."""
    ins = [torch.as_tensor(a) for a in _latents(pos, B, 40, 256, 32, L)]
    per_part, n_parts = DA.decode_plan(pos + 1, B, 1, 1, 1, 132)
    got = _replay(*ins, pos, 96 ** -0.5, per_part, n_parts, ts)
    want = DA.mla_decode_attention_plain(*ins, pos, 96 ** -0.5)
    _close(got, want, 1e-5)


def test_flash_tile_config_of_the_mla_instance():
    """tc::Cfg<96, 64>: two 64-column chunks of q and k (the second half
    outside the tensor map), one of v, and a block within 227 KB."""
    cfg = FA.tile_config(96, 64)
    assert (cfg["QK_CHUNKS"], cfg["V_CHUNKS"]) == (2, 1)
    assert cfg["K_BYTES"] == 2 * cfg["V_BYTES"] == cfg["BK"] * 256
    assert cfg["SMEM"] == 1024 + cfg["Q_BYTES"] + cfg["NS"] * (
        cfg["K_BYTES"] + cfg["V_BYTES"]) + cfg["BAR_BYTES"]
    assert cfg["SMEM"] <= 227 * 1024
    assert (96, 64) in FA.HEAD_DIM_PAIRS


def test_params_from_jax_carries_the_mla_leaves():
    jcfg, pcfg = _cfgs()
    tree = jax.tree.map(np.asarray, M.init_params(jcfg,
                                                  jax.random.PRNGKey(3)))
    model = params_from_jax(pcfg, tree, device="cpu")
    assert all(isinstance(layer, MlaLayer) for layer in model.layers)
    for i, layer in enumerate(model.layers):
        src = layer_tree(pcfg, tree, i)["attn"]
        assert set(layer.attn) == set(MLA_LEAVES)
        for name in MLA_LEAVES:
            np.testing.assert_array_equal(layer.attn[name].numpy(),
                                          np.asarray(src[name]))
    cache = model.init_cache(2, 12)
    assert [sorted(c) for c in cache] == [["ckv", "krope"]] * 2
    assert cache[0]["ckv"].shape == (2, 12, pcfg.kv_lora_rank)
    assert cache[0]["krope"].shape == (2, 12, pcfg.qk_rope_dim)


def test_seeded_init_has_materialize_distributions():
    """Zeros where JAX has zeros (the two norms), and each normal leaf's
    standard deviation within 3% of the JAX init's."""
    kw = dict(d_model=256, q_lora_rank=128, kv_lora_rank=64)
    jcfg, pcfg = _cfgs(**kw)
    jmodel = params_from_jax(pcfg, jax.tree.map(
        np.asarray, M.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    port = init_params(pcfg, 0, "cpu")
    for i, layer in enumerate(jmodel.layers):
        for name, want in layer.attn.items():
            got = port["layers"][i]["attn"][name]
            assert got.shape == want.shape, (i, name)
            if name.endswith("norm"):
                assert not got.any() and not want.any(), name
            else:
                np.testing.assert_allclose(got.std().item(),
                                           want.std().item(), rtol=0.03,
                                           err_msg=f"layer {i} {name}")


def test_training_mla_is_refused_with_a_clear_error():
    _, pcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="MLA.*ROADMAP.md"):
        check_trainable(pcfg)
    with pytest.raises(NotImplementedError, match="MLA"):
        Model.from_seed(pcfg, 0, "cpu").trainable()
