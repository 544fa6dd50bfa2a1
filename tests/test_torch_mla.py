"""The port's multi-head latent attention (MLA, minicpm3-4b) against the
JAX package on the CPU: ``mla_apply`` in train, prefill and teacher-forced
decode against ``repro.modeling.attention._mla_apply``, the latent caches
included; the plain MLA decode (``mla_decode_attention_plain``) against
the reference's decode attention over [ckv | krope] keys and ckv values,
at the smoke widths and at minicpm3-4b's (40 heads, latent 256, rope 32);
``flash_attention_plain`` at unequal q/k and v heads against
``attention_reference``; the kernel's launch plan and the merge of its
parts, replayed; the wrappers' checks (the flash backward takes (96, 64)
and refuses other unequal pairs); a trainable MLA model (the gradient
reaches every leaf, and it still serves); the seven MLA leaves carried by
``params_from_jax``; the seeded init's distributions.

The layer tests draw every leaf from numpy, the two norms included
(``materialize`` starts them at zeros, which would leave their layout
untested), and hand the same arrays to both sides.  ``smoke_config
("minicpm3-4b", n_layers=2)``: float32, d 128, 4 heads, q_lora 32, kv_lora
16, nope 16, rope 8, v 16.  Tolerance: 1e-4 (atol and rtol) on float32
outputs of magnitude ~1, for sums taken in another order (observed
differences are below 1e-6).
"""
import dataclasses

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
    """The checks run before any launch: the flash forward and its
    backward take (96, 64) and no other unequal pair, the backward's dO at
    v's head dim, and the MLA decode takes minicpm3's (40, 256, 32) only,
    pos in the cache."""
    f = torch.zeros
    FA._check(f(1, 8, 4, 96), f(1, 8, 2, 96), f(1, 8, 2, 64), 0)
    for hd, hdv in ((96, 96), (64, 96), (128, 64), (96, 32)):
        with pytest.raises(ValueError, match="head dims"):
            FA._check(f(1, 8, 4, hd), f(1, 8, 2, hd), f(1, 8, 2, hdv), 0)
    q, k, v = f(1, 8, 4, 96), f(1, 8, 2, 96), f(1, 8, 2, 64)
    rows = (f(1, 4, 8), f(1, 4, 8))
    assert FA._check_bwd(q, k, v, f(1, 8, 4, 64), *rows, 0) == \
        (1, 8, 4, 2, 96)
    with pytest.raises(ValueError, match="do must be"):
        FA._check_bwd(q, k, v, f(1, 8, 4, 96), *rows, 0)
    for hd, hdv in ((96, 32), (64, 96), (128, 64)):
        with pytest.raises(ValueError, match="head dims"):
            FA._check_bwd(f(1, 8, 4, hd), f(1, 8, 2, hd), f(1, 8, 2, hdv),
                          f(1, 8, 4, hdv), *rows, 0)
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


# (slot unit, most parts a batch row) of the two routes' plans: bf16 runs of
# whole 64-slot tiles, at most one 16-block cluster; float32 16-slot units,
# at most 1024 parts merged by a second launch
MLA_ROUTES = {"bf16": (64, 16), "f32": (16, 1024)}


@pytest.mark.parametrize("route", sorted(MLA_ROUTES))
@pytest.mark.parametrize("n_slots,B,slots_on_card", [
    (2081, 8, 132), (1, 8, 132), (2081, 1, 132), (300, 8, 264),
    (5000, 64, 132), (2081, 16, 132), (2112, 8, 132), (1101, 8, 132),
    (64, 3, 132), (65, 1, 132)])
def test_mla_decode_plan_covers_the_slots(route, n_slots, B, slots_on_card):
    """``mla_plan``, MLA's own plan: runs of whole tiles that cover the
    kept slots, the last part's run ending where the slots end (inside a
    tile where they do), no empty part, at most ``max_parts`` and one a
    tile, and one wave of blocks over the batch where the card holds it.
    pos 0 is one slot, one part."""
    unit, max_parts = MLA_ROUTES[route]
    per_part, n_parts = DA.mla_plan(n_slots, B, unit, max_parts,
                                    slots_on_card)
    assert per_part % unit == 0 and per_part > 0
    assert n_parts * per_part >= n_slots > (n_parts - 1) * per_part
    assert 1 <= n_parts <= min(max_parts, -(-n_slots // unit))
    assert B * n_parts <= max(B, slots_on_card)
    if n_slots == 1:
        assert (per_part, n_parts) == (unit, 1)


# The clusters of n = 1 .. 16 blocks of the bf16 MLA kernel that an H100
# 80GB HBM3 holds at once (``mla_tile_config``'s "clusters" on the card,
# one block an SM; chip_smoke.py's kernel_build line "clusters_resident")
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)


@pytest.mark.parametrize("B,want", [(1, 16), (7, 16), (8, 9), (9, 9),
                                    (10, 8), (16, 6), (17, 6), (18, 5),
                                    (132, 1), (133, 1)])
def test_mla_max_parts_from_the_cluster_table(B, want):
    """The largest cluster of which all B batch rows' clusters are
    resident at once on an H100, and 1 where not even B single blocks
    are."""
    assert DA.mla_max_parts(H100_CLUSTERS, B) == want


def test_mla_plan_of_the_serving_call():
    """minicpm3's decode at pos 2080 on an H100 (132 SMs, one block an
    SM): bf16 at B 8 takes 9 parts of 256 slots (a cluster of 9 blocks a
    batch row: 8 clusters of 9 fit at once, of 10 only 7), at B 16 6 of
    384, at B 1 11 of 192; float32 decode_plan's former answer, 15 parts
    of 144 slots, unchanged; decode_plan itself, the dense kernel's, as it
    was."""
    def bf16(B):
        return DA.mla_plan(2081, B, 64, DA.mla_max_parts(H100_CLUSTERS, B),
                           132)
    assert bf16(8) == (256, 9)
    assert bf16(16) == (384, 6)
    assert bf16(1) == (192, 11)
    assert DA.mla_plan(2081, 8, 16, 1024, 132) == (144, 15)
    assert DA.decode_plan(2081, 8, 1, 1, 1, 132) == (144, 15)
    assert DA.mla_plan(2081, 1, 16, 1024, 132) == (16, 131)


def _replay(q_lat, q_rope, ckv, krope, pos, scale, per_part, n_parts, ts):
    """The kernel's order of work in float32: each part walks tiles of
    ``ts`` slots with one online-softmax update per tile in log2 units
    (m = max of s log2 e, p = 2^(s log2 e - m), the correction
    2^(m_old - m_new)), an empty part keeps m = NEG_INF and l = 0; then
    the parts merge in the order p = 0 .. n - 1: M = max_p m_p, w_p =
    2^(m_p - M), out = sum_p acc_p w_p / max(sum_p l_p w_p, 1e-30)."""
    s = (torch.einsum("bhc,blc->bhl", q_lat, ckv)
         + torch.einsum("bhr,blr->bhl", q_rope, krope)) * scale \
        * 1.4426950408889634
    parts = []
    for p in range(n_parts):
        j0, j1 = p * per_part, min(pos + 1, (p + 1) * per_part)
        m = torch.full(s.shape[:2], -2.0e38)
        lsum = torch.zeros(s.shape[:2])
        acc = torch.zeros(q_lat.shape)
        for t0 in range(j0, j1, ts):
            st = s[..., t0:min(j1, t0 + ts)]
            m_new = torch.maximum(m, st.amax(-1))
            corr = torch.exp2(m - m_new)
            pr = torch.exp2(st - m_new[..., None])
            lsum = lsum * corr + pr.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhl,blc->bhc", pr, ckv[:, t0:t0 + st.shape[-1]])
            m = m_new
        parts.append((m, lsum, acc))
    big = parts[0][0]
    for m, _, _ in parts[1:]:
        big = torch.maximum(big, m)
    den = torch.zeros_like(big)
    num = torch.zeros_like(q_lat)
    for m, lsum, acc in parts:
        w = torch.exp2(m - big)
        den = den + lsum * w
        num = num + acc * w[..., None]
    return num / den.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("route,B,L,pos", [
    ("bf16", 8, 700, 650), ("f32", 2, 129, 128), ("bf16", 1, 64, 0),
    ("f32", 3, 300, 200), ("bf16", 8, 2120, 2080), ("bf16", 2, 2120, 191),
    ("bf16", 16, 2120, 2080), ("bf16", 1, 2120, 2111)])
def test_mla_decode_replay_of_parts_and_merge_matches_plain(route, B, L,
                                                            pos):
    """The kernel's tiles (bf16 64 slots, float32 32), its parts (from
    ``mla_plan`` on an H100's 132 SMs, one block an SM, bf16 at most
    ``mla_max_parts`` of the H100's cluster table) and their merge give
    the plain version's answer."""
    ins = [torch.as_tensor(a) for a in _latents(pos, B, 40, 256, 32, L)]
    unit, max_parts = MLA_ROUTES[route]
    if route == "bf16":
        max_parts = DA.mla_max_parts(H100_CLUSTERS, B)
    per_part, n_parts = DA.mla_plan(pos + 1, B, unit, max_parts, 132)
    got = _replay(*ins, pos, 96 ** -0.5, per_part, n_parts,
                  64 if route == "bf16" else 32)
    want = DA.mla_decode_attention_plain(*ins, pos, 96 ** -0.5)
    _close(got, want, 1e-5)


def test_flash_tile_config_of_the_mla_instance():
    """tc::MlaCfg, the (96, 64) instance's own tiling: three consumer
    warpgroups of 64 rows (a 192-row q item), q and k in a 64-column box
    of 128-byte rows and a 32-column box of 64-byte rows (no padding to
    128 columns), v in one 64-column box, four stages, a block within 227
    KB and the register file split by setmaxnreg within 64 K."""
    cfg = FA.tile_config(96, 64)
    assert cfg["BQ"] == 64 * cfg["NWG"] and cfg["THREADS"] == 128 * (
        cfg["NWG"] + 1)
    assert (cfg["QA_BYTES"], cfg["QB_BYTES"]) == (cfg["BQ"] * 128,
                                                  cfg["BQ"] * 64)
    assert (cfg["KA_BYTES"], cfg["KB_BYTES"], cfg["V_BYTES"]) == (
        cfg["BK"] * 128, cfg["BK"] * 64, cfg["BK"] * 128)
    assert cfg["STAGE_BYTES"] == cfg["BK"] * (96 + 64) * 2
    assert cfg["SMEM"] == 1024 + cfg["QA_BYTES"] + cfg["QB_BYTES"] + cfg[
        "NS"] * cfg["STAGE_BYTES"] + cfg["BAR_BYTES"]
    assert cfg["SMEM"] <= 227 * 1024
    assert 128 * (cfg["PRODUCER_REGS"] + cfg["NWG"] * cfg[
        "CONSUMER_REGS"]) <= 65536
    assert (96, 64) in FA.HEAD_DIM_PAIRS
    # the equal-dim instances keep tc::Cfg
    assert FA.tile_config(64)["SMEM"] == 115768


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
    """MLA trains: ``check_trainable`` passes it, every weight of a
    trainable model requires grad, the loss's gradient reaches all seven
    MLA leaves of every layer, and the trainable model still serves the
    logits of a frozen one under ``no_grad``.  What ``check_supported``
    refuses, MLA with a logit softcap, is still refused."""
    _, pcfg = _cfgs()
    check_trainable(pcfg)
    model = Model.from_seed(pcfg, 0, "cpu").trainable()
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, pcfg.vocab_size, (2, 16)))
    h, _ = model.hidden_forward(tokens)
    grads = torch.autograd.grad(h.float().square().mean(),
                                [layer.attn[n] for layer in model.layers
                                 for n in PA.mla_defs(pcfg)])
    assert all(bool(g.isfinite().all()) for g in grads)
    assert all(bool(g.any()) for g in grads)
    with torch.no_grad():
        got, _ = model(tokens)
    want, _ = Model.from_seed(pcfg, 0, "cpu")(tokens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="MLA with a logit"):
        check_trainable(dataclasses.replace(pcfg, attn_logit_softcap=30.0))
