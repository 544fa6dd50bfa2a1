"""The port's jamba-1.5-large slice against the JAX package on the CPU: the
Mamba layer in train, prefill (one and two of the reference's 128-token
chunks) and decode, with its caches; the MoE FFN against
``moe_apply_dense`` (out and aux), with expert overflow forced; the jamba
model in both parameter layouts (the smoke config's 8 layers are one
scanned block, the 4-layer cut is all tail) through forward, prefill and
teacher-forced decode; the bf16 caches; olmoe-1b-7b's attention + MoE
forward; the seeded init's distributions; and the runtime-log line of
``launch.serve.run``.

``smoke_config`` (float32, d 128, d_inner 256, N 16, dt_rank 8, 4 heads
of 32, 8 experts top-2 of d_ff 64, vocab 512) runs on both sides with the
same weights: the JAX tree from ``init_params``, carried by
``params_from_jax``.  The seeded init makes A_log, dt_bias, D_skip, conv_b
and the norms constant, so the model-level trees add seeded noise to every
such leaf (on both sides) to exercise their layouts.

Tolerance: 1e-4 (rtol, and atol relative to the largest magnitude) on
float32 outputs, logits and states, for sums taken in another order (the
reference's associative scan against the port's sequential one);
observed differences are below 2e-5.  The bf16 test holds logits to 5e-2
relative to their norm, chip_smoke.py's limit for bf16 against float32.
The JAX steps are jitted: its uncompiled decode loop is slow on the CPU.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.modeling import mamba as JM
from repro.modeling import model as M
from repro.modeling import moe as JMoE
from repro.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as port_serve
from repro_torch.modeling import mamba as PM
from repro_torch.modeling import moe as PMoE
from repro_torch.modeling.convert import layer_tree, params_from_jax
from repro_torch.modeling.layers import init_normal
from repro_torch.modeling.model import (DecoderLayer, MambaLayer, Model,
                                        init_params)

TOL = 1e-4
ARCH = "jamba-1.5-large-398b"
LAYOUTS = {"blocks8": {}, "tail4": {"n_layers": 4}}
# leaves the seeded init makes zeros or constants
FLAT_LEAVES = ("A_log", "dt_bias", "D_skip", "conv_b", "ln1", "ln2",
               "final_norm")


def _perturb(tree, seed=7):
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in FLAT_LEAVES:
                a = np.asarray(v)
                out[k] = (a + 0.3 * rng.standard_normal(a.shape)).astype(
                    a.dtype)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


def _pair(arch=ARCH, perturbed=True, **kw):
    jcfg, pcfg = jax_smoke(arch, **kw), smoke_config(arch, **kw)
    tree = jax.tree.map(np.asarray,
                        M.init_params(jcfg, jax.random.PRNGKey(0)))
    if perturbed:
        tree = _perturb(tree)
    params = jax.tree.map(jnp.asarray, tree)
    return jcfg, params, params_from_jax(pcfg, tree, device="cpu")


@pytest.fixture(scope="module", params=list(LAYOUTS))
def pair(request):
    return _pair(**LAYOUTS[request.param])


@pytest.fixture(scope="module")
def layer0():
    """Layer 0 (mamba + dense FFN) of the perturbed smoke model: the JAX
    sub-tree and the same weights as tensors."""
    jcfg, params, model = _pair()
    jp = layer_tree(jcfg, jax.tree.map(np.asarray, params), 0)
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)
    return jcfg, model.cfg, jax.tree.map(jnp.asarray, jp), tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _close(got, want, tol=TOL, msg=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def _mamba_cache(cfg, B, seed):
    rng = np.random.default_rng(seed)
    din = cfg.mamba_d_inner
    return {"h": (0.5 * rng.standard_normal(
                (B, din, cfg.mamba_d_state))).astype(np.float32),
            "conv": rng.standard_normal(
                (B, cfg.mamba_d_conv - 1, din)).astype(np.float32)}


# (mode, S, with a cache): S = 128 is one reference chunk, 256 two, 64 a
# prompt shorter than a chunk
MAMBA_CASES = [("train", 128, False), ("prefill", 64, True),
               ("prefill", 128, True), ("prefill", 256, True),
               ("decode", 1, True)]


@pytest.mark.parametrize("mode,S,with_cache", MAMBA_CASES)
def test_mamba_layer_matches_jax(layer0, mode, S, with_cache):
    jcfg, pcfg, jp, tp = layer0
    x = np.random.default_rng(S).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    cache = _mamba_cache(jcfg, 2, S + 1) if with_cache else None
    want, jc = JM.mamba_apply(
        jcfg, jp["mamba"], jnp.asarray(x), mode=mode,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    pc = None if cache is None else jax.tree.map(torch.as_tensor, cache)
    with torch.inference_mode():
        got = PM.mamba_apply(pcfg, tp["mamba"], torch.as_tensor(x),
                             mode=mode, cache=pc)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, msg="out")
    if with_cache:
        for n in ("h", "conv"):
            _close(pc[n], jc[n], msg=n)


def test_mamba_layer_refuses_what_the_reference_asserts(layer0):
    _, pcfg, _, tp = layer0
    x = torch.zeros(1, 200, pcfg.d_model)      # 200 % 128 != 0
    with pytest.raises(ValueError):
        PM.mamba_apply(pcfg, tp["mamba"], x, mode="prefill", cache=None)
    with pytest.raises(ValueError):            # decode takes one token
        PM.mamba_apply(pcfg, tp["mamba"], x[:, :2], mode="decode",
                       cache=PM.init_mamba_cache(pcfg, 1, torch.float32,
                                                 "cpu"))


def test_causal_conv_tail_is_the_raw_input():
    """The new tail is the last d_conv - 1 rows of the raw input after the
    old tail, also when the input is shorter than the tail."""
    rng = np.random.default_rng(3)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    w, b = randn(4, 8), randn(8)
    for S in (1, 2, 5):
        u, tail = randn(2, S, 8), randn(2, 3, 8)
        yw, tw = JM._causal_conv(*map(jnp.asarray, (u, tail, w, b)))
        yg, tg = PM._causal_conv(*map(torch.as_tensor, (u, tail, w, b)))
        _close(yg, yw)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(tw))


# ------------------------------------------------------------------- MoE

MOE_CASES = {     # id -> (config overrides, router bias on expert 0, B, S)
    "default": ({}, 0.0, 2, 64),
    "overflow": ({"capacity_factor": 0.5}, 3.0, 2, 64),
    "gelu": ({"act": "gelu_mlp"}, 0.0, 2, 32),
    "decode tokens": ({}, 0.0, 4, 1),
    "olmoe": ({}, 0.0, 2, 32),
}


def _moe_case(name):
    kw, bias, B, S = MOE_CASES[name]
    arch = "olmoe-1b-7b" if name == "olmoe" else ARCH
    jcfg, pcfg = jax_smoke(arch, **kw), smoke_config(arch, **kw)
    rng = np.random.default_rng(len(name))
    D, E, F = jcfg.d_model, jcfg.n_experts, jcfg.moe_d_ff
    p = {"router": rng.standard_normal((D, E)) / math.sqrt(D),
         "w_up": rng.standard_normal((E, D, F)) / math.sqrt(D),
         "w_down": rng.standard_normal((E, F, D)) / math.sqrt(F)}
    if jcfg.act == "swiglu":
        p["w_gate"] = rng.standard_normal((E, D, F)) / math.sqrt(D)
    x = rng.standard_normal((B, S, D))
    # a biased router: a constant feature that pushes most tokens to
    # expert 0, past its capacity
    x[..., 0] = 1.0
    p["router"][0, 0] += bias
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return jcfg, pcfg, p, x.astype(np.float32)


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_matches_jax_dense(name):
    jcfg, pcfg, p, x = _moe_case(name)
    want, aux_w = JMoE.moe_apply_dense(
        jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got, aux = PMoE.moe_apply(pcfg, jax.tree.map(torch.as_tensor, p),
                              torch.as_tensor(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, msg="out")
    _close(aux, aux_w, msg="aux")
    if name == "overflow":       # the case must really drop assignments
        T = x.shape[0] * x.shape[1]
        ids, _, _ = PMoE.route(pcfg, torch.as_tensor(p["router"]),
                               torch.as_tensor(x).reshape(T, -1))
        pos = PMoE.queue_positions(ids, pcfg.n_experts)
        assert int((pos >= PMoE.capacity(pcfg, T)).sum()) > T // 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_positions_follow_token_then_k_order(seed):
    """Against the reference's cumsum of one-hots over flattened (t, k):
    different from (k, t) order exactly where an expert overflows."""
    rng = np.random.default_rng(seed)
    T, K, E = 50, 3, 4
    ids = np.stack([rng.choice(E, K, replace=False) for _ in range(T)])
    onehot = np.eye(E, dtype=np.int64)[ids]                   # [T, K, E]
    pos = np.cumsum(onehot.reshape(T * K, E), 0).reshape(T, K, E) - 1
    want = (pos * onehot).sum(-1)
    got = PMoE.queue_positions(torch.as_tensor(ids), E).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ model

def _jax_cache_layers(jcfg, cache):
    """The JAX cache tree as one dict per layer: {"h", "conv"} for a mamba
    layer, {"k", "v"} for an attention layer."""
    period, nb = jcfg.pattern_period, jcfg.n_scan_blocks
    out = []
    for i in range(jcfg.n_layers):
        kind = "mamba" if jcfg.layer_kind(i) == "mamba" else "attn"
        names = ("h", "conv") if kind == "mamba" else ("k", "v")
        if i < nb * period:
            c = cache["blocks"][f"l{i % period}"][kind]
            out.append({n: np.asarray(c[n])[i // period] for n in names})
        else:
            c = cache["tail"][f"l{i - nb * period}"][kind]
            out.append({n: np.asarray(c[n]) for n in names})
    return out


def test_params_from_jax_places_every_layer(pair):
    jcfg, params, model = pair
    tree = jax.tree.map(np.asarray, params)
    for i, layer in enumerate(model.layers):
        src = layer_tree(jcfg, tree, i)
        kind = jcfg.layer_kind(i)
        assert isinstance(layer, MambaLayer if kind == "mamba"
                          else DecoderLayer)
        mixer = layer.mamba if kind == "mamba" else layer.attn
        for name, leaf in mixer.items():
            np.testing.assert_array_equal(
                leaf.numpy(), src["mamba" if kind == "mamba" else "attn"][
                    name])
        if jcfg.is_moe_layer(i):
            assert layer.ffn is None
            for name, leaf in layer.moe.p.items():
                np.testing.assert_array_equal(leaf.numpy(),
                                              src["moe"][name])
        else:
            assert layer.moe is None and "moe" not in src


def test_forward_train_matches_jax(pair):
    jcfg, params, model = pair
    toks = _tokens(jcfg, 2, 128)
    want, _, _ = M.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                           mode="train")
    with torch.inference_mode():
        got, _ = model(torch.as_tensor(toks), mode="train")
    assert got.shape == want.shape
    _close(got, want)


def test_prefill_then_teacher_forced_decode_matches_jax(pair):
    """Prefill 128 tokens (one mamba chunk, flash attention), compare the
    logits and every layer's cache, then decode 6 more one at a time."""
    jcfg, params, model = pair
    toks = _tokens(jcfg, 2, 134, seed=2)
    cache = M.init_cache(jcfg, 2, 144)
    want, cache = jax.jit(make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :128])}, cache)
    decode = jax.jit(make_decode_step(jcfg))
    with torch.inference_mode():
        pcache = model.init_cache(2, 144)
        got, _ = model(torch.as_tensor(toks[:, :128]), mode="prefill",
                       cache=pcache)
        _close(got[:, -1], want, msg="prefill")
        for i, (pc, jc) in enumerate(zip(pcache, _jax_cache_layers(
                jcfg, cache))):
            assert set(jc) <= set(pc)
            for n in jc:
                assert pc[n].shape == jc[n].shape, (i, n)
                _close(pc[n], jc[n], msg=f"layer {i} {n}")
        for i in range(128, 134):
            want, cache = decode(params, jnp.asarray(toks[:, i]),
                                 jnp.asarray(i, jnp.int32), cache)
            got, _ = model(torch.as_tensor(toks[:, i:i + 1]), mode="decode",
                           pos0=i, cache=pcache)
            _close(got[:, 0], want, msg=f"step {i}")


def test_bfloat16_activations_keep_the_caches_in_bfloat16():
    """With bf16 activations the mamba state and conv tail are stored in
    bf16 after every call, as the reference stores them: the 4-layer cut's
    prefill and three decode steps against JAX in the same types."""
    jcfg, params, model = _pair(n_layers=4, dtype="bfloat16")
    toks = _tokens(jcfg, 2, 131, seed=6)
    cache = M.init_cache(jcfg, 2, 136)
    want, cache = jax.jit(make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :128])}, cache)
    decode = jax.jit(make_decode_step(jcfg))
    with torch.inference_mode():
        pcache = model.init_cache(2, 136)
        assert all(c[n].dtype == torch.bfloat16 for c in pcache for n in c)
        got, _ = model(torch.as_tensor(toks[:, :128]), mode="prefill",
                       cache=pcache)
        steps = [(got[:, -1], want)]
        for i in range(128, 131):
            want, cache = decode(params, jnp.asarray(toks[:, i]),
                                 jnp.asarray(i, jnp.int32), cache)
            got, _ = model(torch.as_tensor(toks[:, i:i + 1]), mode="decode",
                           pos0=i, cache=pcache)
            steps.append((got[:, 0], want))
        assert all(c[n].dtype == torch.bfloat16 for c in pcache for n in c)
    for i, (g, w) in enumerate(steps):
        g = g.double().numpy()
        w = np.asarray(w, np.float64)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel < 5e-2, (i, rel)
    for i, (pc, jc) in enumerate(zip(pcache, _jax_cache_layers(jcfg,
                                                                cache))):
        if "h" in jc:
            h, hw = pc["h"].double().numpy(), np.asarray(jc["h"], np.float64)
            assert np.linalg.norm(h - hw) / np.linalg.norm(hw) < 5e-2, i


def test_olmoe_forward_matches_jax():
    """olmoe-1b-7b's attention + MoE layers (every layer MoE) through the
    same code: train forward and a prefill against JAX."""
    jcfg, params, model = _pair("olmoe-1b-7b")
    toks = _tokens(jcfg, 2, 24, seed=4)
    want, _, _ = M.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                           mode="train")
    with torch.inference_mode():
        got, _ = model(torch.as_tensor(toks), mode="train")
    assert all(layer.moe is not None for layer in model.layers)
    _close(got, want)


def _std_tol(n):
    """Four standard errors of a sample standard deviation over n draws."""
    return 4.0 / math.sqrt(2 * n)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_seeded_init_has_materialize_distributions(layout):
    """Per leaf of the mamba and MoE layers: the same zeros and constants
    as JAX, and for the normal leaves the standard deviation ``scale /
    sqrt(fan_in)`` of ``materialize``, where a scanned-block leaf counts
    the stacked layer axis in its fan-in.  Both inits are held to that
    value within four standard errors of their sample size."""
    kw = dict(LAYOUTS[layout], d_model=256, moe_d_ff=128)
    jcfg, pcfg = jax_smoke(ARCH, **kw), smoke_config(ARCH, **kw)
    jmodel = params_from_jax(pcfg, jax.tree.map(
        np.asarray, M.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    port = init_params(pcfg, 0, "cpu")
    L = pcfg.n_scan_blocks
    lead = (L,) if L else ()
    for i, layer in enumerate(jmodel.layers):
        p = port["layers"][i]
        groups = []
        if pcfg.layer_kind(i) == "mamba":
            groups.append(("mamba", layer.mamba, PM.mamba_defs(pcfg)))
        if pcfg.is_moe_layer(i):
            groups.append(("moe", layer.moe.p, {
                n: (s, "normal", 1.0)
                for n, s in PMoE.moe_shapes(pcfg).items()}))
        assert groups or "attn" in p
        for group, jleaves, defs in groups:
            assert set(p[group]) == set(jleaves) == set(defs)
            for name, (shape, kind, scale) in defs.items():
                want, got = jleaves[name], p[group][name]
                assert got.shape == want.shape == shape, (name, i)
                if kind != "normal":
                    assert torch.equal(got, want), (name, i)
                    continue
                std = scale / math.sqrt(math.prod((*lead, *shape[:-1])))
                for who, t in (("port", got), ("jax", want)):
                    np.testing.assert_allclose(
                        t.std().item(), std, rtol=_std_tol(t.numel()),
                        err_msg=f"{who} layer {i} {group}.{name}")


def test_generator_device_draws_the_same_numbers_on_the_cpu():
    """``init_params`` draws from a CPU generator by default, and an
    explicit CPU generator gives the same leaves; ``init_normal`` scales
    its float32 draw in place, which equals scaling a copy."""
    cfg = smoke_config(ARCH, n_layers=4)
    a = init_params(cfg, 3, "cpu")
    b = init_params(cfg, 3, "cpu", gen_device="cpu")
    for la, lb in zip(a["layers"], b["layers"]):
        for group in la:
            if isinstance(la[group], dict):
                for n in la[group]:
                    assert torch.equal(la[group][n], lb[group][n])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = init_normal((64, 32), g1, torch.float32, "cpu", scale=0.5)
    want = torch.randn(64, 32, generator=g2) * (0.5 / math.sqrt(64))
    assert torch.equal(got, want)


def test_serve_run_on_cpu_writes_the_runtime_log_line(tmp_path):
    """``launch.serve.run`` serves jamba (mamba, attention and MoE layers)
    on the CPU and appends the same runtime-log record as the JAX one."""
    port_log, jax_log = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    out = port_serve.run(ARCH, 2, 32, 4, runtime_log=str(port_log),
                         device="cpu")
    assert out.shape == (2, 4) and out.dtype == torch.int64
    jax_serve.run(ARCH, 2, 32, 4, runtime_log=str(jax_log))
    got = json.loads(port_log.read_text().splitlines()[-1])
    want = json.loads(jax_log.read_text().splitlines()[-1])
    assert set(got) == set(want)
    for k in ("arch", "mode", "batch", "prompt_len"):
        assert got[k] == want[k]
    assert got["prefill_s"] > 0 and got["decode_median_s"] > 0
    assert port_serve.CARD_DEPTH[ARCH] == 4


@pytest.mark.parametrize("arch", [ARCH, "gemma3-1b"])
def test_card_config_and_the_record_of_a_depth_cut_run(arch):
    """``card_config`` applies ``CARD_DEPTH`` (and the caller's overrides
    after it); a full-width run whose depth was cut records the depth it
    served beside the JAX driver's keys, an uncut or reduced run records
    exactly the JAX driver's keys."""
    full = get_config(arch)
    cfg = port_serve.card_config(arch)
    cut = port_serve.CARD_DEPTH.get(arch)
    assert cfg.n_layers == (cut or full.n_layers)
    assert cfg.d_model == full.d_model
    assert port_serve.card_config(arch, d_ff=2048).d_ff == 2048
    assert port_serve.card_config(arch, n_layers=2).n_layers == 2
    keys = {"arch", "mode", "batch", "prompt_len", "prefill_s",
            "decode_median_s"}
    rec = port_serve.runtime_record(arch, cfg, False, 8, 2048, 0.4, 0.02)
    assert rec.pop("n_layers", None) == cut
    assert set(rec) == keys and rec["arch"] == arch
    rec = port_serve.runtime_record(arch, smoke_config(arch), True, 2, 32,
                                    0.1, 0.01)
    assert set(rec) == keys


def test_jamba_and_olmoe_construct_and_int8_kv_still_raises():
    cfg = smoke_config(ARCH)
    model = Model.from_seed(cfg, 0, "cpu")
    kinds = [type(layer).__name__ for layer in model.layers]
    assert kinds == ["MambaLayer"] * 3 + ["DecoderLayer"] + \
        ["MambaLayer"] * 4
    assert [layer.moe is not None for layer in model.layers] == \
        [cfg.is_moe_layer(i) for i in range(cfg.n_layers)]
    assert isinstance(Model.from_seed(smoke_config("olmoe-1b-7b"), 0,
                                      "cpu").layers[0].moe, PMoE.MoE)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model.from_seed(dataclasses.replace(cfg, kv_cache_dtype="int8"), 0,
                        "cpu")
