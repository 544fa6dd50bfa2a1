"""The port's RWKV6 serving slice against the JAX package on the CPU: the
time mix and the channel mix on both of the time mix's branches (chunked
for S >= 32 with S % 16 == 0, sequential otherwise, decode included), the
full forward pass, prefill logits and the state caches, teacher-forced
decode, the seeded init's distributions, and the serve driver's
runtime-log line.

``smoke_config("rwkv6-3b", n_layers=2)`` (float32, d 128, 4 heads of 32,
d_ff 256, vocab 512) runs on both sides with the same weights: the JAX
tree from ``init_params``, carried by ``params_from_jax``.  The seeded
tree has zeros for the token-shift mixes and biases and constants for the
decay and the norms' scales, so a "perturbed" variant also adds seeded
noise to every such leaf (on both sides) to exercise them.

Tolerance: 1e-4 (atol and rtol) on float32 outputs and logits of magnitude
~1, for sums taken in another order; observed differences are below 1e-5.
The state sums k v^T over the sequence, so it is held to the same 1e-4
relative to its own size.  The JAX steps are jitted: its uncompiled decode
loop is slow on the CPU.
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
from repro.modeling import model as M
from repro.modeling import rwkv as JR
from repro.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as port_serve
from repro_torch.modeling import rwkv as PR
from repro_torch.modeling.convert import layer_tree, params_from_jax
from repro_torch.modeling.model import Model, RwkvLayer, init_params

TOL = 1e-4
ARCH = "rwkv6-3b"
# leaves the seeded init makes zeros or constants
FLAT_LEAVES = ("maa_x", "maa_rkvwg", "decay", "ln_x_scale", "ln_x_bias",
               "maa_k", "maa_r", "ln1", "ln2")


def _perturb(tree, seed=7):
    """Seeded noise on every zeros/constant leaf (the decay stays in the
    RWKV domain: -4 +- 1)."""
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


def _pair(perturbed=False, **kw):
    jcfg = jax_smoke(ARCH, n_layers=2, **kw)
    pcfg = smoke_config(ARCH, n_layers=2, **kw)
    tree = jax.tree.map(np.asarray,
                        M.init_params(jcfg, jax.random.PRNGKey(0)))
    if perturbed:
        tree = _perturb(tree)
    params = jax.tree.map(jnp.asarray, tree)
    return jcfg, params, params_from_jax(pcfg, tree, device="cpu")


@pytest.fixture(scope="module", params=["seeded", "perturbed"])
def pair(request):
    return _pair(request.param == "perturbed")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _close(got, want, tol=TOL, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=msg)


def _layer0(jcfg, params):
    """Layer 0's JAX sub-tree and the same weights as tensors."""
    jp = layer_tree(jcfg, jax.tree.map(np.asarray, params), 0)
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), jp)
    return jax.tree.map(jnp.asarray, jp), tp


# (S, with a cache): S = 64 is the chunked branch, 20 and 1 sequential
BRANCHES = [(64, False), (64, True), (20, True), (1, True)]


def _mix_inputs(jcfg, S, with_cache, seed):
    rng = np.random.default_rng(seed)
    B, D = 2, jcfg.d_model
    h, hd = JR.n_heads(jcfg), jcfg.rwkv_head_dim
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    if not with_cache:
        return x, None, None
    s = (0.5 * rng.standard_normal((B, h, hd, hd))).astype(np.float32)
    xp = rng.standard_normal((B, D)).astype(np.float32)
    return x, s, xp


@pytest.mark.parametrize("S,with_cache", BRANCHES)
def test_time_mix_matches_jax(pair, S, with_cache):
    jcfg, params, model = pair
    jp, tp = _layer0(jcfg, params)
    x, s, xp = _mix_inputs(jcfg, S, with_cache, seed=S)
    j = (lambda a: None if a is None else jnp.asarray(a))   # noqa: E731
    t = (lambda a: None if a is None else torch.as_tensor(a))  # noqa: E731
    want = JR.rwkv_time_mix(jcfg, jp["tm"], j(x), cache_s=j(s),
                            cache_x=j(xp))
    with torch.inference_mode():
        got = PR.rwkv_time_mix(model.cfg, tp["tm"], t(x), cache_s=t(s),
                               cache_x=t(xp))
    for name, g, w in zip(("out", "state", "x carry"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g, w, msg=name)


@pytest.mark.parametrize("S,with_cache", BRANCHES)
def test_channel_mix_matches_jax(pair, S, with_cache):
    jcfg, params, model = pair
    jp, tp = _layer0(jcfg, params)
    x, _, xp = _mix_inputs(jcfg, S, with_cache, seed=S + 1)
    want = JR.rwkv_channel_mix(jcfg, jp["cm"], jnp.asarray(x),
                               cache_x=None if xp is None else
                               jnp.asarray(xp))
    with torch.inference_mode():
        got = PR.rwkv_channel_mix(model.cfg, tp["cm"], torch.as_tensor(x),
                                  cache_x=None if xp is None else
                                  torch.as_tensor(xp))
    for name, g, w in zip(("out", "x carry"), got, want):
        _close(g, w, msg=name)


def test_params_from_jax_places_every_layer():
    jcfg, params, model = _pair()
    for i, layer in enumerate(model.layers):
        assert isinstance(layer, RwkvLayer)
        src = jax.tree.map(lambda a: np.asarray(a)[i],
                           params["blocks"]["l0"])
        for group in ("tm", "cm"):
            for name, leaf in getattr(layer, group).items():
                np.testing.assert_array_equal(leaf.numpy(),
                                              src[group][name])
        for name in ("ln1", "ln2"):
            np.testing.assert_array_equal(layer.norms[name].numpy(),
                                          src[name])


@pytest.mark.parametrize("S", [64, 40])
def test_forward_train_matches_jax(pair, S):
    """S = 64 runs the chunked branch in every layer, S = 40 the
    sequential one."""
    jcfg, params, model = pair
    toks = _tokens(jcfg, 2, S)
    want, _, _ = M.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                           mode="train")
    with torch.inference_mode():
        got, _ = model(torch.as_tensor(toks), mode="train")
    assert got.shape == want.shape
    _close(got, want)


def _jax_cache_layers(jcfg, cache):
    """The JAX cache tree as one {"s", "x_tm", "x_cm"} per layer."""
    c = cache["blocks"]["l0"]["rwkv"]
    return [{n: np.asarray(c[n])[i] for n in ("s", "x_tm", "x_cm")}
            for i in range(jcfg.n_layers)]


@pytest.mark.parametrize("prompt", [64, 20])
def test_prefill_logits_and_caches_match_jax(pair, prompt):
    jcfg, params, model = pair
    toks = _tokens(jcfg, 2, prompt, seed=1)
    cache = M.init_cache(jcfg, 2, 96)
    want, cache = jax.jit(make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(toks)}, cache)
    with torch.inference_mode():
        pcache = model.init_cache(2, 96)
        got, pcache = model(torch.as_tensor(toks), mode="prefill",
                            cache=pcache)
    assert got.shape == (2, 1, jcfg.padded_vocab_size)
    _close(got[:, -1], want)
    for i, (pc, jc) in enumerate(zip(pcache, _jax_cache_layers(jcfg,
                                                                cache))):
        assert set(pc) == set(jc)
        for n in jc:
            assert pc[n].shape == jc[n].shape, (i, n)
            _close(pc[n], jc[n], msg=f"layer {i} {n}")


def test_teacher_forced_decode_matches_jax(pair):
    """Prefill 32 tokens (chunked), then decode 8 more one at a time
    (sequential): every step's logits as JAX's jitted decode step gives
    them."""
    jcfg, params, model = pair
    toks = _tokens(jcfg, 2, 40, seed=2)
    cache = M.init_cache(jcfg, 2, 48)
    _, cache = jax.jit(make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :32])}, cache)
    decode = jax.jit(make_decode_step(jcfg))
    with torch.inference_mode():
        pcache = model.init_cache(2, 48)
        model(torch.as_tensor(toks[:, :32]), mode="prefill", cache=pcache)
        for i in range(32, 40):
            want, cache = decode(params, jnp.asarray(toks[:, i]),
                                 jnp.asarray(i, jnp.int32), cache)
            got, _ = model(torch.as_tensor(toks[:, i:i + 1]), mode="decode",
                           pos0=i, cache=pcache)
            _close(got[:, 0], want, msg=f"step {i}")


def test_chunked_prefill_equals_token_by_token_decode():
    """The two branches compute one function where the clamp does not
    bite: a 64-token chunked prefill's logits and state against the same
    tokens fed one decode step at a time (the seeded decay -4 gives
    log w = -0.018)."""
    _, _, model = _pair()
    toks = torch.as_tensor(_tokens(model.cfg, 1, 64, seed=4))
    with torch.inference_mode():
        c1, c2 = model.init_cache(1, 64), model.init_cache(1, 64)
        want, _ = model(toks, mode="prefill", cache=c1)
        for i in range(64):
            got, _ = model(toks[:, i:i + 1], mode="decode", pos0=i, cache=c2)
    _close(got[:, 0], want[:, 0])
    for a, b in zip(c1, c2):
        _close(b["s"], a["s"])


def test_bfloat16_activations_keep_the_state_in_bfloat16():
    """With bf16 activations the state is stored in bf16 after every call,
    as the reference stores it (``model.py:165``): prefill and three
    decode steps against JAX in the same types.  Tolerance: 5e-2 relative
    to the logits' norm, chip_smoke.py's limit for bf16 against float32:
    the two frameworks round bf16 activations at different places
    (observed 1.1e-2 to 1.2e-2 at every step)."""
    jcfg, params, model = _pair(dtype="bfloat16")
    toks = _tokens(jcfg, 2, 35, seed=6)
    cache = M.init_cache(jcfg, 2, 40)
    want, cache = jax.jit(make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :32])}, cache)
    decode = jax.jit(make_decode_step(jcfg))
    with torch.inference_mode():
        pcache = model.init_cache(2, 40)
        assert all(c[n].dtype == torch.bfloat16 for c in pcache for n in c)
        got, _ = model(torch.as_tensor(toks[:, :32]), mode="prefill",
                       cache=pcache)
        steps = [(got[:, -1], want)]
        for i in range(32, 35):
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


def _std_tol(n):
    """Four standard errors of a sample standard deviation over n draws."""
    return 4.0 / math.sqrt(2 * n)


def test_seeded_init_has_materialize_distributions():
    """Per leaf: the same zeros and constants as JAX, and for the normal
    leaves the standard deviation ``scale / sqrt(fan_in)`` of
    ``materialize``, where a scanned-block leaf counts the stacked layer
    axis in its fan-in.  Both inits are held to that value within four
    standard errors of their sample size."""
    kw = dict(n_layers=3, d_model=256, d_ff=512)
    jcfg, pcfg = jax_smoke(ARCH, **kw), smoke_config(ARCH, **kw)
    jmodel = params_from_jax(pcfg, jax.tree.map(
        np.asarray, M.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    port = init_params(pcfg, 0, "cpu")
    L = pcfg.n_scan_blocks
    assert L == 3 and pcfg.n_tail_layers == 0
    for group, defs in (("tm", PR.tm_defs(pcfg)), ("cm", PR.cm_defs(pcfg))):
        for name, (shape, kind, scale) in defs.items():
            for i, layer in enumerate(jmodel.layers):
                want = getattr(layer, group)[name]
                got = port["layers"][i][group][name]
                assert got.shape == want.shape == shape, (name, i)
                if kind != "normal":
                    assert torch.equal(got, want), (name, i)
                    continue
                std = scale / math.sqrt(math.prod((L, *shape[:-1])))
                tol = _std_tol(got.numel())
                for who, t in (("port", got), ("jax", want)):
                    np.testing.assert_allclose(
                        t.std().item(), std, rtol=tol,
                        err_msg=f"{who} layer {i} {group}.{name}")
    for i, layer in enumerate(jmodel.layers):
        for name, want in layer.norms.items():
            assert torch.equal(port["layers"][i][name], want)
    assert torch.equal(port["final_norm"], jmodel.final_norm)


def test_serve_run_on_cpu_writes_the_runtime_log_line(tmp_path):
    """The driver serves an RWKV model, whose caches hold no K/V, on the
    CPU and appends the same runtime-log record as the JAX driver."""
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


def test_rwkv_model_construction_checks_what_it_covers():
    """RWKV is covered now; an int8 KV cache on it still raises."""
    cfg = smoke_config(ARCH, n_layers=1)
    assert isinstance(Model.from_seed(cfg, 0, "cpu").layers[0], RwkvLayer)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model.from_seed(dataclasses.replace(cfg, kv_cache_dtype="int8"), 0,
                        "cpu")
