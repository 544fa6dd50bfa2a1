"""The port's LM serving slice against the JAX package on the CPU: weights
carried from a JAX parameter tree, the forward pass in train and prefill
mode, teacher-forced decode through the KV caches (the ring buffer of the
local layers included, and minicpm3's MLA latent caches), greedy
generation, the seeded init's distributions, and the serve driver's
runtime-log line.

Reduced same-family configs (``smoke_config``: float32, a few layers,
narrow widths) run on both sides with the same weights: the JAX tree from
``init_params``, carried by ``params_from_jax``.  Tolerances: 1e-4 on
logits of magnitude ~1, for float32 sums taken in another order (observed
differences are below 1e-6).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.launch import serve as jax_serve
from repro.modeling import model as M
from repro.serve.serve_step import (greedy_generate as jax_generate,
                                    make_decode_step, make_prefill_step)
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as port_serve
from repro_torch.modeling.convert import params_from_jax
from repro_torch.modeling.model import Model, init_params
from repro_torch.serve.serve_step import greedy_generate

TOL = 1e-4
VARIANTS = {                   # id -> (arch, overrides)
    "gemma3-1b": ("gemma3-1b", {}),
    "gemma3-1b-softcap": ("gemma3-1b", {"attn_logit_softcap": 50.0}),
    "gemma2-2b": ("gemma2-2b", {}),
    "deepseek-7b": ("deepseek-7b", {}),
    "minicpm3-4b": ("minicpm3-4b", {}),
}


def _pair(variant, **extra):
    arch, kw = VARIANTS[variant]
    kw = {**kw, **extra}
    jcfg, pcfg = jax_smoke(arch, **kw), smoke_config(arch, **kw)
    params = M.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(pcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return _pair(request.param)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def test_params_from_jax_places_every_layer():
    """Layer i = block b, slot j (i = b * period + j) or tail slot j."""
    jcfg, params, model = _pair("gemma3-1b", n_layers=8)
    period, nb = jcfg.pattern_period, jcfg.n_scan_blocks
    assert (period, nb, jcfg.n_tail_layers) == (6, 1, 2)
    for i, layer in enumerate(model.layers):
        if i < nb * period:
            src = jax.tree.map(lambda a: np.asarray(a)[i // period],
                               params["blocks"][f"l{i % period}"])
        else:
            src = params["tail"][f"l{i - nb * period}"]
        assert layer.kind == jcfg.layer_kind(i)
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(layer.attn[name].numpy(),
                                          np.asarray(src["attn"][name]))
        for name in ("w_up", "w_down"):
            np.testing.assert_array_equal(layer.ffn[name].numpy(),
                                          np.asarray(src["ffn"][name]))
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["embed"]))


def test_forward_train_matches_jax(pair):
    jcfg, params, model = pair
    toks = _tokens(jcfg, 2, 40)
    want, _, _ = M.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                           mode="train")
    with torch.inference_mode():
        got, _ = model(torch.as_tensor(toks), mode="train")
    assert got.shape == want.shape
    _close(got, want)


def _jax_cache_layers(jcfg, cache):
    """The JAX cache tree as one dict per layer: {"k", "v"}, or MLA's
    {"ckv", "krope"}."""
    period, nb = jcfg.pattern_period, jcfg.n_scan_blocks
    out = []
    for i in range(jcfg.n_layers):
        if i < nb * period:
            c = cache["blocks"][f"l{i % period}"]["attn"]
            out.append({n: np.asarray(c[n])[i // period] for n in c})
        else:
            c = cache["tail"][f"l{i - nb * period}"]["attn"]
            out.append({n: np.asarray(c[n]) for n in c})
    return out


@pytest.mark.parametrize("prompt", [12, 30])
def test_prefill_logits_and_caches_match_jax(pair, prompt):
    """Prefill shorter and longer than the smoke window (16): the local
    layers' caches hold the same rows, in ring layout past the window."""
    jcfg, params, model = pair
    toks = _tokens(jcfg, 2, prompt, seed=1)
    cache = M.init_cache(jcfg, 2, 48)
    want, cache = jax.jit(make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(toks)}, cache)
    with torch.inference_mode():
        pcache = model.init_cache(2, 48)
        got, pcache = model(torch.as_tensor(toks), mode="prefill",
                            cache=pcache)
    assert got.shape == (2, 1, jcfg.padded_vocab_size)
    _close(got[:, -1], want)
    for i, (pc, jc) in enumerate(zip(pcache, _jax_cache_layers(jcfg,
                                                                cache))):
        assert set(pc) == set(jc), i
        for n in jc:
            assert pc[n].shape == jc[n].shape, (i, n)
            _close(pc[n], jc[n])


def test_teacher_forced_decode_matches_jax(pair):
    """Prefill 20 tokens (past the window), then decode 12 more one at a
    time: every step's logits as JAX's decode step gives them."""
    jcfg, params, model = pair
    toks = _tokens(jcfg, 2, 32, seed=2)
    cache = M.init_cache(jcfg, 2, 48)
    _, cache = jax.jit(make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(toks[:, :20])}, cache)
    decode = jax.jit(make_decode_step(jcfg))
    with torch.inference_mode():
        pcache = model.init_cache(2, 48)
        model(torch.as_tensor(toks[:, :20]), mode="prefill", cache=pcache)
        for i in range(20, 32):
            want, cache = decode(params, jnp.asarray(toks[:, i]),
                                 jnp.asarray(i, jnp.int32), cache)
            got, _ = model(torch.as_tensor(toks[:, i:i + 1]), mode="decode",
                           pos0=i, cache=pcache)
            _close(got[:, 0], want)


@pytest.mark.parametrize("variant", ["gemma3-1b", "gemma3-1b-softcap"])
def test_ring_buffer_long_decode_matches_jax_forward(variant):
    """The twin of tests/test_arch_smoke.py::test_gemma3_ring_buffer_long_
    decode: window 8, a 4-token prefill, then decode far past the window;
    each step's logits equal JAX's full forward pass at that position."""
    jcfg, params, model = _pair(variant, window_size=8)
    toks = _tokens(jcfg, 1, 28, seed=5)
    full, _, _ = M.forward(jcfg, params, {"tokens": jnp.asarray(toks)},
                           mode="train")
    with torch.inference_mode():
        cache = model.init_cache(1, 32)
        assert cache[0]["k"].shape[1] == 8          # the local layers' ring
        model(torch.as_tensor(toks[:, :4]), mode="prefill", cache=cache)
        for i in range(4, 28):
            got, _ = model(torch.as_tensor(toks[:, i:i + 1]), mode="decode",
                           pos0=i, cache=cache)
            _close(got[:, 0], np.asarray(full)[:, i])


def test_greedy_generate_matches_jax(pair):
    jcfg, params, model = pair
    prompt = _tokens(jcfg, 2, 20, seed=3)
    want = jax_generate(jcfg, params, jnp.asarray(prompt), 10, 40)
    got = greedy_generate(model, torch.as_tensor(prompt), 10, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seeded_init_has_materialize_distributions():
    """Per leaf: zeros where JAX has zeros, and standard deviations within
    3% of the JAX init's (a scanned-block leaf counts its stacked axis in
    its fan-in, a tail leaf does not)."""
    arch_kw = dict(n_layers=8, d_model=256, d_ff=512)
    jcfg = jax_smoke("gemma3-1b", **arch_kw)
    pcfg = smoke_config("gemma3-1b", **arch_kw)
    jmodel = params_from_jax(pcfg, jax.tree.map(
        np.asarray, M.init_params(jcfg, jax.random.PRNGKey(0))), "cpu")
    port = init_params(pcfg, 0, "cpu")
    assert port["embed"].dtype == torch.float32
    np.testing.assert_allclose(port["embed"].std().item(),
                               jmodel.embed.std().item(), rtol=0.03)
    for i, layer in enumerate(jmodel.layers):
        p = port["layers"][i]
        for group in ("attn", "ffn"):
            for name, want in getattr(layer, group).items():
                got = p[group][name]
                assert got.shape == want.shape, (i, name)
                np.testing.assert_allclose(got.std().item(),
                                           want.std().item(), rtol=0.03,
                                           err_msg=f"layer {i} {name}")
        for name, want in layer.norms.items():
            assert torch.equal(p[name], want)
    a, b = init_params(pcfg, 0, "cpu"), init_params(pcfg, 1, "cpu")
    assert torch.equal(a["embed"], port["embed"])
    assert not torch.equal(a["embed"], b["embed"])


@pytest.mark.parametrize("arch,kw", [
    ("seamless-m4t-medium", {}), ("internvl2-2b", {}),
    ("gemma3-1b", {"kv_cache_dtype": "int8"})])
def test_what_the_slice_does_not_cover_raises(arch, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Model.from_seed(smoke_config(arch, **kw), 0, "cpu")


def test_serve_run_on_cpu_writes_the_runtime_log_line(tmp_path):
    """The driver serves a batch on the CPU and appends the same runtime-log
    record as the JAX driver."""
    port_log, jax_log = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    out = port_serve.run("gemma3-1b", 2, 20, 5, runtime_log=str(port_log),
                         device="cpu")
    assert out.shape == (2, 5) and out.dtype == torch.int64
    jax_serve.run("gemma3-1b", 2, 20, 5, runtime_log=str(jax_log))
    got = json.loads(port_log.read_text().splitlines()[-1])
    want = json.loads(jax_log.read_text().splitlines()[-1])
    assert set(got) == set(want)
    for k in ("arch", "mode", "batch", "prompt_len"):
        assert got[k] == want[k]
    assert got["prefill_s"] > 0 and got["decode_median_s"] > 0
