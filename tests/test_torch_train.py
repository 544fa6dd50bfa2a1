"""The port's training slice against the JAX package on the CPU: the
optimizers on a seeded tree, the cross-entropies, the loss, router aux and
every gradient of reduced models under ``jax.value_and_grad`` with the train
state carried across, gradient accumulation, three train steps, the
error-feedback compressor bit for bit, a train step of reduced rwkv6,
jamba (Adafactor, bf16 accumulation) and minicpm3 (MLA, remat full and
dots); and the port's own behaviour: remat modes (RWKV, Mamba and MLA
layers too), what trains and what serves, the data law,
checkpoints (keep, torn writes, a corrupt newest one, dtype casts, bf16),
crash-restart determinism and the runtime-log line.

Inputs are seeded with numpy and handed to both sides; the JAX side runs
as its own tests run it.  Tolerances: float32 on both sides, sums taken in
another order (XLA against PyTorch's CPU kernels), so 1e-5 relative on
scalars and 1e-4 relative (in norm) on gradient leaves and parameters.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.distributed import compression as JC
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro.train.data import make_batch as jax_batch
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import compression as PC
from repro_torch.launch import train as port_train
from repro_torch.modeling.convert import param_paths, train_state_from_jax
from repro_torch.modeling.model import Model
from repro_torch.train import optimizer as PO
from repro_torch.train import train_step as PT
from repro_torch.train.checkpoint import (CheckpointManager,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import make_batch

REL = 1e-4


def _rel(got, want):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-300))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ------------------------------------------------------------- optimizers

TREE = {"a": (8, 16), "b": (3, 4, 5), "c": (7,), "d": (2, 3, 4, 6)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(s) * scale).astype(np.float32)
            for n, s in TREE.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("steps", [1, 3])
def test_optimizer_matches_jax(name, steps):
    """Parameters, state and grad norm after one and three updates of a
    seeded tree (gradient norms above and below the clip of 1)."""
    params = _tree(0)
    grads = [_tree(10 + t, scale=(0.05, 3.0, 0.2)[t]) for t in range(steps)]
    jopt, popt = JO.get_optimizer(name), PO.get_optimizer(name)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    pp = {n: torch.tensor(a) for n, a in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    for g in grads:
        jp, js, jn = jopt.update({n: jnp.asarray(a) for n, a in g.items()},
                                 js, jp)
        _, ps, pn = popt.update({n: torch.tensor(a) for n, a in g.items()},
                                ps, pp)
        assert abs(float(pn) - float(jn)) <= 1e-5 * float(jn)
    for n in TREE:
        assert _rel(_np(pp[n]), jp[n]) <= 1e-5, n
    assert ps["count"] == int(js["count"]) == steps
    if name == "adamw":
        for n in TREE:
            assert _rel(_np(ps["m"][n]), js["m"][n]) <= 1e-5
            assert _rel(_np(ps["v"][n]), js["v"][n]) <= 1e-5
    else:
        for n in TREE:
            for k, a in js["leaves"][n].items():
                assert _rel(_np(ps["leaves"][n][k]), a) <= 1e-5, (n, k)


def test_adamw_keeps_the_parameter_type():
    """bf16 parameters: moments float32, the update in float32 cast back;
    the same bits as the JAX package up to one bf16 rounding."""
    params = _tree(1)
    g = _tree(2, 0.1)
    jopt, popt = JO.adamw(), PO.adamw()
    jp = {n: jnp.asarray(a, jnp.bfloat16) for n, a in params.items()}
    pp = {n: torch.tensor(a).to(torch.bfloat16) for n, a in params.items()}
    jp, js, _ = jopt.update({n: jnp.asarray(a, jnp.bfloat16)
                             for n, a in g.items()}, jopt.init(jp), jp)
    _, ps, _ = popt.update({n: torch.tensor(a).to(torch.bfloat16)
                            for n, a in g.items()}, popt.init(pp), pp)
    for n in TREE:
        assert pp[n].dtype == torch.bfloat16
        assert ps["m"][n].dtype == torch.float32
        np.testing.assert_allclose(_np(pp[n].float()),
                                   np.asarray(jp[n], np.float32),
                                   rtol=2 ** -7, atol=0)


# ---------------------------------------------------------- cross-entropy

def _labels(rng, B, S, V):
    lab = rng.integers(0, V, (B, S))
    lab[rng.random((B, S)) < 0.2] = -1
    return lab


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 16, 50)).astype(np.float32) * 3
    lab = _labels(rng, 2, 16, 50)
    want = JT.cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
    got = PT.cross_entropy(torch.tensor(logits), torch.tensor(lab))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 32)])   # 48: odd shape
def test_chunked_cross_entropy_matches_jax(S, chunk):
    jcfg, pcfg = jax_smoke("gemma3-1b"), smoke_config("gemma3-1b")
    params = JT.init_train_state(jcfg, jax.random.PRNGKey(1))["params"]
    state = train_state_from_jax(pcfg, {
        "params": jax.tree.map(np.asarray, params),
        "opt": {"m": params, "v": params, "count": 0}, "step": 0}, "cpu")
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    lab = _labels(rng, 2, S, jcfg.vocab_size)
    want = JT.chunked_cross_entropy(jcfg, params, jnp.asarray(hidden),
                                    jnp.asarray(lab), chunk)
    got = PT.chunked_cross_entropy(state["model"], torch.tensor(hidden),
                                   torch.tensor(lab), chunk).detach()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


# ------------------------------------------------- loss and every gradient

def _pair(arch, **kw):
    """JAX train state and the port's carried from it."""
    jcfg, pcfg = jax_smoke(arch, **kw), smoke_config(arch, **kw)
    jstate = JT.init_train_state(jcfg, jax.random.PRNGKey(0))
    pstate = train_state_from_jax(pcfg, jax.tree.map(np.asarray, jstate),
                                  "cpu")
    return jcfg, pcfg, jstate, pstate


def _jbatch(cfg, B, S, step=0):
    b = jax_batch(cfg, B, S, step, seed=5)
    return b, {n: torch.tensor(np.asarray(a)).long() for n, a in b.items()}


def _by_name(pcfg, jtree, ref_tree):
    """JAX tree leaves keyed by the port's parameter names, sliced per
    layer."""
    out = {}
    for n, (path, b) in param_paths(pcfg, ref_tree).items():
        a = jtree
        for k in path:
            a = a[k]
        a = np.asarray(a)
        out[n] = a if b is None else a[b]
    return out


@pytest.mark.parametrize("arch,kw", [
    ("gemma3-1b", {"loss_chunk": 16}),
    ("gemma3-1b", {"attn_logit_softcap": 30.0, "final_logit_softcap": 20.0,
                   "loss_chunk": 0}),
    ("olmoe-1b-7b", {"loss_chunk": 16}),       # the router's aux loss
    # S 32 takes the chunked WKV6 (S >= 32, a multiple of 16)
    ("rwkv6-3b", {"loss_chunk": 16}),
    # Mamba's chunk of min(128, S) and the MoE layers' aux loss; the
    # first 4 layers (mamba, mamba + MoE, mamba, attention + MoE), the
    # card's cut, hold every kind of layer
    ("jamba-1.5-large-398b", {"loss_chunk": 16, "n_layers": 4}),
    # MLA: q/k heads of nope + rope, v heads of their own, the seven
    # leaves of every layer
    ("minicpm3-4b", {"loss_chunk": 16}),
])
def test_loss_aux_and_gradients_match_jax(arch, kw):
    jcfg, pcfg, jstate, pstate = _pair(arch, **kw)
    jb, pb = _jbatch(jcfg, 2, 32)
    loss_fn = JT.make_loss_fn(jcfg)
    (jtot, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jstate["params"], jb)
    model = pstate["model"]
    ptot, pm = PT.loss_fn(model, pb)
    params = PT.params_of(model)
    pg = dict(zip(params, torch.autograd.grad(ptot, list(params.values()))))
    assert abs(float(ptot) - float(jtot)) <= 1e-5 * abs(float(jtot))
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert abs(float(pm["aux_loss"]) - float(jm["aux_loss"])) <= \
        1e-5 * max(abs(float(jm["aux_loss"])), 1e-30)
    if jcfg.n_experts:
        assert float(jm["aux_loss"]) > 0
    want = _by_name(pcfg, jg, jstate["params"])
    assert set(want) == set(pg)
    for n, g in pg.items():
        assert _rel(_np(g), want[n]) <= REL, (n, _rel(_np(g), want[n]))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_gradients(remat):
    """Recomputing a layer in the backward changes no number."""
    jcfg, pcfg, jstate, pstate = _pair("gemma3-1b")
    _, pb = _jbatch(jcfg, 2, 24)
    grads = {}
    for mode in ("none", remat):
        model = pstate["model"]
        model.cfg = smoke_config("gemma3-1b", remat=mode)
        for layer in model.layers:
            layer.cfg = model.cfg
        tot, _ = PT.loss_fn(model, pb)
        grads[mode] = torch.autograd.grad(
            tot, list(PT.params_of(model).values()))
    for a, b in zip(grads["none"], grads[remat]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_grad_accum_matches_jax():
    jcfg, pcfg, jstate, pstate = _pair("gemma3-1b", grad_accum=2)
    jb, pb = _jbatch(jcfg, 4, 16)
    jstep = jax.jit(JT.make_train_step(jcfg))
    jnew, jm = jstep(jstate, jb)
    pnew, pm = PT.make_train_step(pcfg)(pstate, pb)
    for k in ("loss", "aux_loss", "grad_norm"):
        assert abs(float(pm[k]) - float(jm[k])) <= \
            1e-5 * max(abs(float(jm[k])), 1e-30), k
    want = _by_name(pcfg, jnew["params"], jstate["params"])
    for n, p in PT.params_of(pnew["model"]).items():
        assert _rel(_np(p), want[n]) <= REL, n


def test_three_train_steps_match_jax():
    """Metrics after each of three steps, each on its own JAX batch, then
    the first moments (linear in the gradients) leaf for leaf and the
    parameters element by element: AdamW moves every element by about lr
    a step whatever its gradient, so an element whose gradient is near
    zero turns float32 noise into a move of a few percent of lr (one norm
    weight of 128 moves 3.9e-6 apart after three steps); the parameters
    are held to 1e-4 relative plus 5% of lr."""
    jcfg, pcfg, jstate, pstate = _pair("gemma3-1b")
    jstep = jax.jit(JT.make_train_step(jcfg))
    pstep = PT.make_train_step(pcfg)
    ref = jstate["params"]
    for step in range(3):
        jb, pb = _jbatch(jcfg, 2, 32, step)
        jstate, jm = jstep(jstate, jb)
        pstate, pm = pstep(pstate, pb)
        for k in ("loss", "grad_norm"):
            assert abs(float(pm[k]) - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])), (step, k)
    assert pstate["step"] == int(jstate["step"]) == 3
    assert pstate["opt"]["count"] == 3
    want = _by_name(pcfg, jstate["params"], ref)
    m = _by_name(pcfg, jstate["opt"]["m"], ref)
    lr = 3e-4                                  # adamw's default
    for n, p in PT.params_of(pstate["model"]).items():
        assert _rel(_np(pstate["opt"]["m"][n]), m[n]) <= REL, n
        np.testing.assert_allclose(_np(p), want[n], rtol=REL,
                                   atol=0.05 * lr, err_msg=n)


def test_train_state_carries_adamw_and_adafactor_state():
    for opt in ("adamw", "adafactor"):
        jcfg, pcfg = (jax_smoke("gemma3-1b", optimizer=opt),
                      smoke_config("gemma3-1b", optimizer=opt))
        jstate = JT.init_train_state(jcfg, jax.random.PRNGKey(2))
        ps = train_state_from_jax(pcfg, jax.tree.map(np.asarray, jstate),
                                  "cpu")
        params = PT.params_of(ps["model"])
        assert all(p.requires_grad for p in params.values())
        fresh = PO.get_optimizer(opt).init(params)
        key = "m" if opt == "adamw" else "leaves"
        assert set(ps["opt"][key]) == set(params)
        for n in params:
            a, b = ps["opt"][key][n], fresh[key][n]
            if opt == "adamw":
                assert a.shape == b.shape and not bool(a.any())
            else:
                assert {k: t.shape for k, t in a.items()} == \
                    {k: t.shape for k, t in b.items()}, n


# -------------------------------------------------------- compression hook

def test_ef_compressor_matches_jax_bit_for_bit():
    rng = np.random.default_rng(7)
    shapes = {"w": (300, 7), "b": (5,), "e": (256,)}
    j_init, j_tf = JC.make_ef_compressor()
    p_init, p_tf = PC.make_ef_compressor()
    js = ps = None
    for step in range(3):
        g = {n: (rng.standard_normal(s) * 10 ** (step - 1)).astype(
            np.float32) for n, s in shapes.items()}
        g["b"][0] = 0.0
        jg = {n: jnp.asarray(a) for n, a in g.items()}
        pg = {n: torch.tensor(a) for n, a in g.items()}
        js = js if js is not None else j_init(jg)
        ps = ps if ps is not None else p_init(pg)
        jh, js = j_tf(jg, js)
        ph, ps = p_tf(pg, ps)
        for n in shapes:
            np.testing.assert_array_equal(_np(ph[n]), np.asarray(jh[n]))
            np.testing.assert_array_equal(_np(ps[n]), np.asarray(js[n]))


def test_compress_decompress_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, 127.0] + [0.0] * 251)
    x_hat, err = PC.compress_decompress(x)
    # scale 1: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> -0
    assert x_hat[:5].tolist() == [0.0, 2.0, 2.0, 0.0, 127.0]
    torch.testing.assert_close(err, x - x_hat)


# ------------------------------------------------------- RWKV and Mamba

@pytest.mark.parametrize("arch,kw", [
    ("rwkv6-3b", {"grad_accum": 2}),
    # jamba's own optimizer and accumulation type
    ("jamba-1.5-large-398b", {"grad_accum": 2, "optimizer": "adafactor",
                              "grad_accum_dtype": "bfloat16",
                              "n_layers": 4}),
    # MLA under both recomputing remat modes, with AdamW
    ("minicpm3-4b", {"grad_accum": 2, "remat": "full"}),
    ("minicpm3-4b", {"grad_accum": 2, "remat": "dots"}),
])
def test_rwkv_and_mamba_train_step_matches_jax(arch, kw):
    """A train step of a reduced rwkv6, jamba and minicpm3 (the chunked
    WKV6 and the Mamba chunk at S 32, MLA's attention, two microbatches)
    from a JAX train state one step
    in, so that ``train_state_from_jax`` carries moments that are not
    zeros (AdamW's m and v, Adafactor's vr, vc and v): the metrics, the
    parameters after the step and the optimizer's state.  jamba
    accumulates in bf16 as its config does, so an accumulated element may
    round one bf16 step apart when the float32 gradients differ in their
    last bits; the second moments are held to 1e-3 and the grad norm (of
    the bf16 sums) to REL, where float32 sums get 1e-5.  Both optimizers
    move an element by lr times a normalised update whatever its
    gradient's size, so a parameter near zero (a bias after two steps)
    carries that noise as a few percent of lr: the parameters are held
    element by element to REL relative plus 5% of lr, as in
    ``test_three_train_steps_match_jax``."""
    jcfg, pcfg = jax_smoke(arch, **kw), smoke_config(arch, **kw)
    jstep = jax.jit(JT.make_train_step(jcfg))
    jstate, _ = jstep(JT.init_train_state(jcfg, jax.random.PRNGKey(0)),
                      _jbatch(jcfg, 4, 32, 0)[0])
    pstate = train_state_from_jax(pcfg, jax.tree.map(np.asarray, jstate),
                                  "cpu")
    jb, pb = _jbatch(jcfg, 4, 32, 1)
    jnew, jm = jstep(jstate, jb)
    pnew, pm = PT.make_train_step(pcfg)(pstate, pb)
    bf16_sums = pcfg.grad_accum_dtype == "bfloat16"
    for key in ("loss", "aux_loss", "grad_norm"):
        tol = REL if key == "grad_norm" and bf16_sums else 1e-5
        assert abs(float(pm[key]) - float(jm[key])) <= \
            tol * max(abs(float(jm[key])), 1e-30), key
    assert pnew["step"] == int(jnew["step"]) == 2
    ref = jstate["params"]
    want = _by_name(pcfg, jnew["params"], ref)
    lr = {"adamw": 3e-4, "adafactor": 1e-2}[pcfg.optimizer]   # defaults
    for n, p in PT.params_of(pnew["model"]).items():
        np.testing.assert_allclose(_np(p), want[n], rtol=REL,
                                   atol=0.05 * lr, err_msg=n)
    if pcfg.optimizer == "adamw":
        m = _by_name(pcfg, jnew["opt"]["m"], ref)
        for n in m:
            assert _rel(_np(pnew["opt"]["m"][n]), m[n]) <= REL, n
    else:
        leaves = pnew["opt"]["leaves"]
        for n, (path, b) in param_paths(pcfg, ref).items():
            js = jnew["opt"]["leaves"]
            for k in path:
                js = js[k]
            if "vr" in js and np.ndim(_np(leaves[n].get("v", 0))) == 1:
                continue     # a stacked vector: factored in JAX only
            for k, a in js.items():
                a = np.asarray(a) if b is None else np.asarray(a)[b]
                assert _rel(_np(leaves[n][k]), a) <= 1e-3, (n, k)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b",
                                  "minicpm3-4b"])
def test_rwkv_and_mamba_are_trainable_and_still_serve(arch):
    """``check_trainable`` refuses only what ``check_supported`` refuses:
    RWKV, Mamba and MLA layers train, and a trainable model still serves
    under ``no_grad``, with the logits of a frozen one."""
    cfg = smoke_config(arch)
    state = PT.init_train_state(cfg, 0, "cpu")
    model = state["model"]
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (1, 32)))
    with torch.no_grad():
        got, _ = model.hidden_forward(tokens)
    want, _ = Model.from_seed(cfg, 0, "cpu").hidden_forward(tokens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("arch,kw", [("rwkv6-3b", {}),
                                     ("jamba-1.5-large-398b", {"n_layers": 4}),
                                     ("minicpm3-4b", {})])
def test_remat_recomputes_rwkv_and_mamba_layers(arch, kw):
    """remat "full" and "dots" give an RWKV, Mamba or MLA layer's gradients
    of remat "none" (the chunked WKV6 and the Mamba chunk at S 32; MLA's
    einsums, which "dots" keeps as bmm outputs)."""
    jcfg, pcfg, jstate, pstate = _pair(arch, **kw)
    _, pb = _jbatch(jcfg, 2, 32)
    grads = {}
    for mode in ("none", "full", "dots"):
        model = pstate["model"]
        model.cfg = smoke_config(arch, remat=mode, **kw)
        for layer in model.layers:
            layer.cfg = model.cfg
        tot, _ = PT.loss_fn(model, pb)
        grads[mode] = torch.autograd.grad(
            tot, list(PT.params_of(model).values()))
    for mode in ("full", "dots"):
        for a, b in zip(grads["none"], grads[mode]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_training_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.run("gemma3-1b", 1, 2, 16)


# ------------------------------------------------------------------- data

def test_make_batch_is_a_pure_function_with_the_reference_law():
    cfg = smoke_config("gemma3-1b")
    a = make_batch(cfg, 8, 256, 3, seed=1)
    assert torch.equal(a["tokens"], make_batch(cfg, 8, 256, 3, seed=1)
                       ["tokens"])
    assert not torch.equal(a["tokens"], make_batch(cfg, 8, 256, 4, seed=1)
                           ["tokens"])
    assert not torch.equal(a["tokens"], make_batch(cfg, 8, 256, 3, seed=2)
                           ["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].dtype == torch.int64
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512
    # the structured successor's share: 0.35 of the drawn successors, seen
    # where the token before was not replaced itself (0.35 x 0.65), plus
    # unigram draws that equal it; the JAX package's batches read the same
    def share(tok, lab):
        t = torch.cat([tok, lab[:, -1:]], 1)
        hits = [(t[:, :-1] * 31 + s + 7) % 512 == t[:, 1:] for s in range(17)]
        return float(torch.stack(hits).any(0).float().mean())
    jb = {n: torch.tensor(np.asarray(x)).long() for n, x in
          jax_batch(jax_smoke("gemma3-1b"), 8, 256, 3, seed=1).items()}
    got, want = share(a["tokens"], a["labels"]), share(jb["tokens"],
                                                        jb["labels"])
    assert 0.2 < got < 0.32 and abs(got - want) < 0.03, (got, want)
    t = torch.cat([a["tokens"], a["labels"][:, -1:]], 1)
    # Zipf: token 0 the most frequent of the unigram draws
    counts = torch.bincount(t.reshape(-1), minlength=512)
    assert int(counts.argmax()) == 0


def test_make_batch_refuses_frontends():
    with pytest.raises(NotImplementedError):
        make_batch(smoke_config("internvl2-2b"), 2, 16, 0)


# ------------------------------------------------------------ checkpoints

def test_checkpoint_keep_and_torn_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.arange(8.0), "b": torch.zeros(3), "n": 5}
    for s in (2, 4, 6):
        mgr.save(s, tree)
    assert mgr.latest_step() == 6
    assert len(mgr._steps()) == 2                      # keep=2 enforced
    os.makedirs(str(tmp_path / "step_00000099"))       # torn: no manifest
    assert mgr.latest_step() == 6
    restored, step = mgr.maybe_restore(tree)
    assert step == 6 and restored["n"] == 5
    assert torch.equal(restored["w"], tree["w"])


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"w": torch.ones(4)})
    mgr.save(2, {"w": torch.full((4,), 2.0)})
    with open(tmp_path / "step_00000002" / "shards.npz", "wb") as f:
        f.write(b"not a zip")
    restored, step = mgr.maybe_restore({"w": torch.zeros(4)})
    assert step == 1 and torch.equal(restored["w"], torch.ones(4))


def test_restore_casts_dtype_and_keeps_bf16_bits(tmp_path):
    w = torch.randn(16, generator=torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), 1, {"w": w, "h": w.bfloat16()})
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["dtypes"] == ["float32", "bfloat16"]
    out, step = restore_checkpoint(path, {"w": torch.zeros(16).bfloat16(),
                                          "h": torch.zeros(16).bfloat16()})
    assert step == 1 and out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], w.bfloat16())
    assert torch.equal(out["h"], w.bfloat16())


def test_crash_restart_is_deterministic(tmp_path):
    kw = dict(steps=6, batch=2, seq=32, ckpt_every=2, device="cpu")
    ref = port_train.run("gemma3-1b", ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(SystemExit, match="simulated crash"):
        port_train.run("gemma3-1b", ckpt_dir=str(tmp_path / "b"),
                       crash_at_step=3, **kw)
    resumed = port_train.run("gemma3-1b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(resumed) == 2                   # steps 4 and 5
    np.testing.assert_allclose(resumed, ref[-2:], rtol=1e-4)
    assert ref[-1] < ref[0]


def test_runtime_log_line(tmp_path):
    log = str(tmp_path / "rt.jsonl")
    losses = port_train.run("gemma3-1b", 3, 2, 16, device="cpu",
                            runtime_log=log, compress_grads=True,
                            n_layers=2)
    with open(log) as f:
        rec = json.loads(f.readline())
    assert set(rec) == {"arch", "smoke", "batch", "seq", "n_devices",
                        "model_axis", "median_step_s", "final_loss",
                        "device"}
    assert rec["arch"] == "gemma3-1b" and rec["device"] == "cpu"
    assert (rec["batch"], rec["seq"], rec["n_devices"]) == (2, 16, 1)
    assert rec["median_step_s"] > 0 and rec["final_loss"] == losses[-1]
    assert all(np.isfinite(losses))
    cut = port_train.runtime_record(
        "gemma3-1b", get_config("gemma3-1b", n_layers=2), False, 8, 4096,
        torch.device("cpu"), [1.0, 2.0, 3.0], 5.0)
    assert cut["n_layers"] == 2 and cut["median_step_s"] == 2.5
