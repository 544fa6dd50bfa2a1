"""``scripts/paper_figures.py`` (the paper's Table II, Fig. 5 and the
configurator study on the port) against the paper-reproduction
benchmarks' protocol on the JAX package (``benchmarks/common.py``,
``benchmarks/run.py``): the script's copy of the protocol, one Table II
row at 2 splits and the configurator's choices on 5 contexts, both on the
CPU."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from benchmarks import common as RC

ROOT = os.path.join(os.path.dirname(__file__), "..")
TREES = ("gbm", "ogb", "bom")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's fits here are thousands of small tensor ops: one intra-op
    thread runs them faster than a pool that a loaded machine (or other
    test workers) keeps waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def figures():
    spec = importlib.util.spec_from_file_location(
        "paper_figures", os.path.join(ROOT, "scripts", "paper_figures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_scripts_protocol_is_the_benchmarks(figures):
    assert figures.JOBS == RC.JOBS
    assert figures.MODELS == RC.MODELS
    assert figures.TARGET_MACHINE == RC.TARGET_MACHINE
    assert figures.PAPER_TABLE2 == RC.PAPER_TABLE2
    from repro.workloads import spark_emul as RW
    from repro_torch.workloads import spark_emul as W
    for scenario in ("local", "global"):
        ref = RC.scenario_splits(RW.generate_job_data("sgd"), scenario, 3, 5)
        got = figures.scenario_splits(W.generate_job_data("sgd"), scenario,
                                      3, 5)
        for a, b in zip(ref, got):
            for x, y in zip(a, b):
                assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_table2_row_matches_the_reference(figures):
    """grep, local, 2 splits: each model's mean MAPE as
    ``benchmarks.common.run_scenario`` gives it (ernest 1e-5 relative, the
    models with trees and c3o 2e-3)."""
    ref = RC.run_scenario("grep", "local", n_splits=2, max_cv_folds=8)
    got = figures.run_scenario("grep", "local", n_splits=2, max_cv_folds=8,
                               device="cpu")
    assert set(got) == set(ref) == set(RC.MODELS) | {"c3o"}
    for model, want in ref.items():
        tol = 1e-5 if model == "ernest" else 2e-3
        np.testing.assert_allclose(got[model], want, rtol=tol, err_msg=model)


def test_configurator_picks_the_references_scaleouts(figures):
    """The deadline study's first 5 grep contexts: the port's Configurator
    picks the scale-out the JAX package's picks (bench_configurator's
    loop, run here on 5 contexts)."""
    from repro.core.configurator import Configurator as RefConfigurator
    from repro.core.predictor import C3OPredictor as RefPredictor
    from repro.workloads import spark_emul as RW
    n = 5
    got, _ = figures.configurator_choices("grep", np.random.default_rng(0),
                                          n, "cpu")
    rng = np.random.default_rng(0)
    prices = {m.name: m.price for m in RW.MACHINES.values()}
    d = RW.generate_job_data("grep").filter_machine("m5.xlarge")
    conf = RefConfigurator(RefPredictor(max_cv_folds=25).fit(d.X, d.y),
                           "m5.xlarge", prices, list(figures.SCALEOUTS),
                           confidence=0.95)
    for ctx, t_max, scale_out, feasible in got:
        want_ctx = np.asarray((rng.uniform(10, 20),
                               rng.choice([.002, .02, .08])), dtype=float)
        want_t = [RW.true_runtime("grep", "m5.xlarge", s, tuple(want_ctx))
                  for s in figures.SCALEOUTS]
        want_tmax = float(rng.uniform(1.15, 2.0) * min(want_t))
        assert ctx.tobytes() == want_ctx.tobytes()
        assert t_max == want_tmax and feasible == want_t
        assert scale_out == conf.choose_scaleout(want_ctx,
                                                 t_max=want_tmax).scale_out


def test_the_script_refuses_a_missing_card(figures, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --device cpu"):
        figures.main(["--only", "table2"])
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        figures.main(["--only", "table3", "--device", "cpu"])
