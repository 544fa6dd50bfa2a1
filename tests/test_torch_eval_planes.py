"""The port's adversarial, cold-start and spot-market replays against the
JAX package's on small configs, both on the CPU: the same arms, verdicts,
transfer sources and choices (machine, scale-out, zone, purchase option),
costs within 1e-4 relative, and MAPE rows within the replay parity's
tolerances (linear models 1e-5 relative, rows with trees 2e-3)."""
import numpy as np
import pytest
import torch

from repro.eval import adversarial as RA
from repro.eval import replay as RR
from repro_torch.eval import adversarial as A
from repro_torch.eval import replay as R

TREES = ("gbm", "ogb", "bom")
COST_REL = 1e-4

# 3 users at 25% poison: one adversary (user 2, "scale"), the held-out
# honest user 0 and one honest contributor
ADV = dict(jobs=("grep",), n_users=3, poison_fraction=0.25,
           chunks_per_user=1, max_cv_folds=8, model_names=("ernest", "gbm"),
           track_models=("linreg", "gbm"))
COLD = dict(jobs=("grep",), n_users=2, max_cv_folds=8,
            model_names=("ernest", "gbm"))
SPOT = dict(jobs=("grep",), n_queries=4, n_trials=4, max_cv_folds=8,
            model_names=("ernest", "gbm"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's fits here are thousands of small tensor ops: one intra-op
    thread runs them faster than a pool that a loaded machine (or other
    test workers) keeps waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row_tol(record):
    if record["model"] in TREES or record.get("selected") in TREES:
        return 2e-3
    return 1e-5


@pytest.fixture(scope="module")
def adversarial():
    return (RA.run_adversarial(RA.AdversarialConfig(**ADV)),
            A.run_adversarial(A.AdversarialConfig(device="cpu", **ADV)))


def test_adversarial_arms_and_verdicts_match(adversarial):
    ref, got = adversarial
    cfg = A.AdversarialConfig(**ADV)
    assert cfg.poisoners() == RA.AdversarialConfig(**ADV).poisoners() == (2,)
    assert cfg.attack_of(2) == "scale"
    assert (got.contributions, got.accepted) == \
        (ref.contributions, ref.accepted)
    keys = ("weighting", "job", "held_out", "step", "store_rows",
            "rows_contributed", "epoch", "machine", "model", "selected")
    assert len(got.records) == len(ref.records) > 0
    assert {r["weighting"] for r in got.records} == {"off", "on"}
    for a, b in zip(ref.records, got.records):
        assert tuple(a[k] for k in keys) == tuple(b[k] for k in keys)
        for col in ("mape", "mae"):
            assert abs(b[col] - a[col]) <= _row_tol(a) * abs(a[col]), \
                (a, b, col)
    for job, s in ref.summary.items():
        assert got.summary[job]["ok"] == s["ok"]
    lines = got.tsv.splitlines()
    assert lines[0].split("\t") == list(A.ADV_TRAJECTORY_COLUMNS)
    assert len(lines) == len(got.records) + 1


def test_adversarial_cli_and_its_card_default(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --device cpu"):
        A.main(["--users", "3", "--jobs", "grep"])
    assert A.AdversarialConfig().device == "cuda"
    with pytest.raises(ValueError, match="honest"):
        A.replay_job_adversarial("grep", A.AdversarialConfig(
            jobs=("grep",), n_users=2, poison_fraction=0.5, device="cpu"))


@pytest.fixture(scope="module")
def cold():
    return (RR.run_cold_start(RR.ColdStartConfig(**COLD)),
            R.run_cold_start(R.ColdStartConfig(device="cpu", **COLD)))


def test_cold_start_sources_and_errors_match(cold):
    ref, got = cold
    assert len(got.records) == len(ref.records) > 0
    for a, b in zip(ref.records, got.records):
        for k in ("job", "step", "store_rows", "source", "machine", "model"):
            assert a[k] == b[k], (a, b, k)
        np.testing.assert_allclose(b["confidence"], a["confidence"],
                                   rtol=COST_REL)
        tol = 2e-3 if a["model"] == "borrowed" else 1e-12
        for col in ("mape", "mae"):
            assert abs(b[col] - a[col]) <= tol * abs(a[col]), (a, b, col)
    assert {r["source"] for r in got.records if r["model"] == "borrowed"} \
        == {"grep"}
    assert got.summary["grep"]["beats_mean"] == \
        ref.summary["grep"]["beats_mean"]
    assert got.ok == ref.ok
    assert got.tsv.splitlines()[0].split("\t") == list(R.COLD_COLUMNS)


@pytest.fixture(scope="module")
def spot():
    return (RR.run_spot_market(RR.SpotMarketConfig(**SPOT)),
            R.run_spot_market(R.SpotMarketConfig(device="cpu", **SPOT)))


def test_spot_market_choices_and_costs_match(spot):
    ref, got = spot
    assert len(got.records) == len(ref.records) == 2 * SPOT["n_queries"]
    for a, b in zip(ref.records, got.records):
        for k in ("job", "query", "tick", "arm", "machine", "zone", "option",
                  "scale_out"):
            assert a[k] == b[k], (a, b, k)
        for k in ("predicted_s", "true_s", "realized_s", "listed_cost",
                  "expected_cost", "realized_cost"):
            np.testing.assert_allclose(b[k], a[k], rtol=COST_REL,
                                       err_msg=k)
    for job, s in ref.summary.items():
        g = got.summary[job]
        assert (g["ok"], g["diverged"], g["queries"]) == \
            (s["ok"], s["diverged"], s["queries"])
        np.testing.assert_allclose(g["savings"], s["savings"], rtol=COST_REL)
    assert got.ok
    assert got.tsv.splitlines()[0].split("\t") == list(R.SPOT_COLUMNS)
