"""The port's engine against the JAX package's: leave-one-out selection,
holdout validation, grid scoring, dispatch counters and device handling.

The selection data is a seeded grep-like job (scale-out, dataset size,
keyword ratio) on which no fold's GBM fit reaches a split decided by
float32 noise (R3 in ROADMAP.md §3), so every model's CV statistics are
held to 1e-4.
"""
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.models.api import get_model as ref_model
from repro.core.predictor import evaluate_split as ref_evaluate_split
from repro.workloads.spark_emul import generate_price_book as ref_book_of
from repro_torch.core import engine
from repro_torch.core.models.api import get_model
from repro_torch.core.models.gbm import GBM_SPEC
from repro_torch.core.predictor import C3OPredictor, evaluate_split
from repro_torch.workloads.spark_emul import generate_price_book

POOL = ["ernest", "gbm", "bom", "ogb", "linreg"]


def _job(n, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.choice([2, 4, 6, 8, 10, 12], n).astype(float)
    z = rng.choice([5.0, 10.0, 15.0, 20.0], n)
    c = rng.uniform(0.01, 0.1, n).round(3)
    y = (z / s * (1 + 5 * c) + 0.1 * s + 0.5) * rng.lognormal(0, 0.05, n)
    return np.stack([s, z, c], 1), y


def _padded(X, y):
    n = len(y)
    b = ref_engine.bucket_rows(n)
    Xp = np.zeros((b, X.shape[1]))
    Xp[:n] = X
    yp = np.ones(b)
    yp[:n] = y
    w = np.zeros(b)
    w[:n] = 1.0
    return Xp, yp, w


@pytest.mark.parametrize("pad", [False, True])
def test_cv_select_matches_reference(pad):
    n = 24
    X, y = _job(n)
    folds = np.arange(n)
    w = None
    if pad:
        X, y, w = _padded(X, y)
    want = ref_engine.cv_select([ref_model(k) for k in POOL], X, y, folds,
                                row_weight=w)
    got = engine.cv_select([get_model(k) for k in POOL], X, y, folds,
                           row_weight=w, device="cpu")
    assert got[0] == want[0]
    for k in POOL:
        assert abs(got[1][k] - want[1][k]) <= 1e-4, k
    assert abs(got[2] - want[2]) <= 1e-4
    assert abs(got[3] - want[3]) <= 1e-4


@pytest.mark.parametrize("weighted", [False, True])
def test_holdout_errors_match_reference(weighted):
    X, y = _job(40)
    # one suspect contributor's rows at half weight: sums of 0.5 are exact
    # in float32 in any order, so no split meets R3 (ROADMAP.md §3)
    rw = np.r_[np.ones(20), np.full(10, 0.5)] if weighted else None
    want = ref_engine.holdout_errors([ref_model(k) for k in POOL], X[:30],
                                     y[:30], X[30:], y[30:], row_weight=rw)
    got = engine.holdout_errors([get_model(k) for k in POOL], X[:30], y[:30],
                                X[30:], y[30:], row_weight=rw, device="cpu")
    assert set(got) == set(want)
    for k in POOL:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)


def test_evaluate_split_matches_reference():
    X, y = _job(40)
    names = ("ernest", "bom", "linreg")
    want = ref_evaluate_split(names, X[:30], y[:30], X[30:], y[30:])
    got = evaluate_split(names, X[:30], y[:30], X[30:], y[30:],
                         device="cpu")
    assert got["c3o_selected"] == want["c3o_selected"]
    for k in (*names, "c3o"):
        assert abs(got[k] - want[k]) <= 1e-4, k


def test_grid_rows_and_buckets_match_reference():
    ctx = np.asarray([[18.0, 0.02], [3.0, 0.5], [7.5, 0.1]])
    np.testing.assert_array_equal(engine.grid_rows([2, 4, 8], ctx),
                                  ref_engine.grid_rows([2, 4, 8], ctx))
    for n in (1, 32, 33, 1000):
        assert engine.bucket_rows(n) == ref_engine.bucket_rows(n)


class _Stub:
    """A predictor whose runtime is a fixed function of the row."""

    def __init__(self, a):
        self.a = a

    def predict(self, rows):
        rows = np.asarray(rows, np.float64)
        return self.a * rows[:, 1] / rows[:, 0] + 3.0 - rows[:, 0] * 0.5


def test_machine_and_placement_grids_match_reference():
    preds = {"m5.xlarge": _Stub(100.0), "c5.xlarge": _Stub(80.0)}
    prices = {"m5.xlarge": 0.2, "c5.xlarge": 0.17}
    ctx = np.asarray([[18.0, 0.02], [3.0, 0.5]])
    S = [2, 4, 8, 12]
    for a, b in zip(engine.machine_grid_costs(preds, prices, S, ctx),
                    ref_engine.machine_grid_costs(preds, prices, S, ctx)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    book = generate_price_book(seed=0)
    ref_book = ref_book_of(seed=0)
    got = engine.placement_grid_costs(preds, book, S, ctx)
    want = ref_engine.placement_grid_costs(preds, ref_book, S, ctx)
    assert got[0] == want[0]
    assert [(p.zone, p.option) for p in got[1]] == \
        [(p.zone, p.option) for p in want[1]]
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_cpu_predict_never_reaches_the_kernel(monkeypatch):
    from repro_torch.kernels import gbm_predict as K

    def boom(*a, **k):
        raise AssertionError("kernel wrapper called on the CPU")

    monkeypatch.setattr(K, "gbm_predict", boom)
    X, y = _job(24)
    aux = GBM_SPEC.make_aux(X, torch.device("cpu"))
    params = engine.fit(GBM_SPEC, X, y, np.ones(len(y)), aux, "cpu")
    out = engine.predict(GBM_SPEC, params, X, aux, "cpu")
    want = K.gbm_predict_plain(torch.as_tensor(X, dtype=torch.float32),
                               params.feat[0], params.thr[0], params.leaf[0],
                               params.f0, params.y_scale)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_dispatch_counters_and_warm_start():
    X, y = _job(24)
    engine.cache_clear()
    pred = C3OPredictor(device="cpu").fit(X, y)
    stats = engine.cache_stats()
    assert stats["cv"] == 4 and stats["fit"] == 1
    state = pred.export_state()
    engine.cache_clear()
    warm = C3OPredictor.from_state(state, X, device="cpu")
    np.testing.assert_array_equal(warm.predict(X), pred.predict(X))
    stats = engine.cache_stats()
    assert stats["fit"] == 0 and stats["cv"] == 0 and stats["predict"] == 2


def test_cuda_is_the_default_device():
    """Nothing quietly picks the CPU: without a card, the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works here")
    X, y = _job(24)
    with pytest.raises(RuntimeError, match="CUDA"):
        C3OPredictor().fit(X, y)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.holdout_errors([get_model("ernest")], X[:20], y[:20], X[20:],
                              y[20:])
