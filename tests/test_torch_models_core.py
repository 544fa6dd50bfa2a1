"""``tests/test_models_core.py``'s seven cases on the port's runtime models
(paper §V), on the CPU: the same seeded data (one module-scoped generator
drawn in the same order), the same fits and the same bounds."""
import numpy as np
import pytest
import torch

from repro_torch.core.models.api import FittedModel, get_model
from repro_torch.core.models.ernest import ernest_fit, ernest_predict

CPU = torch.device("cpu")


def _mape(pred, y):
    return float(np.mean(np.abs(pred - y) / np.abs(y)))


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _fit(name, X, y):
    return FittedModel(get_model(name), X, y, device="cpu")


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_gbm_recovers_nonlinear(rng):
    X = rng.uniform(0, 10, (300, 3))
    y = 50 + 10 * X[:, 0] + 5 * np.sin(X[:, 1]) + 0.5 * X[:, 2] ** 2
    assert _mape(_fit("gbm", X, y).predict(X), y) < 0.05


def test_gbm_weighted_excludes_samples(rng):
    """w=0 rows must not influence the fit (the LOO-CV mechanism)."""
    X = rng.uniform(0, 10, (80, 2))
    y = 10 + 3 * X[:, 0] + X[:, 1]
    y_poison = y.copy()
    y_poison[:20] = 1e6
    w = np.ones(80)
    w[:20] = 0.0
    spec = get_model("gbm")
    aux = spec.make_aux(X, CPU)
    params = spec.fit(_f32(X), _f32(y_poison), _f32(w)[None], aux)
    pred = spec.predict(params, _f32(X[20:]), aux)[0].numpy()
    assert _mape(pred, y[20:]) < 0.1


def test_ernest_nnls_nonnegative_and_fits(rng):
    s = rng.choice([2, 4, 8, 16], 60).astype(float)
    z = rng.uniform(10, 30, 60)
    y = 20 + 5 * z / s + 12 * np.log(s) + 0.8 * s
    X = np.stack([s, z], 1)
    p = ernest_fit(_f32(X), _f32(y), torch.ones(1, 60))
    assert bool((p.theta >= 0).all())
    assert _mape(ernest_predict(p, _f32(X))[0].numpy(), y) < 0.05


def test_ernest_ignores_context_features(rng):
    s = rng.choice([2, 4, 8], 120).astype(float)
    z = rng.uniform(10, 20, 120)
    k = rng.choice([1.0, 8.0], 120)
    y = k * (10 + 40 * z / s)
    X3 = np.stack([s, z, k], 1)
    assert _mape(_fit("ernest", X3, y).predict(X3), y) > 0.3
    assert _mape(_fit("gbm", X3, y).predict(X3), y) < 0.1


def test_optimistic_factorization(rng):
    s = np.tile([1, 2, 4, 8, 16], 20).astype(float)
    ctx = np.repeat(rng.uniform(1, 5, 20), 5)
    g = 1.0 / s + 0.05 * s
    y = (30 + 20 * ctx) * g / (1.0 / 1 + 0.05)
    X = np.stack([s, ctx], 1)
    assert _mape(_fit("bom", X, y).predict(X), y) < 0.12


def test_ogb_factorization(rng):
    s = np.tile([1, 2, 4, 8], 25).astype(float)
    ctx = np.repeat(rng.uniform(1, 5, 25), 4)
    y = (30 + 20 * ctx) * (1.0 / s + 0.05 * s) / 1.05
    X = np.stack([s, ctx], 1)
    assert _mape(_fit("ogb", X, y).predict(X), y) < 0.12


def test_bom_degrades_without_scaleout_groups(rng):
    n = 8
    s = rng.choice([2, 4, 8, 16], n).astype(float)
    ctx = np.arange(n).astype(float)
    y = (10 + 5 * ctx) * (8.0 / s)
    m = _fit("bom", np.stack([s, ctx], 1), y)
    test_s = np.stack([np.full(4, 32.0), np.arange(4).astype(float)], 1)
    t_true = (10 + 5 * test_s[:, 1]) * (8.0 / 32)
    assert _mape(m.predict(test_s), t_true) > 0.3
