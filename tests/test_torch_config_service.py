"""The port's ``AsyncConfigService`` (``repro_torch.serve.config_service``),
the micro-batching shim over one ``ConfigurationService`` through a
``BatchLane``: its answers against the service's own batch answers and
against the JAX package's ``AsyncConfigService`` on the same predictors
(mirroring ``tests/test_service.py``'s async front-end tests)."""
import asyncio

import numpy as np

from repro.core.service import ConfigurationService as RefService
from repro.serve.config_service import AsyncConfigService as RefAsync
from repro_torch.core.service import ConfigurationService
from repro_torch.serve.config_service import AsyncConfigService

SCALEOUTS = [2, 3, 4, 6, 8, 12, 16]


class _FakePredictor:
    """t(s) = a/s + b*s + c with known error stats (numpy, so both
    packages' services score the same numbers)."""

    def __init__(self, a=1000.0, b=5.0, c=50.0, mu=0.0, sigma=10.0):
        self.a, self.b, self.c = a, b, c
        self.mu, self.sigma = mu, sigma

    def predict(self, X):
        s = np.asarray(X)[:, 0]
        return self.a / s + self.b * s + self.c

    def predict_with_error(self, X):
        return self.predict(X), self.mu, self.sigma


def _dominated_setup():
    """Machine A dominates: lowest runtime curve and lowest price."""
    preds = {"A": _FakePredictor(a=1000.0),
             "B": _FakePredictor(a=1000.0),
             "C": _FakePredictor(a=1200.0)}
    prices = {"A": 0.10, "B": 0.20, "C": 0.30}
    return preds, prices


def _assert_same_choice(a, b):
    assert a.machine_type == b.machine_type
    assert a.scale_out == b.scale_out
    assert a.bottleneck == b.bottleneck
    np.testing.assert_allclose(a.predicted_runtime_s, b.predicted_runtime_s)
    np.testing.assert_allclose(a.runtime_bound_s, b.runtime_bound_s)
    np.testing.assert_allclose(a.cost_usd, b.cost_usd)


def _drive(front_cls, svc, contexts, t_maxes, **kw):
    async def drive():
        async with front_cls(svc, **kw) as front:
            got = await asyncio.gather(*[
                front.choose(contexts[i], t_max=t_maxes[i])
                for i in range(len(contexts))])
            return got, front.stats
    return asyncio.run(drive())


def test_async_frontend_matches_sync_the_reference_and_coalesces():
    preds, prices = _dominated_setup()
    svc = ConfigurationService(preds, prices, SCALEOUTS)
    rng = np.random.default_rng(11)
    contexts = rng.uniform(10, 20, (32, 1))
    t_maxes = [None if i % 3 == 0 else float(rng.uniform(250, 800))
               for i in range(32)]
    got, stats = _drive(AsyncConfigService, svc, contexts, t_maxes,
                        max_batch=64)
    tm = np.asarray([np.nan if t is None else t for t in t_maxes])
    for a, b in zip(got, svc.choose_cluster_batch(contexts, t_max=tm)):
        _assert_same_choice(a, b)
    ref, _ = _drive(RefAsync, RefService(preds, prices, SCALEOUTS),
                    contexts, t_maxes, max_batch=64)
    for a, b in zip(got, ref):
        _assert_same_choice(a, b)
    assert stats.requests == 32
    assert stats.batches < 32          # concurrent arrivals shared dispatches
    assert stats.mean_batch > 1.0


def test_async_frontend_rejects_mismatched_width_without_poisoning_batch():
    """With a pinned width a stray-width request is rejected alone at
    enqueue; the concurrent good requests are answered and the lane
    survives for a later request."""
    preds, prices = _dominated_setup()
    svc = ConfigurationService(preds, prices, SCALEOUTS)
    contexts = np.random.default_rng(0).uniform(10, 20, (8, 1))

    async def drive():
        async with AsyncConfigService(svc, max_batch=64, width=1) as front:
            results = await asyncio.gather(
                *([front.choose(contexts[i]) for i in range(4)]
                  + [front.choose(np.asarray([15.0, 2.0]))]  # stray width
                  + [front.choose(contexts[i]) for i in range(4, 8)]),
                return_exceptions=True)
            late = await front.choose(contexts[0], t_max=400.0)
            return results, late

    results, late = asyncio.run(drive())
    bad = [r for r in results if isinstance(r, Exception)]
    assert len(bad) == 1 and isinstance(bad[0], ValueError)
    assert "width" in str(bad[0])
    good = [r for r in results if not isinstance(r, Exception)]
    assert len(good) == 8
    for a, b in zip(good, svc.choose_cluster_batch(contexts)):
        _assert_same_choice(a, b)
    assert late.machine_type == "A"
