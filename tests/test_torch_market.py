"""The port's interruption math (``repro_torch.core.market``) with fault R1
fixed: the JAX package's ``expected_completion_time_s`` returns NaN or inf
at subnormal interruption rates, where ``1/lam`` overflows while
``expm1(lam*t)`` underflows.  The port computes, with x = lam*t_h,
``t_h*(expm1(x)/x) + r_h*expm1(x)`` (expm1(x)/x = 1 at x = 0), and agrees
with the reference wherever the reference is finite.
"""
import numpy as np
import pytest

from repro.core import market as ref_market
from repro_torch.core import market

SUBNORMAL = [5e-324, 2.2250738585e-313]


def test_matches_reference_where_reference_is_finite():
    rng = np.random.default_rng(0)
    t = rng.uniform(1.0, 50_000.0, 400)
    rate = np.concatenate([[0.0, 1e-12, 1e-6], rng.uniform(0.0, 50.0, 397)])
    overhead = rng.uniform(0.0, 3600.0, 400)
    for oh in (0.0, 120.0, float(overhead[0])):
        want = ref_market.expected_completion_time_s(t, rate, oh)
        got = market.expected_completion_time_s(t, rate, oh)
        assert np.all(np.isfinite(want))
        np.testing.assert_allclose(got, want, rtol=1e-12)
        np.testing.assert_allclose(
            market.expected_cost_usd(t, 0.2, 4, rate, oh),
            ref_market.expected_cost_usd(t, 0.2, 4, rate, oh), rtol=1e-12)


@pytest.mark.parametrize("rate", SUBNORMAL)
@pytest.mark.parametrize("t,overhead", [(1.0, 0.0), (1800.0, 120.0),
                                        (50_000.0, 3600.0)])
def test_subnormal_rate_gives_runtime(rate, t, overhead):
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        ref = float(ref_market.expected_completion_time_s(t, rate, overhead))
    assert not np.isfinite(ref)                  # R1 in the reference
    e = float(market.expected_completion_time_s(t, rate, overhead))
    assert np.isfinite(e)
    assert e == pytest.approx(t, rel=1e-12)
    c = float(market.expected_cost_usd(t, 0.2, 4, rate, overhead))
    assert c == pytest.approx(0.2 * (t / 3600.0) * 4, rel=1e-12)


@pytest.mark.parametrize("t,overhead", [(1.0, 0.0), (1800.0, 120.0),
                                        (50_000.0, 3600.0)])
def test_monotone_in_rate_through_subnormals(t, overhead):
    rates = np.asarray([0.0, *SUBNORMAL, 1e-300, 1e-30, 1e-10, 1e-3, 0.1,
                        1.0, 10.0, 50.0, 1e6])
    e = market.expected_completion_time_s(t, rates, overhead)
    assert np.all(np.isfinite(e))
    assert np.all(e >= t * (1 - 1e-12))
    assert np.all(np.diff(e) >= -1e-12 * e[1:])
    c = market.expected_cost_usd(t, 0.2, 4, rates, overhead)
    assert np.all(np.diff(c) >= -1e-12 * c[1:])


def test_subnormal_rates_pass_book_validation_and_stay_finite():
    """A price book that validation accepts with subnormal spot rates gives
    finite expected completion times in the port."""
    book = market.PriceBook(
        {("m5.xlarge", "z1", market.ON_DEMAND): 0.2,
         ("m5.xlarge", "z1", market.SPOT): 0.06,
         ("m5.xlarge", "z2", market.SPOT): 0.07},
        {("z1", market.SPOT): SUBNORMAL[0], ("z2", market.SPOT): SUBNORMAL[1]})
    r = book.rates(book.resolve(None, None))
    t = np.asarray([60.0, 600.0, 6000.0])
    et = market.expected_completion_time_s(t[None, :], r[:, None],
                                           book.restart_overhead_s)
    assert np.all(np.isfinite(et))
    np.testing.assert_allclose(et, np.broadcast_to(t, et.shape), rtol=1e-12)
