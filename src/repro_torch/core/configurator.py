"""C3O cluster configurator (paper §IV).

Machine type first (job-dependent, scale-out-independent — maintainer choice
or cheapest-by-prediction fallback), then the scale-out:

    s_hat = min{ s in S | t_s + mu + sqrt(2)*erfinv(2c-1)*sigma <= t_max }

with (mu, sigma) the Gaussian error calibration from the predictor's
cross-validation residuals.  Configurations with an expected hardware
bottleneck (dataset missing cluster memory) are excluded unless nothing else
satisfies the deadline (paper §IV-B).  When no deadline is given, the user is
handed (scale-out, runtime, cost) pairs to choose from.

Candidate scoring goes through the prediction engine (repro_torch.core.engine):
the whole (scale-out x context-batch) grid is evaluated in one predictor
call and choices are selected with vectorized numpy — ``choose_batch``
serves many contexts per dispatch, and ``choose_scaleout`` is its
single-context special case (choice-for-choice identical to the scalar
reference semantics).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy.special import erfinv

from repro_torch.core import engine
from repro_torch.core.market import validate_prices
from repro_torch.core.predictor import C3OPredictor


def confidence_margin(c: float, mu: float, sigma: float) -> float:
    """mu + sqrt(2) * erfinv(2c - 1) * sigma   (c=0.95 -> mu + 1.64485 sigma)."""
    return mu + float(erfinv(2.0 * c - 1.0)) * np.sqrt(2.0) * sigma


def validate_confidence(c: float) -> float:
    """Require 0 < c < 1: ``erfinv(2c-1)`` is ±inf at the endpoints, which
    would make every runtime bound infinite (c=1: every deadline silently
    unsatisfiable, falling through to the fastest-bound path)."""
    if not 0.0 < float(c) < 1.0:
        raise ValueError(
            f"confidence must lie in the open interval (0, 1), got {c!r}: "
            "the erfinv confidence bound is infinite at the endpoints")
    return float(c)


@dataclass(frozen=True)
class ClusterChoice:
    machine_type: str
    scale_out: int
    predicted_runtime_s: float
    runtime_bound_s: float          # runtime + confidence margin
    cost_usd: float                 # listed price * hours * nodes
    bottleneck: bool                # expected memory bottleneck at this s
    # market-aware selection (repro_torch.core.market) stamps WHERE the cluster
    # is bought and what it is expected to really cost once interruption
    # risk is priced in; the static-price path leaves the defaults, so
    # pre-market construction sites (and wire encodings) are unchanged
    zone: str = ""                  # availability zone ("" = no market)
    purchase_option: str = ""       # "on_demand" / "spot" ("" = no market)
    expected_cost_usd: float = 0.0  # interruption-adjusted expected cost


@dataclass
class Configurator:
    predictor: C3OPredictor
    machine_type: str
    prices: Dict[str, float]                     # $ per node-hour
    scaleouts: Sequence[int]
    confidence: float = 0.95                     # paper default
    # optional bottleneck model: (context_row, scale_out) -> True if the
    # working set misses cluster memory at this scale-out
    bottleneck_fn: Optional[Callable[[np.ndarray, int], bool]] = None

    def __post_init__(self):
        validate_confidence(self.confidence)
        # fail at construction, not as a bare KeyError mid-score (and
        # never let a zero/negative price win cheapest-cost selection)
        validate_prices(self.prices, (self.machine_type,))

    # ------------------------- grid scoring -------------------------------
    def _score(self, contexts: np.ndarray):
        """(t, bound, cost, bottleneck) arrays, each [C, S]."""
        contexts = np.atleast_2d(np.asarray(contexts, np.float64))
        t, mu, sigma = engine.score_grid(self.predictor, self.scaleouts,
                                         contexts)
        # a model extrapolating to a negative runtime must not produce a
        # negative cost (which would win the cheapest-choice path)
        t = np.maximum(t, 0.0)
        margin = confidence_margin(self.confidence, mu, sigma)
        S = np.asarray(self.scaleouts, np.float64)
        bound = t + margin
        cost = self.prices[self.machine_type] * (t / 3600.0) * S[None, :]
        if self.bottleneck_fn is not None:
            bott = np.array([[bool(self.bottleneck_fn(ctx, int(s)))
                              for s in self.scaleouts] for ctx in contexts])
        else:
            bott = np.zeros(t.shape, bool)
        return t, bound, cost, bott

    def _choices(self, context_row: np.ndarray) -> List[ClusterChoice]:
        t, bound, cost, bott = self._score(context_row)
        return [ClusterChoice(self.machine_type, int(s), float(t[0, j]),
                              float(bound[0, j]), float(cost[0, j]),
                              bool(bott[0, j]))
                for j, s in enumerate(self.scaleouts)]

    # ------------------------- choice selection ---------------------------
    def choose_batch(self, contexts: np.ndarray,
                     t_max: Union[None, float, np.ndarray] = None
                     ) -> List[ClusterChoice]:
        """Per-context choices for a whole context batch in one dispatch.

        Selection semantics match ``choose_scaleout`` choice-for-choice:
        smallest clean scale-out meeting the deadline with confidence c,
        falling back to bottlenecked options, then to the fastest bound;
        without a deadline, the cheapest clean (else cheapest any) choice.
        ``t_max`` may be a scalar (shared deadline) or a [C] array.
        """
        contexts = np.atleast_2d(np.asarray(contexts, np.float64))
        t, bound, cost, bott = self._score(contexts)
        C = len(contexts)
        S = np.asarray(self.scaleouts, np.float64)[None, :]
        if t_max is None:
            clean_cost = np.where(bott, np.inf, cost)
            has_clean = np.isfinite(clean_cost).any(1)
            idx = np.where(has_clean, clean_cost.argmin(1), cost.argmin(1))
        else:
            tm = np.broadcast_to(np.asarray(t_max, np.float64), (C,))
            ok_any = bound <= tm[:, None]
            ok_clean = ok_any & ~bott
            idx = np.where(
                ok_clean.any(1), np.where(ok_clean, S, np.inf).argmin(1),
                np.where(ok_any.any(1), np.where(ok_any, S, np.inf).argmin(1),
                         bound.argmin(1)))
        return [ClusterChoice(self.machine_type, int(self.scaleouts[j]),
                              float(t[c, j]), float(bound[c, j]),
                              float(cost[c, j]), bool(bott[c, j]))
                for c, j in enumerate(idx)]

    def choose_scaleout(self, context_row: np.ndarray,
                        t_max: Optional[float] = None) -> ClusterChoice:
        """Smallest scale-out meeting the deadline with confidence c.

        Bottlenecked scale-outs are skipped unless no clean option meets the
        deadline; without a deadline, returns the cheapest clean choice."""
        return self.choose_batch(np.atleast_2d(context_row), t_max)[0]

    def runtime_cost_pairs(self, context_row: np.ndarray
                           ) -> List[Tuple[int, float, float]]:
        """(scale-out, predicted runtime, cost) menu (paper §IV-B end)."""
        return [(c.scale_out, c.predicted_runtime_s, c.cost_usd)
                for c in self._choices(context_row)]


def choose_machine_type(predictors: Dict[str, C3OPredictor],
                        prices: Dict[str, float],
                        scaleouts: Sequence[int],
                        context_row: np.ndarray) -> str:
    """Fallback machine-type selection (paper §IV-A): cheapest expected cost
    at each machine's best scale-out, using per-machine-type predictors.

    The full (machine x scale-out) grid is dispatched through the engine
    before the first host sync (one batched predict per machine)."""
    validate_prices(prices, predictors)
    names, _t, cost = engine.machine_grid_costs(predictors, prices,
                                                scaleouts, context_row)
    best = cost[:, 0, :].min(axis=1)            # [M] cheapest per machine
    return names[int(best.argmin())]            # ties: first in dict order
