"""Configuration service: joint (machine type, scale-out) selection for
context batches in ONE engine dispatch.

The paper's workflow (§III-§IV) treats machine type and scale-out as one
cluster configuration decision; the two-phase path (``choose_machine_type``
then ``Configurator.choose_scaleout``) approximates it with two separate
calls and cannot see deadline interactions across machines.
``ConfigurationService.choose_cluster_batch`` scores the full
(machine x scale-out x context) grid through ``engine.machine_grid_costs``
— every machine's grid prediction is dispatched before the first host sync,
no per-machine Python-loop syncs — then selects machine and scale-out
simultaneously with vectorized numpy:

    deadline given:  cheapest (m, s) whose runtime bound meets the deadline
                     (clean options first, bottlenecked fallback, then the
                     fastest bound anywhere on the grid);
    no deadline:     cheapest clean (m, s), else cheapest overall.

Per-context deadlines may be a scalar, a [C] array, or NaN entries meaning
"no deadline for this context" — that is what lets the async front-end
(repro.serve.config_service) micro-batch heterogeneous requests into a
single dispatch per tick.

On grids where predicted cost increases with scale-out and one machine
dominates (cheapest at every scale-out), the joint choice coincides with
the composed two-phase path — tests/test_service.py proves that parity
choice-for-choice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import engine
from repro_torch.core.configurator import (ClusterChoice, confidence_margin,
                                     validate_confidence)
from repro_torch.core.market import MarketError, PriceBook, validate_prices


@dataclass
class ConfigurationService:
    """Answers "best (machine type, scale-out) for these contexts under
    these deadlines" over per-machine-type predictors.

    Predictors must expose ``predict``/``predict_device`` plus the CV error
    calibration attributes ``mu``/``sigma`` (``C3OPredictor`` does)."""

    predictors: Dict[str, object]                # machine type -> predictor
    prices: Dict[str, float]                     # $ per node-hour
    scaleouts: Sequence[int]
    confidence: float = 0.95
    # optional bottleneck model: (machine, context_row, scale_out) -> True
    # if the working set misses cluster memory on that machine at that s
    bottleneck_fn: Optional[Callable[[str, np.ndarray, int], bool]] = None
    # optional cloud market (repro_torch.core.market.PriceBook): when set,
    # selection scores the (machine x PLACEMENT x scale-out) grid on
    # interruption-adjusted expected cost and ``prices`` is ignored
    market: Optional[PriceBook] = None

    def __post_init__(self):
        validate_confidence(self.confidence)
        # construction-time price validation: a machine type without a
        # price used to be a bare KeyError mid-score, and a zero/negative
        # price silently won every cheapest-cost selection
        if self.market is not None:
            self.market.validate_machines(self.predictors)
        else:
            validate_prices(self.prices, self.predictors)

    @classmethod
    def from_repo(cls, repo, machine_types: Optional[Sequence[str]],
                  prices: Dict[str, float], scaleouts: Sequence[int],
                  seed: int = 0, **kw) -> "ConfigurationService":
        """Build from a hub JobRepo: one (cached, possibly warm-started)
        predictor per machine type via ``repo.predictor_for``.  With
        ``machine_types=None`` the store's columnar machine vocabulary
        decides — every machine type with shared runtime data gets a
        predictor."""
        if machine_types is None:
            machine_types = repo.store.data.present_machines()
        preds = {m: repo.predictor_for(m, seed=seed) for m in machine_types}
        return cls(preds, prices, scaleouts, **kw)

    # ------------------------- grid scoring -------------------------------
    def score_cluster_grid(self, contexts: np.ndarray):
        """(machine names, t, bound, cost, bottleneck), arrays [M, C, S].

        One engine dispatch: every machine's grid prediction is enqueued
        before the first host sync; runtimes are clamped at >= 0 so a model
        extrapolating negative can never yield a cost that wins selection."""
        contexts = np.atleast_2d(np.asarray(contexts, np.float64))
        names, t, cost = engine.machine_grid_costs(
            self.predictors, self.prices, self.scaleouts, contexts)
        margins = np.asarray([
            confidence_margin(self.confidence,
                              getattr(self.predictors[m], "mu", 0.0),
                              getattr(self.predictors[m], "sigma", 0.0))
            for m in names])
        bound = t + margins[:, None, None]
        if self.bottleneck_fn is not None:
            bott = np.array([[[bool(self.bottleneck_fn(m, ctx, int(s)))
                               for s in self.scaleouts]
                              for ctx in contexts] for m in names])
        else:
            bott = np.zeros(t.shape, bool)
        return names, t, bound, cost, bott

    def score_market_grid(self, contexts: np.ndarray, zones=None,
                          options=None):
        """Market-mode grid: placement is a vectorized axis on the SAME
        fused dispatch (``engine.placement_grid_costs``), not a loop.

        Returns (names, placements, t [M, C, S], then [M, P, C, S]
        arrays: expected completion time, runtime bound, naive listed
        cost, interruption-adjusted expected cost, bottleneck flags).
        The runtime bound rides the interruption-adjusted expected time,
        so flaky spot placements also lose deadline selection."""
        contexts = np.atleast_2d(np.asarray(contexts, np.float64))
        names, placements, t, et, naive, adj = engine.placement_grid_costs(
            self.predictors, self.market, self.scaleouts, contexts,
            zones=zones, options=options)
        margins = np.asarray([
            confidence_margin(self.confidence,
                              getattr(self.predictors[m], "mu", 0.0),
                              getattr(self.predictors[m], "sigma", 0.0))
            for m in names])
        bound = et + margins[:, None, None, None]
        if self.bottleneck_fn is not None:
            bott = np.array([[[bool(self.bottleneck_fn(m, ctx, int(s)))
                               for s in self.scaleouts]
                              for ctx in contexts] for m in names])
        else:
            bott = np.zeros(t.shape, bool)
        bott = np.broadcast_to(bott[:, None], et.shape)
        return names, placements, t, et, bound, naive, adj, bott

    # ------------------------- choice selection ---------------------------
    @staticmethod
    def _select(cf, bf, of, t_max, C):
        """Vectorized [C, K] flat-grid selection shared by the static and
        market paths: cheapest (clean first) meeting the deadline, then
        bottlenecked fallback, then fastest bound; cheapest clean (else
        cheapest) when there is no deadline (NaN entries = per-context
        "no deadline")."""

        def masked_argmin(val, mask):
            return np.where(mask, val, np.inf).argmin(1)

        has_clean = (~of).any(1)
        idx_nd = np.where(has_clean, masked_argmin(cf, ~of), cf.argmin(1))
        if t_max is None:
            return idx_nd
        tm = np.broadcast_to(np.asarray(t_max, np.float64), (C,))
        ok = bf <= tm[:, None]                     # NaN deadline -> all False
        ok_clean = ok & ~of
        idx_dl = np.where(
            ok_clean.any(1), masked_argmin(cf, ok_clean),
            np.where(ok.any(1), masked_argmin(cf, ok), bf.argmin(1)))
        return np.where(np.isnan(tm), idx_nd, idx_dl)

    def choose_cluster_batch(self, contexts: np.ndarray,
                             t_max: Union[None, float, np.ndarray] = None,
                             zones=None, options=None
                             ) -> List[ClusterChoice]:
        """Joint per-context (machine, scale-out) choices, one dispatch.

        ``t_max``: scalar shared deadline, [C] per-context deadlines, or
        None; NaN entries in the array mean "no deadline for this context"
        (those contexts get the cheapest-clean rule).

        With a ``market`` book the grid gains a placement axis and
        selection runs on interruption-adjusted expected cost
        (``zones``/``options`` optionally constrain the placements);
        without one, placement constraints are a typed error."""
        if self.market is not None:
            return self._choose_market(contexts, t_max, zones, options)
        if zones is not None or options is not None:
            raise MarketError(
                "placement constraints (zones / purchase_options) require "
                "a market-enabled service: construct with "
                "market=PriceBook(...)")
        contexts = np.atleast_2d(np.asarray(contexts, np.float64))
        names, t, bound, cost, bott = self.score_cluster_grid(contexts)
        C, S = len(contexts), len(self.scaleouts)
        K = len(names) * S
        # [C, M*S] flat grids, machine-major (ties resolve to the first
        # machine in dict order, matching choose_machine_type)
        tf = np.transpose(t, (1, 0, 2)).reshape(C, K)
        bf = np.transpose(bound, (1, 0, 2)).reshape(C, K)
        cf = np.transpose(cost, (1, 0, 2)).reshape(C, K)
        of = np.transpose(bott, (1, 0, 2)).reshape(C, K)
        idx = self._select(cf, bf, of, t_max, C)
        out = []
        for c, j in enumerate(idx):
            m, s = int(j) // S, int(j) % S
            out.append(ClusterChoice(names[m], int(self.scaleouts[s]),
                                     float(tf[c, j]), float(bf[c, j]),
                                     float(cf[c, j]), bool(of[c, j])))
        return out

    def _choose_market(self, contexts: np.ndarray,
                       t_max: Union[None, float, np.ndarray],
                       zones, options) -> List[ClusterChoice]:
        """Market-mode selection over the flat [C, M*P*S] grid (machine-
        major, then placement, then scale-out — a single-placement flat
        book therefore reproduces the static path index-for-index).
        Cost-ranked on interruption-adjusted expected cost; the reported
        ``cost_usd`` stays the naive listed cost so the envelope carries
        the naive-vs-adjusted breakdown."""
        contexts = np.atleast_2d(np.asarray(contexts, np.float64))
        names, placements, t, et, bound, naive, adj, bott = \
            self.score_market_grid(contexts, zones, options)
        C, S = len(contexts), len(self.scaleouts)
        P = len(placements)
        K = len(names) * P * S
        t4 = np.broadcast_to(t[:, None], et.shape)
        # [C, M*P*S] flat grids ([M, P, C, S] -> [C, M, P, S])
        tf = np.transpose(t4, (2, 0, 1, 3)).reshape(C, K)
        bf = np.transpose(bound, (2, 0, 1, 3)).reshape(C, K)
        nf = np.transpose(naive, (2, 0, 1, 3)).reshape(C, K)
        af = np.transpose(adj, (2, 0, 1, 3)).reshape(C, K)
        of = np.transpose(bott, (2, 0, 1, 3)).reshape(C, K)
        idx = self._select(af, bf, of, t_max, C)
        out = []
        for c, j in enumerate(idx):
            j = int(j)
            m, p, s = j // (P * S), (j // S) % P, j % S
            out.append(ClusterChoice(
                names[m], int(self.scaleouts[s]), float(tf[c, j]),
                float(bf[c, j]), float(nf[c, j]), bool(of[c, j]),
                zone=placements[p].zone,
                purchase_option=placements[p].option,
                expected_cost_usd=float(af[c, j])))
        return out

    def choose_cluster(self, context_row: np.ndarray,
                       t_max: Optional[float] = None) -> ClusterChoice:
        """Single-context convenience wrapper."""
        return self.choose_cluster_batch(np.atleast_2d(context_row),
                                         t_max)[0]
