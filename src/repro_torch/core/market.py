"""Cloud market plane: spot prices, interruption risk, multi-AZ placement.

C3O selects the cheapest configuration meeting a deadline, but a static
``$ per node-hour`` dict is not how public clouds price: the same machine
type costs differently per availability zone and purchase option, and the
spot discount is paid for with interruption risk.  This module is the
typed market model the selection stack scores against:

``PriceBook``
    Per-(machine type, zone, purchase option) *time-varying* price
    vectors plus per-(zone, option) interruption rates, validated at
    construction — a missing price, a non-positive price, or an unknown
    purchase option is a typed ``MarketError`` (a ``ValueError``
    subclass, so the gateway maps it to a ``bad_request`` envelope), not
    a bare ``KeyError`` mid-score or a negative cost that silently wins
    cheapest-choice selection.

Interruption model
    Interruptions arrive Poisson with rate ``lambda`` per hour; an
    interrupted attempt loses its work and pays a fixed restart overhead
    ``R`` before retrying.  A job needing ``T`` uninterrupted hours then
    completes in expectation in

        E[T_total] = (e^{lambda T} - 1) (1/lambda + R)

    (renewal argument: E = E[min(U, T)] + P(U < T) (R + E) with
    U ~ Exp(lambda)).  ``E`` is exactly ``T`` at rate 0, is monotone
    non-decreasing in the rate, and blows up exponentially in
    ``lambda T`` — which is precisely why long jobs on flaky spot
    capacity must lose to on-demand while short jobs keep the discount.
    ``expected_completion_time_s`` / ``expected_cost_usd`` are the
    vectorized closed forms the engine broadcasts over the whole
    (machine x placement x context x scale-out) grid;
    ``realized_completion_time_s`` draws one seeded realization for the
    evaluation replay's realized-cost scoring.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import numpy as np

#: purchase options a placement can name (the wire vocabulary)
ON_DEMAND = "on_demand"
SPOT = "spot"
PURCHASE_OPTIONS = (ON_DEMAND, SPOT)

#: zone name used by ``PriceBook.flat`` when wrapping a legacy price dict
DEFAULT_ZONE = "default"

#: cap on ``lambda * T`` inside ``expm1``: e^50 ~ 5e21 keeps the expected
#: cost finite (so argmin selection stays well defined) while still making
#: any such placement lose to literally anything else on the grid
_LAMT_MAX = 50.0


class MarketError(ValueError):
    """Typed market-model rejection (missing/invalid price, unknown zone
    or purchase option, empty placement constraint).  A ``ValueError``
    subclass so the gateway's error classification answers it as a
    ``bad_request`` envelope."""


@dataclass(frozen=True)
class Placement:
    """One purchasable location: an availability zone + purchase option."""
    zone: str
    option: str = ON_DEMAND

    def __post_init__(self):
        if self.option not in PURCHASE_OPTIONS:
            raise MarketError(
                f"unknown purchase option {self.option!r} for zone "
                f"{self.zone!r} (valid: {', '.join(PURCHASE_OPTIONS)})")


def validate_prices(prices: Mapping[str, float],
                    machine_types: Iterable[str]) -> None:
    """Require a positive finite $/node-hour price for every machine type.

    Construction-time guard for the legacy flat-dict cost model: a machine
    type absent from the dict used to surface as a bare ``KeyError`` deep
    in grid scoring, and a zero/negative price silently won every
    cheapest-cost selection."""
    for m in machine_types:
        if m not in prices:
            known = ", ".join(sorted(map(repr, prices))) or "none"
            raise MarketError(
                f"no $/node-hour price for machine type {m!r} "
                f"(priced machine types: {known})")
        p = prices[m]
        try:
            p = float(p)
        except (TypeError, ValueError):
            p = math.nan
        if not math.isfinite(p) or p <= 0.0:
            raise MarketError(
                f"invalid price {prices[m]!r} for machine type {m!r}: "
                "every price must be a positive finite $/node-hour")


# ---------------------------- interruption math ----------------------------

def expected_completion_time_s(runtime_s, rate_per_hour,
                               restart_overhead_s: float):
    """E[wall-clock seconds to completion] under Poisson interruptions.

    ``runtime_s`` and ``rate_per_hour`` broadcast (numpy semantics); rate
    0 returns ``runtime_s`` exactly.  Monotone non-decreasing in the rate
    and always >= ``runtime_s``."""
    t = np.asarray(runtime_s, np.float64)
    lam = np.asarray(rate_per_hour, np.float64)
    t_h = t / 3600.0
    r_h = float(restart_overhead_s) / 3600.0
    # Cap the RATE (not the lam*t product) at the overflow guard: capping
    # the product alone would freeze expm1 while 1/lam kept shrinking,
    # making E[t] locally DECREASING in the rate past the cap.  Clamping
    # lam to cap/t keeps the exact formula below the cap and holds E[t]
    # constant above it, preserving monotonicity.
    safe = np.where(lam > 0.0, lam, 1.0)
    lam_cap = np.where(t_h > 0.0,
                       _LAMT_MAX / np.where(t_h > 0.0, t_h, 1.0), np.inf)
    safe = np.minimum(safe, lam_cap)
    # (e^x - 1)(1/lam + R) with x = lam*T, written as T*(expm1(x)/x) +
    # R*expm1(x): at subnormal rates 1/lam overflows to inf while expm1(x)
    # underflows to 0, and their product was NaN; expm1(x)/x -> 1 as
    # x -> 0, so this form stays finite and ~T there
    x = safe * t_h
    em1 = np.expm1(x)
    ratio = np.where(x > 0.0, em1 / np.where(x > 0.0, x, 1.0), 1.0)
    e_h = t_h * ratio + r_h * em1
    return np.where(lam > 0.0, e_h * 3600.0, t)


def expected_cost_usd(runtime_s, price_per_hour, nodes, rate_per_hour,
                      restart_overhead_s: float):
    """Interruption-adjusted expected $ cost: price x E[hours] x nodes."""
    e_s = expected_completion_time_s(runtime_s, rate_per_hour,
                                     restart_overhead_s)
    return np.asarray(price_per_hour, np.float64) * (e_s / 3600.0) \
        * np.asarray(nodes, np.float64)


def realized_completion_time_s(runtime_s: float, rate_per_hour: float,
                               restart_overhead_s: float, rng,
                               max_restarts: int = 100_000) -> float:
    """One seeded realization of the interruption process.

    Draws Exp(rate) interruption times until an attempt survives the full
    ``runtime_s``; every failed attempt contributes its partial progress
    plus the restart overhead.  Expectation over ``rng`` matches
    ``expected_completion_time_s``."""
    t = float(runtime_s)
    rate = float(rate_per_hour)
    if rate <= 0.0 or t <= 0.0:
        return t
    total = 0.0
    mean_gap_s = 3600.0 / rate
    for _ in range(max_restarts):
        u = float(rng.exponential(mean_gap_s))
        if u >= t:
            return total + t
        total += u + float(restart_overhead_s)
    return total + t        # pathological rate: cap the retry loop


# -------------------------------- PriceBook --------------------------------

class PriceBook:
    """Validated per-(machine, zone, purchase option) market state.

    ``prices`` maps ``(machine_type, zone, option)`` to a price *series*
    (a scalar or a 1-D sequence of $/node-hour over ticks); ``tick``
    indexes the current point in time (series shorter than the tick wrap
    around).  ``interruption`` maps ``(zone, option)`` to an hourly
    interruption rate — required for every spot placement, forced to 0
    for on-demand.  Construction validates everything up front:

    * every price finite and > 0 (``MarketError`` otherwise — a zero or
      negative price would win every cheapest-cost selection);
    * dense coverage — every machine priced in every placement the book
      lists (a sparse book would make argmin over the grid ill-posed);
    * every spot placement carries a finite rate >= 0, and no rate names
      a placement the book does not price.

    ``restart_overhead_s`` is the fixed per-interruption restart cost the
    expected-completion model amortizes against predicted runtime.
    """

    def __init__(self, prices: Mapping[Tuple[str, str, str], object],
                 interruption: Optional[Mapping[Tuple[str, str],
                                               float]] = None,
                 *, restart_overhead_s: float = 120.0):
        if not prices:
            raise MarketError("empty price book: no (machine type, zone, "
                              "purchase option) prices given")
        if not (math.isfinite(float(restart_overhead_s))
                and float(restart_overhead_s) >= 0.0):
            raise MarketError(
                f"invalid restart overhead {restart_overhead_s!r}: must be "
                "a finite number of seconds >= 0")
        self.restart_overhead_s = float(restart_overhead_s)
        series: Dict[Tuple[str, str, str], np.ndarray] = {}
        for key, raw in prices.items():
            try:
                m, z, o = key
            except (TypeError, ValueError):
                raise MarketError(
                    f"price key {key!r} is not a (machine type, zone, "
                    "purchase option) triple") from None
            Placement(str(z), str(o))       # validates the option name
            vec = np.atleast_1d(np.asarray(raw, np.float64))
            if vec.ndim != 1 or len(vec) == 0:
                raise MarketError(
                    f"price series for machine {m!r} zone {z!r} option "
                    f"{o!r} must be a scalar or non-empty 1-D sequence")
            if not (np.isfinite(vec).all() and (vec > 0.0).all()):
                raise MarketError(
                    f"invalid price in series for machine {m!r} zone "
                    f"{z!r} option {o!r}: every price must be a positive "
                    "finite $/node-hour")
            series[(str(m), str(z), str(o))] = vec
        self._series = series
        self.machines: Tuple[str, ...] = tuple(
            sorted({k[0] for k in series}))
        self.placements: Tuple[Placement, ...] = tuple(
            Placement(z, o)
            for z, o in sorted({(k[1], k[2]) for k in series}))
        for m in self.machines:             # dense (machine x placement)
            for p in self.placements:
                if (m, p.zone, p.option) not in series:
                    raise MarketError(
                        f"machine type {m!r} has no price for zone "
                        f"{p.zone!r} option {p.option!r}: the book must "
                        "price every machine in every placement it lists")
        rates: Dict[Tuple[str, str], float] = {}
        interruption = dict(interruption or {})
        for key, r in interruption.items():
            try:
                z, o = key
            except (TypeError, ValueError):
                raise MarketError(
                    f"interruption key {key!r} is not a (zone, purchase "
                    "option) pair") from None
            if Placement(str(z), str(o)) not in self.placements:
                raise MarketError(
                    f"interruption rate given for zone {z!r} option "
                    f"{o!r}, but the book prices no such placement")
            r = float(r)
            if not math.isfinite(r) or r < 0.0:
                raise MarketError(
                    f"invalid interruption rate {r!r} for zone {z!r} "
                    f"option {o!r}: must be finite and >= 0 per hour")
            rates[(str(z), str(o))] = r
        for p in self.placements:
            if p.option == ON_DEMAND:
                rates.setdefault((p.zone, p.option), 0.0)
            elif (p.zone, p.option) not in rates:
                raise MarketError(
                    f"no interruption rate for spot placement zone "
                    f"{p.zone!r}: every spot placement must declare one "
                    "(0.0 for never-interrupted capacity)")
        self._rates = rates
        self.n_ticks = max(len(v) for v in series.values())
        self.tick = 0

    # ------------------------- construction helpers -----------------------
    @classmethod
    def flat(cls, prices: Mapping[str, float], zone: str = DEFAULT_ZONE,
             *, restart_overhead_s: float = 120.0) -> "PriceBook":
        """Wrap a legacy ``{machine: $/hour}`` dict as a single-zone,
        on-demand-only, interruption-free book (market scoring then
        reduces exactly to the static cost model)."""
        validate_prices(prices, prices)
        return cls({(m, zone, ON_DEMAND): float(p)
                    for m, p in prices.items()},
                   restart_overhead_s=restart_overhead_s)

    def naive_view(self) -> "PriceBook":
        """Same prices, every interruption rate forced to 0 — the
        cheapest-listed-price baseline the replay scores against."""
        book = PriceBook(dict(self._series),
                         {k: 0.0 for k in self._rates},
                         restart_overhead_s=self.restart_overhead_s)
        book.tick = self.tick
        return book

    # ------------------------------ time ----------------------------------
    def seek(self, tick: int) -> None:
        """Position the book at ``tick`` (series wrap modulo length)."""
        self.tick = int(tick)

    def advance(self, n: int = 1) -> None:
        self.tick += int(n)

    # ----------------------------- lookups --------------------------------
    def resolve(self, zones: Optional[Sequence[str]] = None,
                options: Optional[Sequence[str]] = None
                ) -> Tuple[Placement, ...]:
        """Placements matching the constraints (None = unconstrained).

        Empty constraint sets and names the book does not know are typed
        ``MarketError``s naming the offending zone/option."""
        known_zones = tuple(dict.fromkeys(p.zone for p in self.placements))
        known_opts = tuple(dict.fromkeys(p.option for p in self.placements))
        if zones is not None:
            zones = tuple(str(z) for z in zones)
            if not zones:
                raise MarketError(
                    "empty placement constraint: zones=() matches no "
                    f"placement (known zones: {', '.join(known_zones)})")
            for z in zones:
                if z not in known_zones:
                    raise MarketError(
                        f"unknown zone {z!r} (known zones: "
                        f"{', '.join(known_zones)})")
        if options is not None:
            options = tuple(str(o) for o in options)
            if not options:
                raise MarketError(
                    "empty placement constraint: purchase_options=() "
                    "matches no placement (known options: "
                    f"{', '.join(known_opts)})")
            for o in options:
                if o not in known_opts:
                    raise MarketError(
                        f"unknown purchase option {o!r} (known options: "
                        f"{', '.join(known_opts)})")
        out = tuple(p for p in self.placements
                    if (zones is None or p.zone in zones)
                    and (options is None or p.option in options))
        if not out:
            raise MarketError(
                f"no placement matches zones={zones!r} "
                f"purchase_options={options!r} (the book prices: "
                f"{', '.join(f'{p.zone}/{p.option}' for p in self.placements)})")
        return out

    def _at(self, vec: np.ndarray, tick: Optional[int]) -> float:
        t = self.tick if tick is None else int(tick)
        return float(vec[t % len(vec)])

    def price_of(self, machine: str, zone: str, option: str,
                 tick: Optional[int] = None) -> float:
        """Current listed $/node-hour for one (machine, placement)."""
        vec = self._series.get((machine, zone, option))
        if vec is None:
            priced = ", ".join(map(repr, self.machines))
            raise MarketError(
                f"machine type {machine!r} has no price for zone {zone!r} "
                f"option {option!r} in the market book (priced machine "
                f"types: {priced})")
        return self._at(vec, tick)

    def rate_of(self, zone: str, option: str) -> float:
        """Hourly interruption rate of one placement."""
        r = self._rates.get((zone, option))
        if r is None:
            raise MarketError(
                f"no placement zone {zone!r} option {option!r} in the "
                "market book")
        return r

    def price_matrix(self, machines: Sequence[str],
                     placements: Optional[Sequence[Placement]] = None,
                     tick: Optional[int] = None) -> np.ndarray:
        """[M, P] listed prices at the current (or given) tick."""
        placements = self.placements if placements is None \
            else tuple(placements)
        return np.array(
            [[self.price_of(m, p.zone, p.option, tick) for p in placements]
             for m in machines], np.float64)

    def rates(self, placements: Optional[Sequence[Placement]] = None
              ) -> np.ndarray:
        """[P] hourly interruption rates."""
        placements = self.placements if placements is None \
            else tuple(placements)
        return np.array([self.rate_of(p.zone, p.option)
                         for p in placements], np.float64)

    def validate_machines(self, machines: Iterable[str]) -> None:
        """Construction-time coverage check: every machine priced."""
        for m in machines:
            if (m, self.placements[0].zone,
                    self.placements[0].option) not in self._series:
                priced = ", ".join(map(repr, self.machines)) or "none"
                raise MarketError(
                    f"machine type {m!r} has no price in the market book "
                    f"(priced machine types: {priced})")
