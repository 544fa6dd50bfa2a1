"""Contributor trust primitives: reputation ledger + token-bucket quotas.

C3O's collaborative premise — runtime models fit on *shared* historical
data — makes data quality the system's biggest robustness risk (the
research-overview follow-up names trust in shared training data as THE
open problem for collaborative optimization).  This module holds the two
mechanism primitives the trust plane is built from:

``ReputationLedger``
    Persistent per-contributor reputation derived from validation history
    at the ``RuntimeDataStore.contribute`` chokepoint.  Every judged
    contribution records one *outcome* — accepted/rejected plus a quality
    score in [0, 1] derived from the candidate-vs-baseline MAPE margin —
    and reputation is the Beta-mean estimate

        rep = (PRIOR_A + sum(quality)) / (PRIOR_A + PRIOR_B + n_outcomes)

    which starts every contributor at the NEUTRAL point (0.5) and is
    *order-independent* for commutative outcome batches (a pure sum — the
    property suite pins this).  Reputation drives two defenses:

      * ``threshold_scale``: contributors below neutral face a stricter
        §III-C.b acceptance threshold (scaled down toward
        MIN_THRESHOLD_SCALE as reputation approaches 0);
      * ``row_weight``: rows from below-neutral contributors enter
        ``cv_select``/fitting down-weighted (decaying cubically toward
        MIN_ROW_WEIGHT) instead of trusted equally — suspect data
        degrades gracefully out of the models rather than poisoning them
        at full weight.  Validation fits use the SAME weights, so
        already-suspect rows cannot inflate the baseline error and loosen
        the §III-C.b reject limit for the next poison batch.

    High-reputation contributors (>= GRACE_REPUTATION) get graceful
    degradation instead of hard rejection: a failing contribution within
    GRACE_RATIO of the reject limit is still ingested, but records a
    zero-quality outcome, so repeated failures drain the reputation that
    earned the grace (and down-weight the rows already ingested — the
    store's row weights are reputation-derived at fit time, not frozen
    at ingest time).

``TokenBucket``
    Deterministic rate-quota accounting with an injectable clock:
    ``admit(now)`` refills ``rate`` tokens per second up to ``burst`` and
    admits while a token is available.  Under ANY call interleaving the
    number of admissions is bounded by ``burst + rate * elapsed``
    (property-pinned); a skewed or rewinding caller clock can never mint
    tokens because the refill origin only moves forward.

Neither primitive knows about gateways or stores; ``repro.api.auth``
composes buckets into the gateway's token-auth surface and
``RuntimeDataStore`` consumes the ledger at its validation chokepoint.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


class TokenBucket:
    """Token-bucket rate limiter over an explicit clock.

    ``rate`` tokens/second refill up to ``burst`` capacity; each admitted
    request consumes ``cost`` tokens.  The caller supplies ``now`` (any
    monotone-ish float timeline), which keeps the accounting deterministic
    under test and lets one authority drive many buckets off one clock.
    """

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float):
        if not (rate > 0 and burst > 0):
            raise ValueError(f"rate and burst must be positive, got "
                             f"rate={rate!r} burst={burst!r}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)          # a fresh bucket starts full
        self.last: Optional[float] = None   # refill origin (first admit)

    def _refill(self, now: float) -> None:
        if self.last is None:
            self.last = now
        if now > self.last:
            # the origin only moves FORWARD: a caller clock that jumps
            # backward (or repeats a timestamp) refills nothing, so the
            # burst + rate*elapsed admission bound holds under arbitrary
            # interleavings
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
            self.last = now

    def admit(self, now: float, cost: float = 1.0) -> bool:
        """True (and ``cost`` tokens consumed) if the request fits the
        quota at time ``now``; False leaves the bucket unchanged."""
        self._refill(float(now))
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False

    def remaining(self, now: Optional[float] = None) -> float:
        """Tokens currently available (refilled to ``now`` if given)."""
        if now is not None:
            self._refill(float(now))
        return self.tokens


@dataclass
class TrustRecord:
    """Per-contributor validation history (pure sums: commutative)."""
    quality_sum: float = 0.0
    outcomes: int = 0
    accepted: int = 0
    rejected: int = 0


class ReputationLedger:
    """Validation-history reputation for every contributor of one store."""

    #: Beta prior: one pseudo-success + one pseudo-failure, so an unseen
    #: contributor sits exactly at NEUTRAL (threshold scale 1, row
    #: weight 1 — a trust-enabled store treats fresh contributors exactly
    #: like a trust-free store treats everyone)
    PRIOR_A = 1.0
    PRIOR_B = 1.0
    #: the neutral reputation: above it contributors are in good standing
    NEUTRAL = 0.5
    #: floor on the reputation-derived fit weight of a row (rows are
    #: down-weighted, never erased: the data stays auditable in the store)
    MIN_ROW_WEIGHT = 0.2
    #: floor on the acceptance-threshold scale for zero-reputation
    #: contributors (half the normal §III-C.b reject budget)
    MIN_THRESHOLD_SCALE = 0.5
    #: reputation at or above which a failing contribution is eligible for
    #: graceful degradation instead of hard rejection
    GRACE_REPUTATION = 0.75
    #: grace only stretches the reject limit this far — catastrophically
    #: bad data is rejected no matter who measured it
    GRACE_RATIO = 2.0

    FORMAT = 1

    def __init__(self):
        self._records: Dict[str, TrustRecord] = {}
        self._version = 0

    # ------------------------- outcome recording --------------------------
    @property
    def version(self) -> int:
        """Monotonic counter, bumped on every recorded outcome.  Fit and
        service caches key on it: a REJECTED contribution changes no store
        data (no store-version bump) but does change this contributor's
        reputation — and therefore the row weights of their already-stored
        rows at the next fit."""
        return self._version

    def record_outcome(self, contributor: str, accepted: bool,
                       quality: float) -> None:
        """Record one judged contribution.  ``quality`` in [0, 1] is the
        validation margin (see ``quality_of``); the running state is pure
        sums, so any commutative batch of outcomes yields the same
        reputation in any order (up to float associativity)."""
        rec = self._records.setdefault(str(contributor), TrustRecord())
        rec.quality_sum += float(min(max(quality, 0.0), 1.0))
        rec.outcomes += 1
        if accepted:
            rec.accepted += 1
        else:
            rec.rejected += 1
        self._version += 1

    @staticmethod
    def quality_of(baseline_mape: float, candidate_mape: float,
                   limit: float) -> float:
        """Validation margin of an ACCEPTED contribution in [0, 1]:
        1 when the candidate error is at or below the baseline, falling
        linearly to 0 as it approaches the reject limit.  Rejected (and
        grace-accepted) contributions record quality 0 directly."""
        span = max(limit - baseline_mape, 1e-9)
        return float(min(max((limit - candidate_mape) / span, 0.0), 1.0))

    # ------------------------- derived trust state ------------------------
    def __contains__(self, contributor: str) -> bool:
        return str(contributor) in self._records

    def contributors(self) -> Tuple[str, ...]:
        return tuple(sorted(self._records))

    def stats(self, contributor: str) -> TrustRecord:
        rec = self._records.get(str(contributor), TrustRecord())
        return TrustRecord(rec.quality_sum, rec.outcomes, rec.accepted,
                           rec.rejected)

    def reputation(self, contributor: str) -> float:
        rec = self._records.get(str(contributor))
        if rec is None:
            return self.NEUTRAL
        return (self.PRIOR_A + rec.quality_sum) / \
            (self.PRIOR_A + self.PRIOR_B + rec.outcomes)

    def row_weight(self, contributor: str) -> float:
        """Fit weight for this contributor's rows: 1.0 at or above
        neutral, decaying CUBICALLY toward MIN_ROW_WEIGHT as reputation
        falls to 0 — one clearly-bad outcome (reputation ~0.4) already
        cuts a contributor's influence roughly in half, instead of the
        token trim a linear ramp would give.  Weights never exceed 1 —
        good standing earns *equal* trust, not extra leverage over
        everyone else's models."""
        rep = self.reputation(contributor)
        if rep >= self.NEUTRAL:
            return 1.0
        frac = (rep / self.NEUTRAL) ** 3
        return self.MIN_ROW_WEIGHT + (1.0 - self.MIN_ROW_WEIGHT) * frac

    def threshold_scale(self, contributor: str) -> float:
        """Multiplier on the §III-C.b reject limit: 1.0 at or above
        neutral, tightening linearly to MIN_THRESHOLD_SCALE at
        reputation 0 (low-reputation contributors face stricter
        validation)."""
        rep = self.reputation(contributor)
        if rep >= self.NEUTRAL:
            return 1.0
        return self.MIN_THRESHOLD_SCALE + \
            (1.0 - self.MIN_THRESHOLD_SCALE) * (rep / self.NEUTRAL)

    def allows_grace(self, contributor: str) -> bool:
        return self.reputation(contributor) >= self.GRACE_REPUTATION

    # ------------------------- persistence --------------------------------
    def save(self, path: str) -> None:
        """Atomic JSON snapshot (sidecar next to the store TSV)."""
        payload = {"format": self.FORMAT,
                   "contributors": {
                       c: {"quality_sum": r.quality_sum,
                           "outcomes": r.outcomes,
                           "accepted": r.accepted,
                           "rejected": r.rejected}
                       for c, r in sorted(self._records.items())}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ReputationLedger":
        with open(path) as f:
            payload = json.load(f)
        if payload.get("format") != cls.FORMAT:
            raise ValueError(
                f"unsupported reputation-ledger format in {path}: "
                f"{payload.get('format')!r}")
        ledger = cls()
        for c, r in payload["contributors"].items():
            rec = TrustRecord(float(r["quality_sum"]), int(r["outcomes"]),
                              int(r["accepted"]), int(r["rejected"]))
            ledger._records[str(c)] = rec
        return ledger


__all__ = ["TokenBucket", "TrustRecord", "ReputationLedger"]
