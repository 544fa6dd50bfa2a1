"""Typed request/response envelopes for the Hub Gateway API v1.

Every message is a frozen dataclass built from JSON-serializable scalars
and (nested) tuples only — no numpy arrays, no live objects — so one
envelope value round-trips deterministically through ``repro_torch.api.codec``
and works identically in-process and over a wire.  Conventions:

  * feature rows are tuples of floats with scale-out FIRST (the repo-wide
    feature layout, see ``repro_torch.core.features``);
  * ``ChooseRequest.context`` is the context row WITHOUT scale-out — the
    gateway sweeps the (machine x scale-out) grid for it;
  * a NaN deadline means "no deadline" (the micro-batch lanes pack
    heterogeneous requests into one dispatch that way);
  * operation outcomes that are *answers* (e.g. a rejected contribution)
    travel as ``status="ok"`` results; ``status="error"`` is reserved for
    requests the gateway could not serve (unknown job, malformed payload,
    internal failure) and carries a machine-readable ``error_code``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Generic, Optional, Tuple, TypeVar

API_VERSION = "v1"

#: machine-readable error codes carried by error envelopes
ERR_UNKNOWN_JOB = "unknown_job"
ERR_BAD_REQUEST = "bad_request"
ERR_INTERNAL = "internal"
#: trust plane: request carried no/invalid/revoked token, or the
#: contributor is banned (auth-enabled gateways only)
ERR_UNAUTHORIZED = "unauthorized"
#: trust plane: the contributor's token-bucket rate quota is exhausted
ERR_QUOTA_EXCEEDED = "quota_exceeded"
#: serving: the micro-batch lane's dispatch missed its per-tick deadline
ERR_TIMEOUT = "timeout"
#: serving edge: the front-end is draining for shutdown — in-flight
#: requests finish, new ones are refused with this typed envelope
ERR_SHUTTING_DOWN = "shutting_down"

T = TypeVar("T")


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclass(frozen=True, slots=True)
class PredictRequest:
    """Predict runtimes for explicit feature rows on one machine type."""
    job: str
    machine_type: str
    X: Tuple[Tuple[float, ...], ...]      # [n, d] rows, scale-out first
    seed: Optional[int] = None            # None = gateway's default seed


@dataclass(frozen=True, slots=True)
class ChooseRequest:
    """Best (machine type, scale-out) for one execution context.

    ``zones``/``purchase_options`` constrain market-aware placement on a
    market-enabled gateway (None — and absent on the wire — means
    unconstrained; an empty tuple or an unknown name is a typed
    ``bad_request``)."""
    job: str
    context: Tuple[float, ...]            # context row (no scale-out)
    t_max: float = math.nan               # deadline seconds; NaN = none
    seed: Optional[int] = None            # None = gateway's default seed
    zones: Optional[Tuple[str, ...]] = field(
        default=None, metadata={"omit_default": True})
    purchase_options: Optional[Tuple[str, ...]] = field(
        default=None, metadata={"omit_default": True})


@dataclass(frozen=True, slots=True)
class ContributeRequest:
    """Runtime measurements flowing back to the shared store (workflow
    step 6), stamped with the contributing collaborator's identity."""
    job: str
    machine_type: Tuple[str, ...]         # per-row machine names
    X: Tuple[Tuple[float, ...], ...]      # [n, d] rows, scale-out first
    y: Tuple[float, ...]                  # measured runtimes (seconds)
    contributor_id: str = "unknown"


@dataclass(frozen=True, slots=True)
class ModelErrorsRequest:
    """Held-out (MAPE, MAE) of tracked models + the C3O predictor on
    caller-supplied test rows for one machine type."""
    job: str
    machine_type: str
    X: Tuple[Tuple[float, ...], ...]
    y: Tuple[float, ...]
    track_models: Optional[Tuple[str, ...]] = None
    seed: Optional[int] = None            # None = gateway's default seed


@dataclass(frozen=True, slots=True)
class SearchRequest:
    """Discover published job repos by algorithm/job substring."""
    algorithm: str = ""


@dataclass(frozen=True, slots=True)
class TrustStateRequest:
    """Inspect one contributor's trust state (auth standing, remaining
    quota, per-job reputation) — the admin/inspection surface of the
    trust plane."""
    contributor_id: str


@dataclass(frozen=True, slots=True)
class CompactRequest:
    """Admin op: epoch transition via coverage-aware training-data
    reduction of one job's store (``RuntimeDataStore.compact``).

    On an auth-enabled gateway this is OPERATOR-ONLY: the wrapped
    identity must hold operator standing with the gateway's
    ``TrustAuthority`` — an ordinary contributor token is refused with
    ``unauthorized``.  A compaction the store declines (support floor,
    tiny store, accuracy budget, nothing to remove) is an ``ok`` envelope
    whose result carries ``code="compaction_rejected"`` — a verdict, not
    a transport failure."""
    job: str
    max_rows_per_cell: int = 4
    support_floor: int = 2
    cell_rel_width: float = 0.15
    accuracy_budget: float = 0.01
    min_store_rows: int = 64
    seed: Optional[int] = None            # None = gateway's default seed


@dataclass(frozen=True, slots=True)
class AuthedRequest:
    """Any API v1 request wrapped with a bearer token.

    On an auth-enabled gateway EVERY operation must arrive wrapped; the
    gateway authenticates the token, charges the contributor's rate
    quota, and serves the inner request under the authenticated identity
    (a wrapped ``ContributeRequest``'s ``contributor_id`` is overridden
    by the token's identity — clients cannot spoof provenance).  On an
    unauthenticated gateway (the default) the wrapper is transparently
    unwrapped, so clients can adopt tokens before their hub turns auth
    on."""
    token: str
    request: object                       # one of the request envelopes


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclass(frozen=True, slots=True)
class PredictResult:
    runtimes_s: Tuple[float, ...]
    selected_model: str
    mu: float                             # CV error calibration (paper §IV-B)
    sigma: float
    # cold-start transfer provenance: when the gateway answered from a
    # donor job's fitted models (Flora-style cross-job transfer), which
    # job lent them and at what discounted confidence.  Omitted from the
    # wire for self-served answers (the overwhelmingly common case), so
    # pre-transfer payloads and goldens are byte-identical.
    transfer_source: str = field(default="",
                                 metadata={"omit_default": True})
    transfer_confidence: float = field(default=1.0,
                                       metadata={"omit_default": True})


@dataclass(frozen=True, slots=True)
class ChooseResult:
    """Wire form of ``repro_torch.core.configurator.ClusterChoice``.

    ``transfer_source``/``transfer_confidence`` mark answers served from
    a donor job's models for a cold job (empty/1.0 — and absent on the
    wire — when the job answered for itself).

    Market-enabled gateways additionally stamp the placement the choice
    buys (``zone`` + ``purchase_option``) and the naive-vs-adjusted cost
    breakdown: ``cost_usd`` stays the naive listed-price cost while
    ``expected_cost_usd`` is the interruption-adjusted expected cost the
    selection actually ranked on.  All three default (and are absent on
    the wire) on static-price gateways, so pre-market payloads are
    byte-identical."""
    machine_type: str
    scale_out: int
    predicted_runtime_s: float
    runtime_bound_s: float
    cost_usd: float
    bottleneck: bool
    transfer_source: str = field(default="",
                                 metadata={"omit_default": True})
    transfer_confidence: float = field(default=1.0,
                                       metadata={"omit_default": True})
    zone: str = field(default="", metadata={"omit_default": True})
    purchase_option: str = field(default="",
                                 metadata={"omit_default": True})
    expected_cost_usd: float = field(default=0.0,
                                     metadata={"omit_default": True})

    @classmethod
    def from_choice(cls, choice, transfer_source: str = "",
                    transfer_confidence: float = 1.0) -> "ChooseResult":
        return cls(choice.machine_type, choice.scale_out,
                   choice.predicted_runtime_s, choice.runtime_bound_s,
                   choice.cost_usd, choice.bottleneck,
                   transfer_source, transfer_confidence,
                   getattr(choice, "zone", ""),
                   getattr(choice, "purchase_option", ""),
                   getattr(choice, "expected_cost_usd", 0.0))

    def to_choice(self):
        from repro_torch.core.configurator import ClusterChoice
        return ClusterChoice(self.machine_type, self.scale_out,
                             self.predicted_runtime_s, self.runtime_bound_s,
                             self.cost_usd, self.bottleneck,
                             self.zone, self.purchase_option,
                             self.expected_cost_usd)


@dataclass(frozen=True, slots=True)
class ContributeResult:
    """Validation verdict (paper §III-C.b) plus post-ingest store state."""
    accepted: bool
    baseline_mape: float
    candidate_mape: float
    reason: str
    contributor_id: str
    store_rows: int
    store_version: int
    fingerprint: str


@dataclass(frozen=True, slots=True)
class CompactResult:
    """Compaction verdict plus post-attempt store lifecycle state.

    ``code`` is ``"compacted"`` or ``"compaction_rejected"``; on
    rejection the store is untouched (``store_version``/``fingerprint``
    still name the pre-attempt state and ``epoch`` did not advance)."""
    accepted: bool
    code: str
    reason: str
    rows_before: int
    rows_after: int
    epoch: int
    cells: int
    baseline_mape: float
    candidate_mape: float
    store_version: int
    fingerprint: str


@dataclass(frozen=True, slots=True)
class ModelErrorsResult:
    errors: Tuple[Tuple[str, float, float], ...]   # (model, mape, mae)
    selected_model: str


@dataclass(frozen=True, slots=True)
class JobInfo:
    """One search hit: repo metadata + provenance stats."""
    job: str
    algorithm: str
    rows: int
    machines: Tuple[str, ...]
    models: Tuple[str, ...]
    contributors: Tuple[Tuple[str, int], ...]      # (contributor, rows)
    # store lifecycle (defaults keep pre-epoch payloads decodable)
    epoch: int = 0
    compactions: int = 0
    rows_contributed: int = 0             # lifetime ingested (never shrinks)


@dataclass(frozen=True, slots=True)
class SearchResult:
    jobs: Tuple[JobInfo, ...]


@dataclass(frozen=True, slots=True)
class HealthResult:
    """``GET /healthz`` on the serving edge: liveness plus what the edge
    serves.  ``status`` is ``"ok"`` or ``"draining"`` (shutdown started;
    new work is being refused with ``shutting_down`` envelopes)."""
    status: str
    api_version: str
    jobs: Tuple[str, ...]


@dataclass(frozen=True, slots=True)
class LaneSnapshot:
    """One micro-batch lane's serving counters: dispatched requests,
    ticks, realized mean batch, and latency percentiles (milliseconds,
    enqueue-to-answer, from the lane's bounded reservoir; NaN until the
    lane has dispatched)."""
    lane: str
    requests: int
    batches: int
    mean_batch: float
    p50_ms: float
    p95_ms: float
    p99_ms: float


@dataclass(frozen=True, slots=True)
class StatsResult:
    """``GET /stats`` on the serving edge: HTTP-level request counters
    and latency percentiles (milliseconds, receive-to-response, bounded
    reservoir) plus one ``LaneSnapshot`` per live micro-batch lane —
    choose lanes are named ``job``, predict lanes ``job@machine`` (both
    with a ``#seed=N`` suffix off the default seed)."""
    requests: int
    errors: int
    in_flight: int
    draining: bool
    p50_ms: float
    p95_ms: float
    p99_ms: float
    lanes: Tuple[LaneSnapshot, ...]


@dataclass(frozen=True, slots=True)
class TrustStateResult:
    """One contributor's trust state across the gateway.

    ``reputations`` carries one ``(job, reputation, accepted, rejected)``
    row per job whose store ledger has judged this contributor;
    ``quota_remaining`` is +inf on an unauthenticated gateway (no quota
    accounting)."""
    contributor_id: str
    known: bool                           # has an issued (unrevoked) token
    banned: bool
    quota_remaining: float
    reputations: Tuple[Tuple[str, float, int, int], ...]


# ---------------------------------------------------------------------------
# the uniform envelope
# ---------------------------------------------------------------------------

@dataclass(frozen=True, slots=True)
class Response(Generic[T]):
    """Uniform response envelope: ``status`` is ``"ok"`` (``result`` holds
    the typed payload) or ``"error"`` (``error_code``/``detail`` say why;
    ``result`` is None)."""
    status: str
    result: Optional[T] = None
    error_code: str = ""
    detail: str = ""

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @classmethod
    def success(cls, result: T) -> "Response[T]":
        return cls("ok", result)

    @classmethod
    def failure(cls, error_code: str, detail: str) -> "Response[T]":
        return cls("error", None, error_code, detail)


REQUEST_TYPES = (PredictRequest, ChooseRequest, ContributeRequest,
                 ModelErrorsRequest, SearchRequest, TrustStateRequest,
                 CompactRequest, AuthedRequest)
RESULT_TYPES = (PredictResult, ChooseResult, ContributeResult,
                ModelErrorsResult, JobInfo, SearchResult, TrustStateResult,
                CompactResult, HealthResult, LaneSnapshot, StatsResult)
MESSAGE_TYPES = REQUEST_TYPES + RESULT_TYPES + (Response,)
