"""HubGateway: one routed entry point for the whole C3O workflow.

``HubGateway`` serves the five typed API v1 requests across every
``JobRepo`` published on a ``Hub``, holding per-(job, store-version)
``ConfigurationService`` state so repeated traffic reuses warm predictors
and compiled executables.  Every answer is a uniform ``Response``
envelope; operational failures (unknown job, malformed payload) are error
envelopes, never raised exceptions — a front-end can serialize whatever
comes back.

``AsyncHubGateway`` adds per-job micro-batch lanes: concurrent ``choose``
requests are routed to their job's ``BatchLane`` (``repro_torch.serve``), so a
mixed multi-job request stream coalesces into ONE
``ConfigurationService.choose_cluster_batch`` engine dispatch *per job
per tick* — the single-service micro-batcher generalized to the full hub.

The gateway answers request-for-request identically to the legacy direct
object path (``JobRepo.predictor_for`` / ``choose_cluster_batch`` /
``RuntimeDataStore.contribute`` / ``JobRepo.model_errors``);
``tests/test_torch_gateway.py`` pins that parity against the JAX
package's gateway.
"""
from __future__ import annotations

import asyncio
from collections import OrderedDict
from dataclasses import replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.auth import UNMETERED, TrustAuthority
from repro_torch.api.types import (ERR_BAD_REQUEST, ERR_INTERNAL, ERR_TIMEOUT,
                                   ERR_UNAUTHORIZED, ERR_UNKNOWN_JOB,
                                   AuthedRequest, ChooseRequest, ChooseResult,
                                   CompactRequest, CompactResult,
                                   ContributeRequest, ContributeResult,
                                   JobInfo, ModelErrorsRequest,
                                   ModelErrorsResult, PredictRequest,
                                   PredictResult, Response, SearchRequest,
                                   SearchResult, TrustStateRequest,
                                   TrustStateResult)
from repro_torch.core.features import RuntimeData
from repro_torch.core.market import MarketError, PriceBook
from repro_torch.core.service import ConfigurationService
from repro_torch.core.transfer import TransferPolicy
from repro_torch.serve.config_service import (BatchLane, LaneTimeoutError,
                                              ServeStats)


class UnknownJobError(KeyError):
    """Request named a job no published repo serves."""


class HubGateway:
    """Routes typed API v1 requests across all published job repos.

    ``prices`` ($ per node-hour per machine type) and ``scaleouts`` are
    the serving-time configuration grid shared by every job; they would
    come from the deployment's cloud catalog in production.

    ``auth`` (a ``repro_torch.api.auth.TrustAuthority``) turns the trust plane
    on: EVERY operation must then arrive wrapped in an ``AuthedRequest``
    whose token authenticates an unbanned contributor with quota left —
    admission happens before the request touches any ``JobRepo``, and
    refusals are typed ``unauthorized`` / ``quota_exceeded`` error
    envelopes.  With ``auth=None`` (the default) the gateway stays
    unauthenticated and wrapped requests are transparently unwrapped.
    """

    def __init__(self, hub, prices: Dict[str, float],
                 scaleouts: Sequence[int], *, confidence: float = 0.95,
                 seed: int = 0, auth: Optional[TrustAuthority] = None,
                 transfer: Optional[TransferPolicy] = None,
                 market: Optional[PriceBook] = None):
        self.hub = hub
        self.auth = auth
        # cloud market plane (repro_torch.core.market): with a PriceBook set,
        # choose scores a (machine x zone x purchase-option x scale-out)
        # grid on interruption-adjusted expected cost and stamps the
        # envelope with zone / purchase_option / expected_cost_usd.
        # None (the default) keeps the static $/node-hour model and the
        # pre-market wire format byte-for-byte.
        self.market = market
        # cold-start cross-job transfer (Flora-style): with a policy set,
        # predict/choose for unknown or under-supported jobs borrow the
        # nearest published job's fitted models and stamp the envelope
        # with transfer_source / transfer_confidence.  None (the default)
        # keeps the pre-transfer behavior: unknown jobs are errors.
        self.transfer = transfer
        self.prices = dict(prices)
        self.scaleouts = tuple(int(s) for s in scaleouts)
        self.confidence = confidence
        self.seed = seed
        # (job, seed) -> (store version, trust version, model-spec
        # objects, service): an accepted contribution bumps the store
        # version, a judged contribution can bump the TRUST version
        # (reputation moved, so stored rows re-weight), and a
        # maintainer's add_custom_model / spec re-registration changes
        # the spec tuple (the same invalidation contract
        # JobRepo.predictor_for keeps) — any of them lazily rebuilds the
        # service from the repo's (cached, possibly warm-started)
        # predictors on the next request.
        # LRU-capped: the seed is CLIENT-supplied, so an uncapped dict
        # would grow one service per distinct seed in hostile traffic
        self._services: "OrderedDict[Tuple[str, int], tuple]" = OrderedDict()
        # job -> ((store version, model names), JobInfo): search /
        # provenance metadata is recomputed only when the repo actually
        # changed, not per request
        self._jobinfo: Dict[str, tuple] = {}

    # ------------------------- routing helpers ----------------------------
    def _repo(self, job: str):
        try:
            return self.hub.get(job)
        except KeyError:
            raise UnknownJobError(job) from None

    #: bound on cached per-(job, seed) services (LRU eviction)
    MAX_SERVICES = 64

    def _service(self, job: str,
                 seed: Optional[int] = None) -> ConfigurationService:
        from repro_torch.core.models.api import get_model
        seed = self.seed if seed is None else int(seed)
        repo = self._repo(job)
        version = repo.store.version
        trust_version = repo.store.trust_version
        # key on the spec OBJECTS like predictor_for: a re-registered or
        # newly added custom model must invalidate the cached service
        specs = tuple(get_model(n) for n in repo.model_names)
        entry = self._services.get((job, seed))
        if entry is None or entry[0] != version \
                or entry[1] != trust_version or entry[2] != specs:
            svc = ConfigurationService.from_repo(
                repo, None, self.prices, self.scaleouts, seed=seed,
                confidence=self.confidence, market=self.market)
            self._services[(job, seed)] = entry = (version, trust_version,
                                                   specs, svc)
            while len(self._services) > self.MAX_SERVICES:
                self._services.popitem(last=False)
        self._services.move_to_end((job, seed))
        return entry[3]

    def _evict_superseded(self, job: str) -> int:
        """Drop cached services for ``job`` keyed on a dead store state.

        The per-(job, seed) LRU would otherwise strand one entry per seed
        across a store-version discontinuity (an accepted contribution,
        and especially an epoch transition, which no future request can
        ever revalidate against) until cap pressure pushes them out —
        N compactions must not grow the cache.  Returns how many entries
        were evicted."""
        repo = self._repo(job)
        version = repo.store.version
        trust_version = repo.store.trust_version
        dead = [k for k, e in self._services.items()
                if k[0] == job and (e[0] != version or e[1] != trust_version)]
        for k in dead:
            del self._services[k]
        return len(dead)

    def _rows(self, repo, X, y=None) -> np.ndarray:
        """Validated [n, d] feature block for ``repo``'s schema."""
        X = np.asarray(X, np.float64)
        if X.ndim != 2 or X.shape[1] != repo.schema.n_features:
            raise ValueError(
                f"expected [n, {repo.schema.n_features}] feature rows "
                f"(scale-out first) for job {repo.job!r}, got shape "
                f"{X.shape}")
        if y is not None and len(np.asarray(y)) != len(X):
            raise ValueError(f"{len(X)} feature rows but "
                             f"{len(np.asarray(y))} runtimes")
        return X

    def _machine(self, repo, machine_type: str,
                 job: Optional[str] = None) -> str:
        """Vocabulary check; ``job`` labels errors with the REQUESTED job
        when ``repo`` is a transfer donor answering for it."""
        if machine_type not in repo.store.data.machines:
            raise ValueError(
                f"job {job if job is not None else repo.job!r} has no "
                f"shared runtime data for machine type {machine_type!r} "
                f"(known: {', '.join(repo.store.data.machines) or 'none'})")
        return machine_type

    #: fewest stored rows a machine type needs before the gateway will
    #: fit (and serve) a predictor for it — below this, fitting either
    #: raises (0 rows: the store vocabulary can outlive a machine's rows
    #: across subset/compaction) or yields an uncalibratable model
    MIN_FIT_ROWS = 2

    def _support(self, repo, machine_type: str,
                 job: Optional[str] = None) -> None:
        """Refuse fits the data cannot support with a typed, countable
        reason instead of letting them raise through ``_respond`` as
        ``internal`` (regression: ``tests/test_torch_gateway.py``)."""
        rows = len(repo.store.data.machine_view(machine_type))
        if rows < self.MIN_FIT_ROWS:
            raise ValueError(
                f"insufficient_data: job "
                f"{job if job is not None else repo.job!r} has {rows} "
                f"stored row(s) for machine type {machine_type!r} "
                f"(needs >= {self.MIN_FIT_ROWS} to fit; store has "
                f"{len(repo.store)} row(s) total)")

    def _resolve(self, job: str, n_features: Optional[int] = None):
        """Serving repo for ``job``: ``(repo, transfer_source, confidence)``.

        Without a transfer policy this is exactly ``_repo``.  With one, an
        unknown job — or a published job whose store is below the policy's
        ``min_rows`` — borrows the nearest donor's repo: the returned
        ``transfer_source``/``confidence`` are stamped on the result
        envelope.  ``n_features`` (when the request's payload shape gives
        one) restricts donors to schema-compatible jobs.  An unknown job
        with no usable donor still raises ``UnknownJobError``."""
        try:
            repo = self._repo(job)
        except UnknownJobError:
            if self.transfer is None:
                raise
            match = self.hub.transfer_index(self.transfer).nearest(
                job, n_features)
            if match is None:
                raise
            return self._repo(match.source), match.source, match.confidence
        if self.transfer is not None \
                and len(repo.store) < self.transfer.min_rows:
            match = self.hub.transfer_index(self.transfer).nearest(
                job, repo.schema.n_features)
            if match is not None:
                return (self._repo(match.source), match.source,
                        match.confidence)
        return repo, "", 1.0

    # ------------------------- trust admission ----------------------------
    def _admit(self, request, expect=None):
        """Unwrap + authenticate one request BEFORE it touches any repo.

        Returns ``(inner_request, contributor_id, error_response)``.  On
        admission ``error_response`` is None and ``contributor_id`` is the
        token's identity (None on an unauthenticated gateway).  Refusals
        come back as typed ``unauthorized`` / ``quota_exceeded`` error
        envelopes — admission never raises."""
        token = None
        inner = request
        if isinstance(inner, AuthedRequest):
            token = inner.token
            inner = inner.request
        cid = None
        if self.auth is not None:
            cid, code, detail = self.auth.admit(token)
            if cid is None:
                return inner, None, Response.failure(code, detail)
        if expect is not None and not isinstance(inner, expect):
            return inner, cid, Response.failure(
                ERR_BAD_REQUEST,
                f"expected a {expect.__name__}, got "
                f"{type(inner).__name__}")
        return inner, cid, None

    # ------------------------- operations ---------------------------------
    def predict(self, req) -> Response[PredictResult]:
        req, _, err = self._admit(req, PredictRequest)
        return err if err is not None else self._respond(self._predict, req)

    def _seed(self, seed: Optional[int]) -> int:
        """Request-level seed override; None means the gateway default."""
        return self.seed if seed is None else int(seed)

    def _predict(self, req: PredictRequest) -> PredictResult:
        X = np.asarray(req.X, np.float64)
        repo, source, conf = self._resolve(
            req.job, X.shape[1] if X.ndim == 2 else None)
        X = self._rows(repo, X)
        machine = self._machine(repo, req.machine_type, job=req.job)
        self._support(repo, machine, job=req.job)
        pred = repo.predictor_for(machine, seed=self._seed(req.seed))
        t = pred.predict(X)
        return PredictResult(tuple(float(v) for v in t), pred.selected,
                             float(pred.mu), float(pred.sigma),
                             source, conf)

    def predict_batch(self, job: str, machine_type: str,
                      seed: Optional[int], X) -> list:
        """Batched predict entry point for the per-(job, machine) lanes:
        one ``predictor.predict`` dispatch for a coalesced [C, d] block
        of SINGLE-ROW requests, answered as C per-row ``Response``
        envelopes.  Row i's envelope is byte-identical to what the
        inline path (``predict`` with a one-row ``PredictRequest``)
        would have returned — the models are row-independent, so
        batching changes wall-clock, never values (parity pinned in
        ``tests/test_torch_edge.py`` and, on the card,
        ``tests/test_torch_gpu.py``)."""
        X = np.asarray(X, np.float64)
        repo, source, conf = self._resolve(
            job, X.shape[1] if X.ndim == 2 else None)
        machine = self._machine(repo, machine_type, job=job)
        self._support(repo, machine, job=job)
        pred = repo.predictor_for(machine, seed=self._seed(seed))
        t = pred.predict(X)
        selected, mu, sigma = pred.selected, float(pred.mu), float(pred.sigma)
        return [Response.success(PredictResult((float(v),), selected, mu,
                                               sigma, source, conf))
                for v in t]

    def choose(self, req) -> Response[ChooseResult]:
        req, _, err = self._admit(req, ChooseRequest)
        return err if err is not None else self._respond(self._choose, req)

    def _choose(self, req: ChooseRequest) -> ChooseResult:
        ctx = np.asarray(req.context, np.float64).reshape(-1)
        repo, source, conf = self._resolve(req.job, len(ctx) + 1)
        if len(ctx) != repo.schema.n_features - 1:
            raise ValueError(
                f"context row has width {len(ctx)}, job {repo.job!r} "
                f"expects {repo.schema.n_features - 1}")
        if (req.zones is not None or req.purchase_options is not None) \
                and self.market is None:
            raise MarketError(
                "placement constraints (zones / purchase_options) require "
                "a market-enabled gateway: construct HubGateway with "
                "market=PriceBook(...)")
        # a borrowed answer runs the DONOR's configuration service (its
        # fitted predictors over the shared grid), keyed under the donor
        # so cold jobs share the donor's warm service state
        choice = self._service(source or req.job, req.seed) \
            .choose_cluster_batch(
                ctx[None, :], np.asarray([req.t_max], np.float64),
                zones=req.zones, options=req.purchase_options)[0]
        return ChooseResult.from_choice(choice, source, conf)

    def contribute(self, req) -> Response[ContributeResult]:
        req, cid, err = self._admit(req, ContributeRequest)
        if err is not None:
            return err
        if cid is not None and req.contributor_id != cid:
            # the TOKEN is the identity on an auth-enabled gateway: a
            # client cannot stamp rows (or reputations) onto someone else
            req = replace(req, contributor_id=cid)
        return self._respond(self._contribute, req)

    def _contribute(self, req: ContributeRequest) -> ContributeResult:
        repo = self._repo(req.job)
        X = self._rows(repo, req.X, req.y)
        if len(req.machine_type) != len(X):
            raise ValueError(f"{len(X)} feature rows but "
                             f"{len(req.machine_type)} machine types")
        # machine names / contributor ids that the TSV codec cannot
        # round-trip are rejected by the store itself (ValueError ->
        # bad_request envelope)
        rows = RuntimeData(repo.schema, np.asarray(req.machine_type), X,
                           np.asarray(req.y, np.float64))
        report = repo.contribute(rows, contributor=req.contributor_id)
        self._evict_superseded(req.job)   # judged: version/trust moved
        return ContributeResult(
            bool(report.accepted), float(report.baseline_mape),
            float(report.candidate_mape), report.reason, req.contributor_id,
            len(repo.store), repo.store.version, repo.store.fingerprint)

    def compact(self, req) -> Response[CompactResult]:
        """Store lifecycle admin op: epoch transition via coverage-aware
        reduction.  Auth-enabled gateways serve it to OPERATORS only —
        an admitted but non-operator identity gets a typed
        ``unauthorized`` envelope before any repo is touched."""
        req, cid, err = self._admit(req, CompactRequest)
        if err is not None:
            return err
        if self.auth is not None and not self.auth.is_operator(cid):
            return Response.failure(
                ERR_UNAUTHORIZED,
                f"store compaction is operator-only: contributor {cid!r} "
                "holds no operator standing (grant_operator)")
        return self._respond(self._compact, req)

    def _compact(self, req: CompactRequest) -> CompactResult:
        repo = self._repo(req.job)
        report = repo.store.compact(
            max_rows_per_cell=int(req.max_rows_per_cell),
            support_floor=int(req.support_floor),
            cell_rel_width=float(req.cell_rel_width),
            accuracy_budget=float(req.accuracy_budget),
            min_store_rows=int(req.min_store_rows),
            seed=self._seed(req.seed))
        if report.accepted:
            # the old epoch's store version is a dead key no request can
            # revalidate: evict eagerly instead of waiting for LRU pressure
            self._evict_superseded(req.job)
        return CompactResult(
            bool(report.accepted), report.code, report.reason,
            int(report.rows_before), int(report.rows_after),
            int(report.epoch), int(report.cells),
            float(report.baseline_mape), float(report.candidate_mape),
            repo.store.version, repo.store.fingerprint)

    def model_errors(self, req) -> Response[ModelErrorsResult]:
        req, _, err = self._admit(req, ModelErrorsRequest)
        return err if err is not None else self._respond(self._model_errors,
                                                         req)

    def _model_errors(self, req: ModelErrorsRequest) -> ModelErrorsResult:
        repo = self._repo(req.job)
        X = self._rows(repo, req.X, req.y)
        machine = self._machine(repo, req.machine_type)
        self._support(repo, machine)
        test = RuntimeData(repo.schema, np.full(len(X), machine), X,
                           np.asarray(req.y, np.float64))
        errs, selected = repo.model_errors(
            machine, test, track_models=req.track_models,
            seed=self._seed(req.seed))
        table = tuple((m, float(mape), float(mae))
                      for m, (mape, mae) in sorted(errs.items()))
        return ModelErrorsResult(table, selected)

    def search(self, req) -> Response[SearchResult]:
        req, _, err = self._admit(req, SearchRequest)
        return err if err is not None else self._respond(self._search, req)

    def _job_info(self, repo) -> JobInfo:
        """Per-(job, store version) cached metadata: contributor counts
        and machine lists are O(rows) scans that only change when a
        contribution is accepted — not per search request."""
        key = (repo.store.version, repo.store.epoch,
               tuple(repo.model_names))
        entry = self._jobinfo.get(repo.job)
        if entry is None or entry[0] != key:
            data = repo.store.data
            info = JobInfo(
                repo.job, repo.algorithm, len(data),
                data.present_machines(), key[2],
                tuple(sorted(data.contributor_counts().items())),
                epoch=repo.store.epoch,
                compactions=repo.store.compactions,
                rows_contributed=repo.store.rows_contributed)
            self._jobinfo[repo.job] = entry = (key, info)
        return entry[1]

    def _search(self, req: SearchRequest) -> SearchResult:
        return SearchResult(tuple(
            self._job_info(repo)
            for repo in sorted(self.hub.search(req.algorithm),
                               key=lambda r: r.job)))

    def contributor_stats(self, job: str) -> Response[Tuple[Tuple[str, int],
                                                            ...]]:
        """Per-contributor row counts for one job's shared store."""
        return self._respond(
            lambda j: tuple(sorted(
                self._repo(j).store.data.contributor_counts().items())), job)

    def trust_state(self, req) -> Response[TrustStateResult]:
        req, _, err = self._admit(req, TrustStateRequest)
        return err if err is not None else self._respond(self._trust_state,
                                                         req)

    def _trust_state(self, req: TrustStateRequest) -> TrustStateResult:
        cid = str(req.contributor_id)
        if self.auth is not None:
            known = self.auth.known(cid)
            banned = self.auth.is_banned(cid)
            quota = float(self.auth.quota_remaining(cid))
        else:
            known, banned, quota = False, False, UNMETERED
        reps = []
        for job in self.hub.jobs():
            trust = self.hub.get(job).store.trust
            if trust is not None and cid in trust:
                rec = trust.stats(cid)
                reps.append((job, float(trust.reputation(cid)),
                             int(rec.accepted), int(rec.rejected)))
        return TrustStateResult(cid, known, banned, quota, tuple(reps))

    # ------------------------- admin surface ------------------------------
    # Operator-side token management: these are direct method calls (not
    # wire requests) because whoever holds the gateway object IS the hub
    # operator.  They raise on an unauthenticated gateway — there is no
    # authority to manage.

    def _authority(self) -> TrustAuthority:
        if self.auth is None:
            raise RuntimeError(
                "gateway has no TrustAuthority: construct it with "
                "auth=TrustAuthority(...) to manage tokens")
        return self.auth

    def issue_token(self, contributor_id: str) -> str:
        return self._authority().issue_token(contributor_id)

    def revoke_token(self, token: str) -> bool:
        return self._authority().revoke_token(token)

    def ban_contributor(self, contributor_id: str) -> None:
        self._authority().ban(contributor_id)

    def unban_contributor(self, contributor_id: str) -> bool:
        return self._authority().unban(contributor_id)

    def grant_operator(self, contributor_id: str) -> None:
        self._authority().grant_operator(contributor_id)

    def revoke_operator(self, contributor_id: str) -> bool:
        return self._authority().revoke_operator(contributor_id)

    # ------------------------- uniform dispatch ---------------------------
    _HANDLERS = {
        PredictRequest: "predict", ChooseRequest: "choose",
        ContributeRequest: "contribute", ModelErrorsRequest: "model_errors",
        SearchRequest: "search", TrustStateRequest: "trust_state",
        CompactRequest: "compact",
    }

    def handle(self, request) -> Response:
        """Serve any API v1 request object (front-end dispatch point).
        ``AuthedRequest`` wrappers route on their INNER request; the
        wrapper itself travels on to the operation so admission sees the
        token."""
        inner = request.request if isinstance(request, AuthedRequest) \
            else request
        name = self._HANDLERS.get(type(inner))
        if name is None:
            return Response.failure(
                ERR_BAD_REQUEST,
                f"not an API v1 request: {type(inner).__name__}")
        return getattr(self, name)(request)

    def _respond(self, fn, req) -> Response:
        try:
            return Response.success(fn(req))
        except UnknownJobError as e:
            return Response.failure(ERR_UNKNOWN_JOB,
                                    f"no published repo for job {e.args[0]!r}")
        except (ValueError, TypeError, KeyError) as e:
            return Response.failure(ERR_BAD_REQUEST, str(e))
        except Exception as e:                       # noqa: BLE001
            return Response.failure(ERR_INTERNAL,
                                    f"{type(e).__name__}: {e}")


class AsyncHubGateway:
    """Per-job micro-batch lanes over a ``HubGateway``.

    Concurrent ``choose`` requests are enqueued on their job's
    ``BatchLane``; each lane answers everything pending per tick with one
    ``choose_cluster_batch`` engine dispatch, resolving the job's CURRENT
    service each tick so accepted contributions take effect without lane
    restarts.  Single-row ``predict`` requests ride their own lanes,
    keyed per (job, source job, machine type, seed, store version) — the
    source job is the transfer donor when the gateway is answering a cold
    job from borrowed models, so borrowed predictions batch correctly —
    and concurrent predicts coalesce into one ``predictor.predict``
    dispatch per tick;
    the store version rides in the key because an accepted contribution
    (or compaction) is a data discontinuity: post-bump requests open a
    fresh lane and the superseded one is evicted at creation.  Multi-row
    predicts and all other operations pass through to the sync gateway
    (they are not single-row dispatch-bound).

        async with AsyncHubGateway(gateway) as agw:
            resp = await agw.choose(ChooseRequest(job="grep", ...))
            resp = await agw.predict(PredictRequest(job="grep", ...))
    """

    #: bound on live lanes: the seed is client-supplied, and every lane
    #: owns a worker task — hostile seed churn must not grow them forever.
    #: Evicting a lane cancels whatever is still queued on it, so the cap
    #: only bites under seed-spraying traffic, never steady serving.
    MAX_LANES = 64

    def __init__(self, gateway: HubGateway, *, max_batch: int = 256,
                 tick_s: float = 0.0, timeout_s: Optional[float] = None):
        self.gateway = gateway
        self.max_batch = max_batch
        self.tick_s = tick_s
        # per-dispatch deadline forwarded to every lane: a tick that
        # exceeds it answers ITS requests with typed ``timeout`` error
        # envelopes while the lane worker keeps serving (None = no bound)
        self.timeout_s = timeout_s
        self._lanes: "OrderedDict[Tuple[str, int], BatchLane]" = OrderedDict()
        # predict lanes, keyed (job, machine_type, seed, store_version)
        self._predict_lanes: "OrderedDict[tuple, BatchLane]" = OrderedDict()
        # strong refs to in-flight eviction stop() tasks: the event loop
        # only holds tasks weakly, and a GC'd stop task would leak the
        # evicted lane's worker
        self._stopping: set = set()

    # ------------------------- lifecycle ----------------------------------
    async def __aenter__(self) -> "AsyncHubGateway":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def stop(self) -> None:
        lanes, self._lanes = self._lanes, OrderedDict()
        plane, self._predict_lanes = self._predict_lanes, OrderedDict()
        # dropped, not retained: a request after stop() would otherwise
        # enqueue onto a lane whose worker is gone and hang forever —
        # fresh lanes are created (and started) on the next choose().
        # In-flight eviction stops are awaited too, so shutdown leaves no
        # dangling worker
        await asyncio.gather(*(lane.stop() for lane in lanes.values()),
                             *(lane.stop() for lane in plane.values()),
                             *list(self._stopping))

    # ------------------------- lanes --------------------------------------
    def _lane(self, job: str, seed: Optional[int],
              n_features: Optional[int] = None) -> BatchLane:
        # one lane per (job, SOURCE job, seed): requests with different
        # seeds answer from different predictor states and must not share
        # a dispatch, and a cold job borrowing a donor dispatches on the
        # donor's service — the source rides in the key so a resolution
        # flip (the cold job's own store crossing min_rows) opens a fresh
        # lane instead of mislabeling batches.  Keyed on the TUPLE — a
        # job literally named "x#seed=1" must not collide with job "x" at
        # seed 1; the formatted name is display only (lane_stats)
        seed = self.gateway._seed(seed)
        repo, source, _ = self.gateway._resolve(job, n_features)
        key = (job, source or job, seed)
        lane = self._lanes.get(key)
        if lane is None:
            for k in [k for k in self._lanes
                      if k[0] == key[0] and k[2] == key[2] and k != key]:
                self._stop_lane(self._lanes.pop(k))   # stale resolution

            def dispatch(contexts, t_max, _job=job, _seed=seed):
                # resolve the service at dispatch time: a contribution
                # accepted between ticks rebuilds it (store-version keyed),
                # and the transfer resolution is re-checked so lane
                # envelopes match the sync path byte-for-byte.  The whole
                # tick's envelopes are built here in one tight loop —
                # per-request coroutines just hand the finished Response
                # through
                _, src, conf = self.gateway._resolve(
                    _job, contexts.shape[1] + 1)
                choices = self.gateway._service(
                    src or _job, _seed).choose_cluster_batch(contexts, t_max)
                return [Response.success(
                            ChooseResult.from_choice(c, src, conf))
                        for c in choices]

            lane = BatchLane(dispatch, width=repo.schema.n_features - 1,
                             max_batch=self.max_batch, tick_s=self.tick_s,
                             timeout_s=self.timeout_s)
            lane.start()
            self._lanes[key] = lane
            while len(self._lanes) > self.MAX_LANES:
                _, old = self._lanes.popitem(last=False)   # LRU lane
                self._stop_lane(old)
        self._lanes.move_to_end(key)
        return lane

    def _stop_lane(self, lane: BatchLane) -> None:
        """Detach a lane's worker asynchronously (strong-ref'd so the
        stop task cannot be GC'd mid-flight)."""
        task = asyncio.get_running_loop().create_task(lane.stop())
        self._stopping.add(task)
        task.add_done_callback(self._stopping.discard)

    def _predict_lane(self, job: str, machine_type: str,
                      seed: Optional[int],
                      n_features: Optional[int] = None) -> BatchLane:
        # one lane per (job, SOURCE job, machine, seed, STORE VERSION): a
        # predict dispatch binds one fitted predictor, and the SERVING
        # store's version is exactly its invalidation key — requests
        # racing an accepted contribution keep answering from the epoch
        # they arrived under, while post-bump requests open a fresh lane.
        # The source job rides in the key so borrowed predictions batch
        # on their donor's predictor and a resolution flip (cold job
        # graduating to its own models) opens a fresh lane
        seed = self.gateway._seed(seed)
        repo, source, _ = self.gateway._resolve(job, n_features)
        key = (job, source or job, machine_type, seed, repo.store.version)
        lane = self._predict_lanes.get(key)
        if lane is None:
            # the machine must be known AND fit-supported NOW:
            # enqueue-time refusal, so a typo (or a vocabulary machine
            # whose rows were compacted away) cannot open (and leak) a
            # lane that can never answer
            self.gateway._machine(repo, machine_type, job=job)
            self.gateway._support(repo, machine_type, job=job)
            for k in [k for k in self._predict_lanes
                      if k[0] == key[0] and k[2] == key[2]
                      and k[3] == key[3] and k != key]:
                self._stop_lane(self._predict_lanes.pop(k))  # superseded

            def dispatch(X, _t_max, _job=job, _machine=machine_type,
                         _seed=seed):
                # t_max is the lane's deadline slot — predicts carry none
                return self.gateway.predict_batch(_job, _machine, _seed, X)

            lane = BatchLane(dispatch, width=repo.schema.n_features,
                             max_batch=self.max_batch, tick_s=self.tick_s,
                             timeout_s=self.timeout_s)
            lane.start()
            self._predict_lanes[key] = lane
            while len(self._predict_lanes) > self.MAX_LANES:
                _, old = self._predict_lanes.popitem(last=False)
                self._stop_lane(old)
        self._predict_lanes.move_to_end(key)
        return lane

    @property
    def lane_stats(self) -> Dict[str, ServeStats]:
        """Stats per lane: choose lanes are named ``job``, predict lanes
        ``job@machine`` — both with a ``<-source`` suffix when a cold job
        is borrowing a donor's models and a ``#seed=N`` suffix off the
        default seed (display names; routing uses tuples).  Predict lanes
        for superseded store versions are already evicted, so one name
        maps to one live lane."""
        out = {}
        for (job, src, seed), lane in self._lanes.items():
            name = job if src == job else f"{job}<-{src}"
            if seed != self.gateway.seed:
                name = f"{name}#seed={seed}"
            out[name] = lane.stats
        for (job, src, machine, seed,
             _ver), lane in self._predict_lanes.items():
            name = f"{job}@{machine}"
            if src != job:
                name = f"{name}<-{src}"
            if seed != self.gateway.seed:
                name = f"{name}#seed={seed}"
            out[name] = lane.stats
        return out

    # ------------------------- request path -------------------------------
    async def predict(self, req) -> Response[PredictResult]:
        """Predict, micro-batched: single-row requests coalesce on their
        (job, machine, seed, store-version) lane into ONE
        ``predictor.predict`` dispatch per tick; multi-row requests are
        already a batch and dispatch inline (sync path, same envelope)."""
        req, _, err = self.gateway._admit(req, PredictRequest)
        if err is not None:
            return err
        try:
            if len(req.X) != 1:
                # already admitted: dispatch directly, not via the sync
                # entry point (re-admission would double-charge quota and
                # refuse the unwrapped request on an auth-enabled gateway)
                return self.gateway._respond(self.gateway._predict, req)
            row = req.X[0]
            lane = self._predict_lane(
                req.job, req.machine_type, req.seed,
                len(row) if hasattr(row, "__len__") else None)
            return await lane.submit(row, None)
        except UnknownJobError as e:
            return Response.failure(
                ERR_UNKNOWN_JOB, f"no published repo for job {e.args[0]!r}")
        except LaneTimeoutError as e:
            return Response.failure(ERR_TIMEOUT, str(e))
        except (ValueError, TypeError) as e:
            return Response.failure(ERR_BAD_REQUEST, str(e))
        except asyncio.CancelledError:
            raise
        except Exception as e:                       # noqa: BLE001
            return Response.failure(ERR_INTERNAL,
                                    f"{type(e).__name__}: {e}")

    async def choose(self, req) -> Response[ChooseResult]:
        # admission (auth + quota) happens HERE, before the request is
        # enqueued on any lane: a rate-limited contributor never occupies
        # micro-batch capacity
        req, _, err = self.gateway._admit(req, ChooseRequest)
        if err is not None:
            return err
        try:
            if req.zones is not None or req.purchase_options is not None:
                # placement-constrained choices cannot share a lane's
                # packed dispatch (a lane batches per (job, seed) with
                # ONE placement universe per tick) — dispatch inline,
                # already admitted, same envelope as the sync path.  A
                # bad constraint therefore answers a typed bad_request
                # without ever creating a lane.
                return self.gateway._respond(self.gateway._choose, req)
            ctx = req.context
            lane = self._lane(
                req.job, req.seed,
                len(ctx) + 1 if hasattr(ctx, "__len__") else None)
            # submit() canonicalizes the row; the lane dispatch already
            # wrapped the answer in a Response envelope
            return await lane.submit(ctx, req.t_max)
        except UnknownJobError as e:
            return Response.failure(
                ERR_UNKNOWN_JOB, f"no published repo for job {e.args[0]!r}")
        except LaneTimeoutError as e:
            return Response.failure(ERR_TIMEOUT, str(e))
        except (ValueError, TypeError) as e:
            # same classification as the sync path's _respond: a payload
            # the lane cannot parse is the CLIENT's error, not a fault
            return Response.failure(ERR_BAD_REQUEST, str(e))
        except asyncio.CancelledError:
            raise
        except Exception as e:                       # noqa: BLE001
            return Response.failure(ERR_INTERNAL,
                                    f"{type(e).__name__}: {e}")

    def handle(self, request) -> Response:
        """Synchronous pass-through for non-choose operations."""
        return self.gateway.handle(request)

    async def handle_async(self, request) -> Response:
        """Uniform async dispatch: choose and single-row predict
        requests ride the micro-batch lanes, everything else serves
        inline (AuthedRequest wrappers route on their inner request,
        like the sync ``handle``)."""
        inner = request.request if isinstance(request, AuthedRequest) \
            else request
        if isinstance(inner, ChooseRequest):
            return await self.choose(request)
        if isinstance(inner, PredictRequest):
            return await self.predict(request)
        return self.gateway.handle(request)
