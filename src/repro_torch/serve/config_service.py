"""Asyncio micro-batch lanes for configuration serving.

``BatchLane`` is the generic building block: concurrent ``submit`` calls
land on an asyncio queue; a single worker task drains everything pending
each tick and answers the whole batch with ONE batched dispatch.
Per-request deadlines are packed into a [C] array with NaN for "no
deadline", which the dispatch resolves per context — heterogeneous
requests still share a dispatch.  The gateway (``repro_torch.api.gateway``)
runs one lane per job, so concurrent requests for different jobs coalesce
into one engine dispatch *per job per tick*.

``AsyncConfigService`` is the legacy single-service front-end, now a thin
shim over one ``BatchLane``:

    svc = ConfigurationService(...)
    async with AsyncConfigService(svc) as front:
        choice = await front.choose(ctx, t_max=400.0)

Requests/s and the realized mean micro-batch size of each lane are
read by ``chip_smoke.py``'s ``edge`` phase on the card and by
``tests/test_torch_edge.py`` on the CPU.
"""
from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.configurator import ClusterChoice
from repro_torch.core.service import ConfigurationService


class LaneTimeoutError(Exception):
    """A micro-batch dispatch missed the lane's per-request deadline.

    Raised INTO the affected submit() futures only — the worker itself
    survives and keeps serving later ticks (the gateway maps this to the
    typed ``timeout`` error envelope)."""


class LatencyReservoir:
    """Fixed-capacity ring buffer of latency observations (seconds).

    A serving lane records one sample per dispatched request for the
    process lifetime, so the store must stay O(capacity), never
    O(requests): the buffer is allocated ONCE and old samples are
    overwritten in ring order — percentiles answer over the most recent
    ``capacity`` observations (a sliding window, which is also what an
    operator wants from ``/stats``: current tail latency, not the cold
    compile spikes from an hour ago)."""

    __slots__ = ("capacity", "_buf", "_count")

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._buf = np.empty(self.capacity, np.float64)
        self._count = 0                   # lifetime observations

    def __len__(self) -> int:
        """Live samples in the window (never exceeds ``capacity``)."""
        return min(self._count, self.capacity)

    @property
    def total(self) -> int:
        """Lifetime observation count (the window holds the last
        ``capacity`` of these)."""
        return self._count

    def record(self, seconds: float) -> None:
        self._buf[self._count % self.capacity] = seconds
        self._count += 1

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile (``p`` in [0, 100]) over the live
        window, in seconds; NaN while empty."""
        n = len(self)
        if n == 0:
            return math.nan
        k = min(n - 1, max(0, math.ceil(p / 100.0 * n) - 1))
        return float(np.partition(self._buf[:n], k)[k])


@dataclass
class ServeStats:
    """Bounded serving counters: the mean batch size is exact as
    requests-over-batches instead of an ever-growing per-batch list (a
    lane on hub traffic would otherwise leak one list entry per tick,
    forever).  ``requests`` counts DISPATCHED requests only — enqueue-
    rejected submissions never reach a batch.  ``latency`` is a bounded
    ring-buffer reservoir of per-request latencies (enqueue to answer),
    so p50/p95/p99 come from the server side without unbounded lists."""
    requests: int = 0
    batches: int = 0
    latency: LatencyReservoir = field(default_factory=LatencyReservoir)

    def record_batch(self, size: int) -> None:
        self.requests += size
        self.batches += 1

    def record_latency(self, seconds: float) -> None:
        self.latency.record(float(seconds))

    def percentile(self, p: float) -> float:
        """Nearest-rank latency percentile in seconds (NaN until a
        request has been answered)."""
        return self.latency.percentile(p)

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


class BatchLane:
    """Micro-batching worker over a batched dispatch function.

    ``dispatch(contexts [C, k], t_max [C]) -> sequence of per-row results``
    is called once per tick with everything queued.  ``max_batch`` caps one
    dispatch's batch; ``tick_s`` is an optional accumulation window after
    the first request of a batch arrives (0 means "drain whatever is
    already queued", which keeps p50 latency at one dispatch while still
    coalescing concurrent arrivals).

    ``width`` pins the context-row width when the caller knows it (the
    gateway pins from the job schema): submissions are then validated at
    enqueue time, so a request whose width disagrees fails ALONE with
    ``ValueError`` instead of poisoning the micro-batch it would have
    been packed with (the batch pack allocates ``[C, width]``; one stray
    row used to raise there and fan the failure out to every concurrent
    caller — and kill the worker).  With ``width=None`` there is no
    authoritative width, so each tick's batch is packed and dispatched
    PER WIDTH GROUP: a stray-width request reaches the dispatch on its
    own and collects its own outcome, never another group's — a
    malformed first arrival cannot wedge the lane for every later
    well-formed request.

    ``timeout_s`` (None = unbounded, the default) is a per-dispatch
    deadline: the group's dispatch runs on the loop's executor under
    ``asyncio.wait_for``, and on expiry the group's futures fail with
    ``LaneTimeoutError`` while the worker moves on to the next tick — a
    wedged dispatch costs its own callers a typed ``timeout`` envelope,
    not the lane.
    """

    def __init__(self, dispatch: Callable, *, width: Optional[int] = None,
                 max_batch: int = 256, tick_s: float = 0.0,
                 timeout_s: Optional[float] = None):
        self.dispatch = dispatch
        self.width = width
        self.max_batch = max_batch
        self.tick_s = tick_s
        self.timeout_s = timeout_s
        self.stats = ServeStats()
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker: Optional[asyncio.Task] = None

    # ------------------------- lifecycle ----------------------------------
    def start(self) -> None:
        if self._worker is None:
            self._worker = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        if self._worker is not None:
            self._worker.cancel()
            try:
                await self._worker
            except asyncio.CancelledError:
                pass
            self._worker = None
        # fail anything still enqueued so no submit() caller hangs forever
        while True:
            try:
                _, _, fut, _ = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if not fut.done():
                fut.cancel()

    # ------------------------- request path -------------------------------
    async def submit(self, context_row,
                     t_max: Optional[float] = None):
        """Awaitable single request; answered as part of the next batch.

        ``context_row`` may be a flat tuple (gateway envelopes) or an
        ndarray.  Content is validated HERE: every enqueued row is
        float-convertible, so the worker's batch pack cannot raise on one
        request's payload — a malformed request fails its own caller at
        enqueue, never its batch."""
        ctx = tuple(map(float, context_row)) if type(context_row) is tuple \
            else np.asarray(context_row, np.float64).reshape(-1)
        if self.width is not None and len(ctx) != self.width:
            raise ValueError(
                f"context row has width {len(ctx)}, lane expects "
                f"{self.width}: request rejected at enqueue (malformed "
                "requests must not poison the shared micro-batch)")
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(
            (ctx, math.nan if t_max is None else float(t_max), fut,
             time.monotonic()))
        return await fut

    # ------------------------- worker loop --------------------------------
    async def _run(self) -> None:
        batch = []
        try:
            while True:
                batch = [await self._queue.get()]
                if self.tick_s > 0:
                    await asyncio.sleep(self.tick_s)   # accumulation window
                while len(batch) < self.max_batch:
                    try:
                        batch.append(self._queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                # pack per width group (normally exactly one group: pinned
                # lanes enqueue-validate, unpinned lanes see one width in
                # practice), each group columnar — one [C, k] context
                # block + one [C] deadline vector the dispatch consumes
                # without further copies.  A failing group fans its error
                # to ITS requests only.
                groups: dict = {}
                for entry in batch:
                    groups.setdefault(len(entry[0]), []).append(entry)
                for group in groups.values():
                    try:
                        # the pack itself can raise (non-numeric content in
                        # a width-correct tuple): that failure belongs to
                        # this group's callers, not the worker — the lane
                        # must survive any single bad payload
                        contexts = np.empty((len(group), len(group[0][0])),
                                            np.float64)
                        t_max = np.empty(len(group), np.float64)
                        for i, (ctx, tm, _, _) in enumerate(group):
                            contexts[i] = ctx
                            t_max[i] = tm
                        results = await self._dispatch_group(contexts, t_max)
                    except (asyncio.TimeoutError, TimeoutError):
                        # deadline missed: fail THIS group with the typed
                        # lane error and keep serving — the dispatch thread
                        # finishes on the executor in the background, its
                        # result discarded (the futures are already failed)
                        err = LaneTimeoutError(
                            f"micro-batch dispatch exceeded its "
                            f"{self.timeout_s:g}s deadline "
                            f"({len(group)} request(s) affected)")
                        for _, _, fut, _ in group:
                            if not fut.done():
                                fut.set_exception(err)
                        continue
                    except Exception as e:           # fan the failure out
                        for _, _, fut, _ in group:
                            if not fut.done():
                                fut.set_exception(e)
                        continue
                    self.stats.record_batch(len(group))
                    now = time.monotonic()
                    for (_, _, fut, t0), result in zip(group, results):
                        # per-request latency: enqueue to answer, into the
                        # bounded reservoir (dispatched requests only,
                        # like the request counter)
                        self.stats.record_latency(now - t0)
                        if not fut.done():
                            fut.set_result(result)
                batch = []
        finally:
            for _, _, fut, _ in batch:  # cancelled mid-batch: don't strand
                if not fut.done():
                    fut.cancel()

    async def _dispatch_group(self, contexts, t_max):
        """One group's dispatch, under the lane deadline if configured.

        Without ``timeout_s`` the dispatch runs inline on the event loop
        (byte-for-byte the historical path); with it, the dispatch runs on
        the default executor so ``wait_for`` can abandon it at the
        deadline without blocking the loop.

        An abandoned dispatch is not cancelled, as in the JAX package: its
        executor thread finishes the host work, the kernels it queued run
        to their end on the card, and its answers are dropped.  Lanes then
        issue CUDA work from several pool threads at once; the kernel
        wrappers they reach set up and count launches under a lock
        (``repro_torch.kernels.gbm_predict._LOCK``)."""
        if self.timeout_s is None:
            return self.dispatch(contexts, t_max)
        loop = asyncio.get_running_loop()
        return await asyncio.wait_for(
            loop.run_in_executor(None, self.dispatch, contexts, t_max),
            self.timeout_s)


class AsyncConfigService:
    """Micro-batching wrapper around ONE ``ConfigurationService``.

    Deprecated entry point: this is now a thin shim over ``BatchLane`` —
    new code should route through ``repro_torch.api.gateway.AsyncHubGateway``,
    which runs one lane per published job behind the typed request
    envelopes and serves identical choices (parity pinned in
    ``tests/test_torch_gateway.py``)."""

    def __init__(self, service: ConfigurationService, *,
                 max_batch: int = 256, tick_s: float = 0.0,
                 width: Optional[int] = None,
                 timeout_s: Optional[float] = None):
        self.service = service
        # width: the expected context-row width, when the caller knows it
        # (rejects malformed requests at enqueue; see BatchLane)
        self._lane = BatchLane(service.choose_cluster_batch, width=width,
                               max_batch=max_batch, tick_s=tick_s,
                               timeout_s=timeout_s)

    @property
    def stats(self) -> ServeStats:
        return self._lane.stats

    # ------------------------- lifecycle ----------------------------------
    async def __aenter__(self) -> "AsyncConfigService":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def start(self) -> None:
        self._lane.start()

    async def stop(self) -> None:
        await self._lane.stop()

    # ------------------------- request path -------------------------------
    async def choose(self, context_row: np.ndarray,
                     t_max: Optional[float] = None) -> ClusterChoice:
        """Awaitable single request; answered as part of the next batch."""
        return await self._lane.submit(context_row, t_max)


__all__: List[str] = ["ServeStats", "LatencyReservoir", "BatchLane",
                      "AsyncConfigService", "LaneTimeoutError"]
