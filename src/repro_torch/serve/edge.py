"""Socket-level serving edge: an ASGI front-end for the Hub Gateway.

``HubEdgeApp`` is a dependency-light ASGI 3.0 callable (it runs under
uvicorn unchanged, no framework required) that maps HTTP bodies through
the strict-JSON wire codec (``repro_torch.api.codec``) into ``AsyncHubGateway``
operations:

    POST /v1/predict       PredictRequest   -> PredictResult
    POST /v1/choose        ChooseRequest    -> ChooseResult
    POST /v1/contribute    ContributeRequest -> ContributeResult
    POST /v1/model_errors  ModelErrorsRequest -> ModelErrorsResult
    POST /v1/search        SearchRequest    -> SearchResult
    POST /v1/trust_state   TrustStateRequest -> TrustStateResult
    POST /v1/compact       CompactRequest   -> CompactResult
    POST /v1               any of the above (routes on "__type__")
    GET  /healthz          -> HealthResult
    GET  /stats            -> StatsResult

Every HTTP response body is a codec-encoded ``Response`` envelope —
malformed JSON, unknown ops, oversized bodies, auth refusals, and even
internal faults come back as TYPED error envelopes with a mapped HTTP
status, never a raw 500 page.  Requests wrapped in ``AuthedRequest``
carry bearer tokens exactly as in-process.  Single-row predict and
choose requests coalesce on the gateway's per-(job, machine) /
per-(job) micro-batch lanes, so socket concurrency turns into batched
engine dispatches.

``EdgeServer`` is the bundled minimal asyncio HTTP/1.1 host (keep-alive,
content-length framing) so the edge binds a REAL socket in environments
without uvicorn — the closed-loop load generator
(``repro_torch.serve.loadgen``) and ``chip_smoke.py``'s ``edge`` phase
drive it over localhost.  Shutdown drains: in-flight requests
(including in-flight lane dispatches) finish, new requests answer a
typed ``shutting_down`` envelope, and only then are the gateway lanes
stopped.

Quickstart (demo hub with emulated Spark jobs):

    PYTHONPATH=src python -m repro_torch.serve.edge --port 8787
        (on the card; add --device cpu to serve on the CPU)
    curl -s localhost:8787/healthz
    curl -s -X POST localhost:8787/v1/choose -d '{"__type__":
      "ChooseRequest","job":"grep","context":[15.0,0.02],"t_max":400.0}'
"""
from __future__ import annotations

import argparse
import asyncio
import math
import time
from typing import Dict, Optional, Tuple

from repro_torch.api import codec
from repro_torch.api.gateway import AsyncHubGateway
from repro_torch.api.types import (API_VERSION, ERR_BAD_REQUEST, ERR_INTERNAL,
                                   ERR_QUOTA_EXCEEDED, ERR_SHUTTING_DOWN,
                                   ERR_TIMEOUT, ERR_UNAUTHORIZED,
                                   ERR_UNKNOWN_JOB, AuthedRequest,
                                   ChooseRequest, CompactRequest,
                                   ContributeRequest, HealthResult,
                                   LaneSnapshot, ModelErrorsRequest,
                                   PredictRequest, Response, SearchRequest,
                                   StatsResult, TrustStateRequest)
from repro_torch.serve.config_service import ServeStats

#: request-envelope type expected by each POST /v1/<op> endpoint
OPS: Dict[str, type] = {
    "predict": PredictRequest,
    "choose": ChooseRequest,
    "contribute": ContributeRequest,
    "model_errors": ModelErrorsRequest,
    "search": SearchRequest,
    "trust_state": TrustStateRequest,
    "compact": CompactRequest,
}

#: HTTP status for each typed error code (ok envelopes are 200); the
#: body is ALWAYS a codec-encoded Response — the status is advisory for
#: generic HTTP tooling, the envelope is the contract
STATUS_FOR_ERROR: Dict[str, int] = {
    ERR_BAD_REQUEST: 400,
    ERR_UNAUTHORIZED: 403,
    ERR_UNKNOWN_JOB: 404,
    ERR_QUOTA_EXCEEDED: 429,
    ERR_INTERNAL: 500,
    ERR_SHUTTING_DOWN: 503,
    ERR_TIMEOUT: 504,
}

_REASONS = {200: "OK", 400: "Bad Request", 403: "Forbidden",
            404: "Not Found", 405: "Method Not Allowed",
            413: "Payload Too Large", 429: "Too Many Requests",
            431: "Request Header Fields Too Large",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}


def _ms(seconds: float) -> float:
    return seconds * 1e3 if math.isfinite(seconds) else seconds


class HubEdgeApp:
    """ASGI app serving an ``AsyncHubGateway`` over HTTP.

    ``max_body`` caps the request body (bytes); anything larger answers
    a typed ``bad_request`` envelope with HTTP 413 before the gateway is
    touched.  HTTP-level latency (receive to response) lands in a
    bounded ``ServeStats`` reservoir served back on ``GET /stats``
    alongside every micro-batch lane's snapshot."""

    def __init__(self, gateway: AsyncHubGateway, *,
                 max_body: int = 1 << 20):
        self.gateway = gateway
        self.max_body = int(max_body)
        self.stats = ServeStats()
        self.errors = 0                    # responses with error envelopes
        self.in_flight = 0
        self.draining = False

    # ------------------------- ASGI entry ---------------------------------
    async def __call__(self, scope, receive, send) -> None:
        if scope["type"] == "lifespan":
            await self._lifespan(receive, send)
            return
        if scope["type"] != "http":        # pragma: no cover - ws etc.
            raise RuntimeError(f"unsupported ASGI scope {scope['type']!r}")
        status, body = await self.respond(
            scope["method"], scope["path"],
            lambda: self._read_body(receive))
        await send({"type": "http.response.start", "status": status,
                    "headers": [(b"content-type", b"application/json"),
                                (b"content-length",
                                 str(len(body)).encode("ascii"))]})
        await send({"type": "http.response.body", "body": body})

    async def respond(self, method: str, path: str,
                      read_body) -> Tuple[int, bytes]:
        """One HTTP request through the app: its status and the encoded
        ``Response`` envelope.  ``read_body()`` is awaited only when the
        operation needs the body and returns ``(body, overflow)`` (body
        None if the client vanished).  Both hosts (the ASGI entry above
        and ``EdgeServer``) answer through here."""
        t0 = time.monotonic()
        self.in_flight += 1
        try:
            try:
                status, resp = await self._handle(method, path, read_body)
            except asyncio.CancelledError:
                raise
            except Exception as e:         # noqa: BLE001 — never a raw 500
                status, resp = 500, Response.failure(
                    ERR_INTERNAL, f"{type(e).__name__}: {e}")
            if not resp.ok:
                self.errors += 1
            return status, codec.encode(resp).encode("ascii")
        finally:
            self.in_flight -= 1
            self.stats.record_batch(1)
            self.stats.record_latency(time.monotonic() - t0)

    async def _lifespan(self, receive, send) -> None:
        """Minimal lifespan protocol so uvicorn-style hosts can manage
        the drain: shutdown runs the same path as ``EdgeServer.stop``."""
        while True:
            msg = await receive()
            if msg["type"] == "lifespan.startup":
                await send({"type": "lifespan.startup.complete"})
            elif msg["type"] == "lifespan.shutdown":
                await self.shutdown()
                await send({"type": "lifespan.shutdown.complete"})
                return

    # ------------------------- lifecycle ----------------------------------
    async def shutdown(self, *, drain_timeout_s: float = 30.0) -> None:
        """Drain, then stop the gateway lanes.

        New requests answer ``shutting_down`` envelopes the moment this
        is called; requests already being served — including in-flight
        micro-batch lane dispatches — run to completion (bounded by
        ``drain_timeout_s``), and only then are the lane workers
        stopped, so no accepted request is dropped on the floor."""
        self.draining = True
        deadline = time.monotonic() + drain_timeout_s
        while self.in_flight > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.005)
        await self.gateway.stop()

    # ------------------------- request handling ---------------------------
    async def _handle(self, method, path,
                      read_body) -> Tuple[int, Response]:
        if path == "/healthz":
            if method != "GET":
                return 405, Response.failure(
                    ERR_BAD_REQUEST, f"{method} not allowed on {path}: "
                    "use GET")
            return 200, Response.success(self._health())
        if path == "/stats":
            if method != "GET":
                return 405, Response.failure(
                    ERR_BAD_REQUEST, f"{method} not allowed on {path}: "
                    "use GET")
            return 200, Response.success(self.snapshot())
        if self.draining:
            # introspection stays up through the drain; API operations
            # are refused with the typed envelope so clients fail over
            return 503, Response.failure(
                ERR_SHUTTING_DOWN,
                "edge is draining for shutdown; retry against another "
                "replica")
        op = None
        if path != "/v1":
            if not path.startswith("/v1/"):
                return 404, Response.failure(
                    ERR_BAD_REQUEST,
                    f"no such endpoint: {path!r} (POST /v1/<op> with op in "
                    f"{sorted(OPS)}, GET /healthz, GET /stats)")
            op = path[len("/v1/"):]
            if op not in OPS:
                return 404, Response.failure(
                    ERR_BAD_REQUEST,
                    f"unknown operation {op!r} (known: {sorted(OPS)})")
        if method != "POST":
            return 405, Response.failure(
                ERR_BAD_REQUEST,
                f"{method} not allowed on {path}: API v1 operations are "
                "POST")
        body, overflow = await read_body()
        if overflow:
            return 413, Response.failure(
                ERR_BAD_REQUEST,
                f"request body exceeds the {self.max_body}-byte cap")
        if body is None:
            return 400, Response.failure(
                ERR_BAD_REQUEST, "client disconnected mid-body")
        try:
            request = codec.decode(body.decode("utf-8"))
        except Exception as e:             # noqa: BLE001 — client's bytes
            return 400, Response.failure(
                ERR_BAD_REQUEST,
                f"malformed request body: {type(e).__name__}: {e}")
        inner = request.request if isinstance(request, AuthedRequest) \
            else request
        if op is not None and not isinstance(inner, OPS[op]):
            return 400, Response.failure(
                ERR_BAD_REQUEST,
                f"endpoint /v1/{op} expects a {OPS[op].__name__}, got "
                f"{type(inner).__name__}")
        if type(inner) not in OPS.values():
            return 400, Response.failure(
                ERR_BAD_REQUEST,
                f"not an API v1 request: {type(inner).__name__}")
        resp = await self.gateway.handle_async(request)
        return self._status(resp), resp

    async def _read_body(self, receive) -> Tuple[Optional[bytes], bool]:
        """Accumulate the request body up to ``max_body``; returns
        ``(body, overflow)`` — body is None if the client vanished."""
        chunks = bytearray()
        while True:
            msg = await receive()
            if msg["type"] == "http.disconnect":
                return None, False
            chunks += msg.get("body", b"")
            if len(chunks) > self.max_body:
                return None, True
            if not msg.get("more_body", False):
                return bytes(chunks), False

    # ------------------------- introspection ------------------------------
    def _status(self, resp: Response) -> int:
        return 200 if resp.ok else STATUS_FOR_ERROR.get(resp.error_code, 500)

    def _health(self) -> HealthResult:
        return HealthResult("draining" if self.draining else "ok",
                            API_VERSION,
                            tuple(self.gateway.gateway.hub.jobs()))

    def snapshot(self) -> StatsResult:
        """Server-side serving stats: HTTP-level counters/percentiles
        plus one snapshot per live micro-batch lane."""
        lanes = []
        for name, s in sorted(self.gateway.lane_stats.items()):
            lanes.append(LaneSnapshot(
                name, s.requests, s.batches, s.mean_batch,
                _ms(s.p50), _ms(s.p95), _ms(s.p99)))
        return StatsResult(self.stats.requests, self.errors, self.in_flight,
                           self.draining, _ms(self.stats.p50),
                           _ms(self.stats.p95), _ms(self.stats.p99),
                           tuple(lanes))


class EdgeServer:
    """Minimal asyncio HTTP/1.1 host for ``HubEdgeApp``.

    Speaks exactly what the edge needs over localhost and CI: request
    line + headers, content-length framed bodies (chunked transfer
    encoding is refused with a typed envelope), keep-alive connections,
    requests on one connection answered in order.  ``port=0`` binds an
    ephemeral port (read it back from ``.port`` after ``start``).

    Each connection is an ``asyncio.BufferedProtocol`` that parses its
    requests from the bytes the loop reads for it and writes each answer,
    head and body, in one write; a request runs as one task through
    ``HubEdgeApp.respond``.  The connections read in one turn of the
    event loop are parsed together in the next, and the answers ready in
    one turn (a lane's batch wakes its requests together) are written
    together in the next, so the loop's reads and its sends each run back
    to back instead of between parsing and encoding; on a gVisor host
    that serves the edge workload faster (``scripts/edge_ab.py``).  A
    client that goes away mid-body never reaches the app.  ``stop()`` closes the listener FIRST (new
    connections are refused at the TCP layer), then drains the app —
    requests still arriving on live connections answer
    ``shutting_down`` envelopes — and finally closes whatever
    connections remain."""

    #: header-block cap (the limit asyncio's readuntil would apply);
    #: requests with more header bytes than this answer 431 and close
    MAX_HEAD = 32 * 1024
    #: a refused request's unread body up to this many bytes is skipped
    #: so keep-alive framing survives; a larger one closes the connection
    DRAIN_MAX = 65536

    def __init__(self, app: HubEdgeApp, host: str = "127.0.0.1",
                 port: int = 0):
        self.app = app
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._refusals = _refusals(self.MAX_HEAD)
        # every connection's reads land here first; the loop runs one
        # read at a time, so one buffer serves them all
        self._rbuf = memoryview(bytearray(1 << 16))
        # answers waiting for the next turn's flush, in the order they
        # became ready: (connection, bytes, close after, body still due)
        self._ready = []
        # connections read in this turn, parsed together in the next
        self._unparsed = []

    async def __aenter__(self) -> "EdgeServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def start(self) -> "EdgeServer":
        self._server = await asyncio.get_running_loop().create_server(
            lambda: _Connection(self), self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def _answer_later(self, conn: "_Connection", data: bytes, close: bool,
                      skip: int) -> None:
        """Queue one connection's answer for the flush at the next turn
        of the loop (scheduled by the first answer of this turn)."""
        if not self._ready:
            asyncio.get_running_loop().call_soon(self._flush)
        self._ready.append((conn, data, close, skip))

    def _flush(self) -> None:
        ready, self._ready = self._ready, []
        for conn, data, close, skip in ready:
            conn._sent(data, close, skip)

    def _parse_later(self, conn: "_Connection") -> None:
        """Queue a connection that has read bytes for the parse at the
        next turn of the loop, after this turn's other reads."""
        if not self._unparsed:
            asyncio.get_running_loop().call_soon(self._parse_all)
        self._unparsed.append(conn)

    def _parse_all(self) -> None:
        unparsed, self._unparsed = self._unparsed, []
        for conn in unparsed:
            conn._advance()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()           # refuse NEW connections first
        await self.app.shutdown()          # drain in-flight, stop lanes
        self._flush()                      # answers of the drained requests
        for conn in list(self._conns):     # idle keep-alive stragglers
            conn.close()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None


class _Connection(asyncio.BufferedProtocol):
    """One client connection of an ``EdgeServer``: parse a request from
    the buffered bytes, answer it through the app, then parse the next.
    The loop reads into the server's one receive buffer (no allocation a
    read), and the bytes move to this connection's buffer at once."""

    def __init__(self, server: EdgeServer):
        self.server = server
        self.app = server.app
        self.buf = bytearray()
        self.transport = None
        self.busy = False                  # a request is at the app
        self.skip = 0                      # refused body bytes still due
        self.write_paused = False
        self.read_paused = False
        self.loop = asyncio.get_running_loop()
        # a client that pipelines without reading waits at this cap
        self.cap = server.MAX_HEAD + self.app.max_body + server.DRAIN_MAX

    def connection_made(self, transport) -> None:
        self.transport = transport
        self.server._conns.add(self)

    def connection_lost(self, exc) -> None:
        self.server._conns.discard(self)
        self.transport = None

    def pause_writing(self) -> None:
        self.write_paused = True

    def resume_writing(self) -> None:
        self.write_paused = False
        self._advance()

    def get_buffer(self, sizehint: int) -> memoryview:
        return self.server._rbuf

    def buffer_updated(self, nbytes: int) -> None:
        self.buf += self.server._rbuf[:nbytes]
        self.server._parse_later(self)

    def close(self) -> None:
        if self.transport is not None:
            self.transport.close()

    def _refuse(self, key: str) -> None:
        """Protocol-level refusal (bad head), outside the app."""
        self.transport.write(self.server._refusals[key])
        self.close()

    def _advance(self) -> None:
        self._parse()
        self._flow()

    def _parse(self) -> None:
        max_head = self.server.MAX_HEAD
        while not (self.busy or self.write_paused or self.transport is None
                   or self.transport.is_closing()):
            if self.skip:
                n = min(self.skip, len(self.buf))
                del self.buf[:n]
                self.skip -= n
                if self.skip:
                    break
            # readuntil's limits: no separator within the cap, or one
            # found past it
            i = self.buf.find(b"\r\n\r\n")
            if i < 0:
                if len(self.buf) - 3 > max_head:
                    self._refuse("head")
                break
            if i > max_head:
                self._refuse("head")
                break
            first, _, rest = bytes(self.buf[:i]).partition(b"\r\n")
            parts = first.split(b" ")
            if len(parts) != 3:
                self.close()
                break
            # the three headers the host reads (names case-insensitive,
            # values stripped, the last of a repeated one wins)
            te = connection = b""
            length = None
            for line in rest.split(b"\r\n") if rest else ():
                k, sep, v = line.partition(b":")
                if sep:
                    k = k.strip().lower()
                    if k == b"content-length":
                        length = v.strip()
                    elif k == b"connection":
                        connection = v.strip()
                    elif k == b"transfer-encoding":
                        te = v.strip()
            if te:
                self._refuse("chunked")
                break
            try:
                length = 0 if length is None else int(length)
                if length < 0:
                    raise ValueError
            except ValueError:
                self._refuse("length")
                break
            overflow = length > self.app.max_body
            start = i + 4
            if not overflow and len(self.buf) - start < length:
                break                      # the body is still arriving
            body = b"" if overflow else bytes(self.buf[start:start + length])
            del self.buf[:start if overflow else start + length]
            self.busy = True
            keep_alive = connection.lower() != b"close"
            self.loop.create_task(self._answer(
                parts[0].decode("latin-1").upper(),
                parts[1].split(b"?", 1)[0].decode("latin-1"), keep_alive,
                length, overflow, body))

    def _flow(self) -> None:
        if self.transport is None:
            return
        big = len(self.buf) > self.cap
        if big != self.read_paused:
            self.read_paused = big
            (self.transport.pause_reading if big
             else self.transport.resume_reading)()

    async def _answer(self, method: str, path: str, keep_alive: bool,
                      length: int, overflow: bool, body: bytes) -> None:
        consumed = 0

        async def read_body():
            # an over-cap body counts as read one byte past the cap, as a
            # reader that stops there would have read it
            nonlocal consumed
            consumed = min(length, self.app.max_body + 1) if overflow \
                else length
            return (None, True) if overflow else (body, False)

        status, payload = await self.app.respond(method, path, read_body)
        if self.transport is None:
            return                         # the client went away
        keep = keep_alive and not self.app.draining
        # the body of an over-cap request is still in the buffer
        self.server._answer_later(
            self, http_response(status, payload, keep),
            not keep or length - consumed > self.server.DRAIN_MAX,
            length if overflow else 0)

    def _sent(self, data: bytes, close: bool, skip: int) -> None:
        """Write one answer (from the server's flush), then close or
        parse the next request."""
        if self.transport is None:
            return                         # the client went away
        self.transport.write(data)
        self.busy = False
        if close:
            self.close()
            return
        self.skip = skip
        self._advance()


def http_response(status: int, payload: bytes, keep_alive: bool) -> bytes:
    """The bytes ``EdgeServer`` writes for one answer: status line,
    headers and the encoded envelope."""
    return (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            "content-type: application/json\r\n"
            f"content-length: {len(payload)}\r\n"
            f"connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
            .encode("ascii") + payload)


def _refusals(max_head: int) -> Dict[str, bytes]:
    """The host's protocol-level refusals (bad heads, outside the app):
    whole HTTP responses, each closing its connection."""
    out = {}
    for key, status, detail in (
            ("head", 431, f"request head exceeds {max_head} bytes"),
            ("chunked", 400, "chunked transfer encoding is not supported: "
                             "send content-length framed bodies"),
            ("length", 400, "unparseable content-length")):
        body = codec.encode(Response.failure(ERR_BAD_REQUEST, detail))
        out[key] = http_response(status, body.encode("ascii"), False)
    return out


async def serve_edge(gateway, host: str = "127.0.0.1", port: int = 0, *,
                     max_batch: int = 256, tick_s: float = 0.0,
                     timeout_s: Optional[float] = None,
                     max_body: int = 1 << 20
                     ) -> Tuple[HubEdgeApp, EdgeServer]:
    """One-call edge bring-up: wrap a ``HubGateway`` in lanes, an app,
    and a bound listening server (ephemeral port with ``port=0``)."""
    agw = AsyncHubGateway(gateway, max_batch=max_batch, tick_s=tick_s,
                          timeout_s=timeout_s)
    app = HubEdgeApp(agw, max_body=max_body)
    server = await EdgeServer(app, host, port).start()
    return app, server


def _demo_gateway(jobs=("grep", "sort"), device="cuda"):
    """A hub of emulated Spark jobs for the quickstart CLI; its predictors
    fit and predict on ``device`` ("cpu" must be asked for)."""
    from repro_torch.core.datastore import RuntimeDataStore
    from repro_torch.core.hub import Hub, JobRepo
    from repro_torch.workloads import spark_emul as W
    hub = Hub()
    for job in jobs:
        d = W.generate_job_data(job)
        hub.publish(JobRepo(job, job, d.schema,
                            RuntimeDataStore(d, seed=0, device=device),
                            predictor_kw=dict(pad_rows=True,
                                              max_cv_folds=15,
                                              device=device)))
    prices = {m.name: m.price for m in W.MACHINES.values()}
    return hub.gateway(prices, (2, 3, 4, 6, 8, 12, 16))


def warm(gateway) -> int:
    """Fit every published (job, machine) predictor and answer one choose
    per job (which builds the job's configuration service), so no
    request's lane pays a fit; returns the number of predictors warmed."""
    n = 0
    for job in gateway.hub.jobs():
        repo = gateway.hub.get(job)
        for m in repo.store.data.present_machines():
            repo.predictor_for(m, seed=gateway.seed)
            n += 1
        row = tuple(float(x) for x in repo.store.data.X[0][1:])
        resp = gateway.handle(ChooseRequest(job, row, t_max=math.nan))
        if not resp.ok:
            raise RuntimeError(f"warm-up choose for {job!r} failed: "
                               f"{resp.error_code}: {resp.detail}")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serve a demo C3O hub (emulated Spark jobs) over HTTP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--jobs", default="grep,sort",
                    help="comma-separated emulated jobs to publish")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help='where predictors fit and predict ("cpu" must be '
                         "asked for; there is no fallback)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA card is "
                             "available (pass --device cpu to serve on "
                             "the CPU)")

    async def run():
        gw = _demo_gateway(tuple(j for j in args.jobs.split(",") if j),
                           device=args.device)
        warm(gw)
        app, server = await serve_edge(gw, args.host, args.port,
                                       max_batch=args.max_batch)
        print(f"edge listening on http://{args.host}:{server.port} "
              f"jobs={args.jobs} device={args.device}", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
