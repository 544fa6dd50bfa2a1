"""The port's serving edge over a REAL localhost socket, on the CPU:
``tests/test_edge.py``'s contracts (typed envelopes on every path,
byte-for-byte parity between the HTTP path and the in-process gateway,
predict-lane survival under interleaved bad requests, drain on shutdown,
the load generator's determinism and reporting), then the port's own:
the load generator's byte stream and the edge's refusal envelopes are
the JAX package's bytes, the seeded edge stream coalesces (predict-lane
mean batch > 1) with every HTTP body equal to the in-process envelope,
and the CLI serves on the card unless asked for the CPU.  The
socket-to-in-process throughput ratio is gated on the card
(``chip_smoke.py`` edge), not here, where it is noise."""
import asyncio

import numpy as np
import pytest

from repro_torch.api import (AsyncHubGateway, HubGateway, PredictRequest,
                             Response, decode, encode)
from repro_torch.api.types import (ERR_BAD_REQUEST, ERR_SHUTTING_DOWN,
                             ChooseRequest, HealthResult, StatsResult)
from repro_torch.core.datastore import RuntimeDataStore
from repro_torch.core.hub import Hub, JobRepo
from repro_torch.serve.edge import serve_edge
from repro_torch.serve.loadgen import _request, build_workload, run_loadgen
from repro_torch.workloads import spark_emul as W

SCALEOUTS = (2, 3, 4, 6, 8, 12, 16)
PRICES = {m.name: m.price for m in W.MACHINES.values()}

CHOOSE_BODY = encode(ChooseRequest("grep", (15.0, 0.02),
                                   t_max=400.0)).encode("ascii")


@pytest.fixture(scope="module")
def gw():
    hub = Hub()
    d = W.generate_job_data("grep")
    hub.publish(JobRepo("grep", "grep", d.schema,
                        RuntimeDataStore(d, seed=0, device="cpu"),
                        predictor_kw={"device": "cpu", "max_cv_folds": 15}))
    return HubGateway(hub, PRICES, SCALEOUTS)


async def _conn(server):
    return await asyncio.open_connection(server.host, server.port)


def _decode(payload: bytes) -> Response:
    resp = decode(payload.decode("utf-8"))
    assert isinstance(resp, Response)
    return resp


# --------------------------------------------------------------------------
# health / stats / happy path
# --------------------------------------------------------------------------

def test_healthz_stats_and_ops_over_one_keepalive_connection(gw):
    async def drive():
        app, server = await serve_edge(gw)
        try:
            reader, writer = await _conn(server)
            status, payload = await _request(reader, writer, "GET",
                                             "/healthz")
            assert status == 200
            health = _decode(payload)
            assert health.ok and isinstance(health.result, HealthResult)
            assert health.result.status == "ok"
            assert health.result.jobs == ("grep",)

            # a choose and a single-row predict on the SAME connection
            status, payload = await _request(reader, writer, "POST",
                                             "/v1/choose", CHOOSE_BODY)
            assert status == 200 and _decode(payload).ok
            body = encode(PredictRequest(
                "grep", "m5.xlarge", ((4.0, 15.0, 0.02),))).encode("ascii")
            status, payload = await _request(reader, writer, "POST",
                                             "/v1/predict", body)
            assert status == 200
            predict = _decode(payload)
            assert predict.ok and len(predict.result.runtimes_s) == 1

            # generic /v1 routes on the envelope's __type__
            status, payload = await _request(reader, writer, "POST", "/v1",
                                             body)
            assert status == 200 and _decode(payload).ok

            status, payload = await _request(reader, writer, "GET",
                                             "/stats")
            assert status == 200
            stats = _decode(payload)
            assert stats.ok and isinstance(stats.result, StatsResult)
            assert stats.result.requests >= 4
            assert stats.result.errors == 0 and not stats.result.draining
            assert "grep@m5.xlarge" in {ln.lane for ln in stats.result.lanes}
            writer.close()
        finally:
            await server.stop()

    asyncio.run(drive())


def test_http_path_matches_inproc_gateway_byte_for_byte(gw):
    """The acceptance criterion: the same seeded request stream answers
    byte-identically over the socket and through the in-process
    gateway."""
    workload = build_workload(32, jobs=("grep",), seed=11)

    async def drive():
        app, server = await serve_edge(gw)
        try:
            reader, writer = await _conn(server)
            http = []
            for path, body in workload:
                status, payload = await _request(reader, writer, "POST",
                                                 path, body)
                assert status == 200
                http.append(payload)
            writer.close()
        finally:
            await server.stop()
        async with AsyncHubGateway(gw) as agw:
            inproc = [await agw.handle_async(decode(body.decode()))
                      for _, body in workload]
        return http, inproc

    http, inproc = asyncio.run(drive())
    for got, want in zip(http, inproc):
        assert got == encode(want).encode("ascii")


# --------------------------------------------------------------------------
# malformed-body hardening (satellite: typed envelopes, never raw 500s)
# --------------------------------------------------------------------------

def test_malformed_bodies_answer_typed_envelopes_and_keepalive_survives(gw):
    cases = [
        # (path, body, expected HTTP status, detail fragment)
        ("/v1/choose", b'{"__type__": "ChooseReq', 400, "malformed"),
        ("/v1/choose", b'{"__type__": "NopeRequest"}', 400, "malformed"),
        ("/v1/choose", b"[1, 2, 3]", 400, "expects a ChooseRequest"),
        ("/v1/choose",
         encode(PredictRequest("grep", "m5.xlarge",
                               ((4.0, 15.0, 0.02),))).encode(),
         400, "expects a ChooseRequest"),
        ("/v1", encode(Response.success(None)).encode(), 400,
         "not an API v1 request"),
        ("/v1/teleport", CHOOSE_BODY, 404, "unknown operation"),
        ("/nope", CHOOSE_BODY, 404, "no such endpoint"),
    ]

    async def drive():
        app, server = await serve_edge(gw)
        try:
            reader, writer = await _conn(server)
            for path, body, want_status, fragment in cases:
                status, payload = await _request(reader, writer, "POST",
                                                 path, body)
                resp = _decode(payload)
                assert status == want_status, (path, status)
                assert not resp.ok and resp.error_code == ERR_BAD_REQUEST
                assert fragment in resp.detail, (path, resp.detail)
            # wrong methods are envelopes too
            status, payload = await _request(reader, writer, "GET",
                                             "/v1/choose")
            assert status == 405 and not _decode(payload).ok
            status, payload = await _request(reader, writer, "POST",
                                             "/healthz")
            assert status == 405 and not _decode(payload).ok
            # the SAME connection still serves a good request after all
            # of the above (keep-alive framing survived every refusal)
            status, payload = await _request(reader, writer, "POST",
                                             "/v1/choose", CHOOSE_BODY)
            assert status == 200 and _decode(payload).ok
            stats = app.snapshot()
            assert stats.errors == len(cases) + 2
            writer.close()
        finally:
            await server.stop()

    asyncio.run(drive())


def test_oversized_body_answers_typed_413_within_the_cap(gw):
    async def drive():
        app, server = await serve_edge(gw, max_body=2048)
        try:
            reader, writer = await _conn(server)
            status, payload = await _request(reader, writer, "POST",
                                             "/v1/choose", b"x" * 4096)
            resp = _decode(payload)
            assert status == 413
            assert resp.error_code == ERR_BAD_REQUEST
            assert "2048-byte cap" in resp.detail
            # small overshoot was drained: the connection still serves
            status, payload = await _request(reader, writer, "POST",
                                             "/v1/choose", CHOOSE_BODY)
            assert status == 200 and _decode(payload).ok
            writer.close()
        finally:
            await server.stop()

    asyncio.run(drive())


def test_protocol_refusals_are_typed_envelopes(gw):
    """Below the ASGI app: chunked transfer encoding and unparseable
    content-length are refused with codec envelopes, not dropped."""

    async def raw_exchange(server, head: bytes):
        reader, writer = await _conn(server)
        writer.write(head)
        await writer.drain()
        raw = await reader.readuntil(b"\r\n\r\n")
        status = int(raw.split(b" ", 2)[1])
        length = 0
        for line in raw.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                length = int(line.split(b":", 1)[1])
        payload = await reader.readexactly(length)
        writer.close()
        return status, payload

    async def drive():
        app, server = await serve_edge(gw)
        try:
            status, payload = await raw_exchange(
                server, b"POST /v1/choose HTTP/1.1\r\n"
                        b"transfer-encoding: chunked\r\n\r\n")
            assert status == 400
            assert "chunked" in _decode(payload).detail
            status, payload = await raw_exchange(
                server, b"POST /v1/choose HTTP/1.1\r\n"
                        b"content-length: banana\r\n\r\n")
            assert status == 400
            assert "content-length" in _decode(payload).detail
        finally:
            await server.stop()

    asyncio.run(drive())


def test_bad_request_interleaved_with_good_on_the_same_predict_lane(gw):
    """A wrong-width predict row riding the same lane tick as good
    single-row predicts fails ALONE (typed bad_request); the good ones
    are answered and the lane keeps serving afterwards."""
    good_body = encode(PredictRequest(
        "grep", "m5.xlarge", ((4.0, 15.0, 0.02),))).encode("ascii")
    bad_body = encode(PredictRequest(
        "grep", "m5.xlarge", ((4.0, 15.0),))).encode("ascii")

    async def one(server, body):
        reader, writer = await _conn(server)
        try:
            return await _request(reader, writer, "POST", "/v1/predict",
                                  body)
        finally:
            writer.close()

    async def drive():
        app, server = await serve_edge(gw, tick_s=0.005)
        try:
            results = await asyncio.gather(
                one(server, good_body), one(server, bad_body),
                one(server, good_body), one(server, good_body))
            # and the lane still serves after the poisoned tick
            late_status, late_payload = await one(server, good_body)
            return results, (late_status, late_payload)
        finally:
            await server.stop()

    results, (late_status, late_payload) = asyncio.run(drive())
    statuses = sorted(s for s, _ in results)
    assert statuses == [200, 200, 200, 400]
    bad = [_decode(p) for s, p in results if s == 400]
    assert bad[0].error_code == ERR_BAD_REQUEST
    goods = [_decode(p) for s, p in results if s == 200]
    assert all(g.ok for g in goods)
    assert late_status == 200 and _decode(late_payload).ok


# --------------------------------------------------------------------------
# shutdown drain (satellite: in-flight finishes, new work refused)
# --------------------------------------------------------------------------

def test_shutdown_drains_inflight_and_refuses_new_requests(gw):
    async def drive():
        # a long lane tick holds the in-flight predict open across the
        # start of the drain
        app, server = await serve_edge(gw, tick_s=0.25)
        body = encode(PredictRequest(
            "grep", "m5.xlarge", ((4.0, 15.0, 0.02),))).encode("ascii")

        r1, w1 = await _conn(server)       # will carry the in-flight op
        r2, w2 = await _conn(server)       # opened BEFORE the drain
        inflight = asyncio.ensure_future(
            _request(r1, w1, "POST", "/v1/predict", body))
        await asyncio.sleep(0.05)          # request accepted, tick pending
        assert app.in_flight == 1
        stopping = asyncio.ensure_future(server.stop())
        await asyncio.sleep(0.02)          # draining flag is up
        assert app.draining

        # a request mid-shutdown on a live connection: typed refusal
        status, payload = await _request(r2, w2, "POST", "/v1/predict",
                                         body)
        refused = _decode(payload)
        assert status == 503
        assert refused.error_code == ERR_SHUTTING_DOWN

        # the in-flight dispatch completed with a real answer
        status, payload = await inflight
        assert status == 200
        done = _decode(payload)
        assert done.ok and len(done.result.runtimes_s) == 1
        await stopping
        for w in (w1, w2):
            w.close()

        # new connections are refused at the TCP layer once stopped
        with pytest.raises(OSError):
            await _conn(server)

    asyncio.run(drive())


def test_health_reports_draining_during_drain(gw):
    async def drive():
        app, server = await serve_edge(gw)
        try:
            reader, writer = await _conn(server)
            app.draining = True            # simulate mid-drain
            status, payload = await _request(reader, writer, "GET",
                                             "/healthz")
            health = _decode(payload)
            assert status == 200 and health.ok
            assert health.result.status == "draining"
            writer.close()
            # draining responses carry connection: close — reconnect
            reader, writer = await _conn(server)
            status, payload = await _request(reader, writer, "POST",
                                             "/v1/choose", CHOOSE_BODY)
            assert status == 503
            assert _decode(payload).error_code == ERR_SHUTTING_DOWN
            writer.close()
        finally:
            app.draining = False
            await server.stop()

    asyncio.run(drive())


# --------------------------------------------------------------------------
# the host's framing: pipelining, the head cap, refused bodies
# --------------------------------------------------------------------------

async def _read_response(reader):
    raw = await reader.readuntil(b"\r\n\r\n")
    status = int(raw.split(b" ", 2)[1])
    length = 0
    for line in raw.split(b"\r\n"):
        if line.lower().startswith(b"content-length:"):
            length = int(line.split(b":", 1)[1])
    return status, raw, await reader.readexactly(length)


def test_pipelined_requests_are_answered_in_order(gw):
    """Three requests in one write on one connection: three answers, in
    the order asked, the connection still open after them."""
    async def drive():
        app, server = await serve_edge(gw)
        try:
            reader, writer = await _conn(server)
            writer.write(
                b"GET /healthz HTTP/1.1\r\nhost: t\r\n\r\n"
                + b"POST /v1/choose HTTP/1.1\r\ncontent-length: "
                + str(len(CHOOSE_BODY)).encode() + b"\r\n\r\n"
                + CHOOSE_BODY
                + b"GET /stats HTTP/1.1\r\n\r\n")
            out = [await _read_response(reader) for _ in range(3)]
            writer.write(b"GET /healthz HTTP/1.1\r\n\r\n")
            again = await _read_response(reader)
            writer.close()
            return out, again
        finally:
            await server.stop()

    out, again = asyncio.run(drive())
    assert [s for s, _, _ in out] == [200, 200, 200]
    kinds = [type(_decode(p).result).__name__ for _, _, p in out]
    assert kinds == ["HealthResult", "ChooseResult", "StatsResult"]
    assert all(b"connection: keep-alive" in raw for _, raw, _ in out)
    assert again[0] == 200


@pytest.mark.parametrize("head", [
    b"GET /healthz HTTP/1.1\r\nx-pad: " + b"a" * (40 * 1024),
    b"GET /healthz HTTP/1.1\r\nx-pad: " + b"a" * (40 * 1024)
    + b"\r\n\r\n"], ids=["no_end_of_head", "end_past_the_cap"])
def test_head_over_the_cap_answers_431_and_closes(gw, head):
    async def drive():
        app, server = await serve_edge(gw)
        try:
            reader, writer = await _conn(server)
            writer.write(head)
            status, raw, payload = await _read_response(reader)
            rest = await reader.read()             # EOF: closed by the host
            writer.close()
            return status, raw, payload, rest
        finally:
            await server.stop()

    status, raw, payload, rest = asyncio.run(drive())
    assert status == 431 and b"connection: close" in raw
    resp = _decode(payload)
    assert resp.error_code == ERR_BAD_REQUEST
    assert "32768 bytes" in resp.detail
    assert rest == b""


@pytest.mark.parametrize("size,kept", [(0, True), (1000, True),
                                       (65536, True), (65537, False),
                                       (70000, False)])
def test_a_refused_body_is_skipped_up_to_64_kib(gw, size, kept):
    """An unknown path answers 404 without reading the body; up to 64
    KiB of it is skipped and the connection serves on, more closes it
    (the body still fits under the 1 MiB cap)."""
    async def drive():
        app, server = await serve_edge(gw)
        try:
            reader, writer = await _conn(server)
            writer.write(b"POST /nope HTTP/1.1\r\ncontent-length: "
                         + str(size).encode() + b"\r\n\r\n" + b"z" * size)
            status, raw, payload = await _read_response(reader)
            if kept:
                writer.write(b"GET /healthz HTTP/1.1\r\n\r\n")
                after = (await _read_response(reader))[0]
            else:
                after = await reader.read()
            writer.close()
            return status, payload, after
        finally:
            await server.stop()

    status, payload, after = asyncio.run(drive())
    assert status == 404
    assert _decode(payload).error_code == ERR_BAD_REQUEST
    assert after == (200 if kept else b"")


TURN_ROWS = ((4.0, 15.0, 0.02), (6.0, 15.0, 0.02), (8.0, 20.0, 0.02),
             (2.0, 10.0, 0.02))


def test_one_turns_reads_are_parsed_and_its_answers_written_together(gw):
    """Four requests on four connections, sent in one turn: the host
    parses them in one pass and, their lane batch answered, writes the
    four answers in one flush, each the in-process envelope's bytes; a
    ``connection: close`` answer closes its connection after its bytes."""
    bodies = [encode(PredictRequest("grep", "m5.xlarge", (row,)))
              .encode("ascii") for row in TURN_ROWS]

    async def drive():
        app, server = await serve_edge(gw, tick_s=0.05)
        parsed, flushed = [], []
        parse_all, flush = server._parse_all, server._flush

        def count_parsed():
            parsed.append(len(server._unparsed))
            parse_all()

        def count_flushed():
            flushed.append(len(server._ready))
            flush()

        server._parse_all, server._flush = count_parsed, count_flushed
        try:
            conns = [await _conn(server) for _ in bodies]
            for k, ((_, w), body) in enumerate(zip(conns, bodies)):
                close = b"connection: close\r\n" if k == 3 else b""
                w.write(b"POST /v1/predict HTTP/1.1\r\n" + close
                        + b"content-length: " + str(len(body)).encode()
                        + b"\r\n\r\n" + body)
            out = [await _read_response(r) for r, _ in conns]
            tail = await conns[3][0].read()
            for _, w in conns:
                w.close()
            return out, tail, parsed, flushed
        finally:
            await server.stop()

    out, tail, parsed, flushed = asyncio.run(drive())
    expected = [encode(gw.handle(decode(b.decode("ascii")))).encode("ascii")
                for b in bodies]
    assert [s for s, _, _ in out] == [200] * 4
    assert [p for _, _, p in out] == expected
    assert b"connection: close" in out[3][1] and tail == b""
    assert parsed[0] == 4 and flushed[0] == 4


# --------------------------------------------------------------------------
# closed-loop load generator
# --------------------------------------------------------------------------

def test_build_workload_is_seed_deterministic():
    a = build_workload(48, jobs=("grep", "sort"), seed=5)
    b = build_workload(48, jobs=("grep", "sort"), seed=5)
    c = build_workload(48, jobs=("grep", "sort"), seed=6)
    assert a == b
    assert a != c
    assert all(body.decode("ascii") and path.startswith("/v1/")
               for path, body in a)


def test_loadgen_closed_loop_reports_and_coalesces(gw):
    async def drive():
        app, server = await serve_edge(gw, tick_s=0.002)
        try:
            return await run_loadgen(server.host, server.port,
                                     connections=8, requests=96,
                                     jobs=("grep",), seed=2)
        finally:
            await server.stop()

    report = asyncio.run(drive())
    assert report.requests == 96 and report.errors == 0
    assert report.connections == 8
    assert report.rps > 0 and report.wall_s > 0
    assert 0 < report.p50_ms <= report.p95_ms <= report.p99_ms
    assert sum(report.op_counts.values()) == 96
    assert report.server is not None       # /stats snapshot rode along
    assert report.server.requests >= 96
    assert report.predict_mean_batch() >= 1.0
    d = report.to_json()
    assert d["requests"] == 96 and "server" in d


def test_loadgen_empty_window_reports_nan_via_float_tags():
    """A rep window with zero completed requests (warmup-only short runs)
    reports NaN throughput — never a division by zero or an infinity —
    and ``to_json`` carries it as a strict-JSON float tag."""
    import json
    import math

    # requests=0 -> no workers even run; port 1 is never connected
    report = asyncio.run(run_loadgen("127.0.0.1", 1, connections=4,
                                     requests=0, jobs=("grep",), seed=0))
    assert report.requests == 0 and report.server is None
    assert math.isnan(report.rps)
    assert math.isnan(report.p50_ms) and math.isnan(report.p99_ms)
    d = report.to_json()
    assert d["rps"] == {"__float__": "nan"}
    json.dumps(d, allow_nan=False)         # strict JSON end to end


# --------------------------------------------------------------------------
# the port against the JAX package, and the demo gateway
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,jobs,seed,mix", [
    (64, ("grep", "sort"), 0, None), (48, ("grep",), 5, None),
    (32, ("sort", "grep"), 3, (("predict", 1.0),)),
    (40, ("grep", "sort"), 1, (("choose", 0.5), ("search", 0.5)))])
def test_load_stream_is_the_reference_bytes(n, jobs, seed, mix):
    from repro.serve.loadgen import build_workload as ref_build
    kw = {} if mix is None else {"mix": mix}
    assert build_workload(n, jobs=jobs, seed=seed, **kw) == \
        ref_build(n, jobs=jobs, seed=seed, **kw)


def test_refusal_envelopes_are_the_reference_bytes(gw):
    """Drain refusals, unknown paths and ops, wrong methods, malformed and
    oversized bodies, a body of the wrong type: the HTTP status and body
    are the JAX package's edge's on the same bytes."""
    from repro.api import HubGateway as RefGateway
    from repro.core.datastore import RuntimeDataStore as RefStore
    from repro.core.hub import Hub as RefHub
    from repro.core.hub import JobRepo as RefRepo
    from repro.serve.edge import serve_edge as ref_serve_edge
    ref_hub = RefHub()
    d = W.generate_job_data("grep")
    ref_hub.publish(RefRepo("grep", "grep", d.schema, RefStore(d, seed=0)))
    ref_gw = RefGateway(ref_hub, PRICES, SCALEOUTS)
    cases = [("GET", "/nope", b""), ("POST", "/v1/frobnicate", b"{}"),
             ("GET", "/v1/choose", b""), ("POST", "/healthz", b""),
             ("POST", "/v1/choose", b"{not json"),
             ("POST", "/v1/choose", b"x" * 300),
             ("POST", "/v1/predict", CHOOSE_BODY),
             ("POST", "/v1", b'{"__type__":"HealthResult","status":"ok",'
                             b'"api_version":"v1","jobs":[]}'),
             ("POST", "/v1/choose", encode(ChooseRequest(
                 "nope", (1.0, 2.0))).encode("ascii")),
             ("GET", "/healthz", b"")]

    async def drive(serve, gateway):
        app, server = await serve(gateway, max_body=256)
        try:
            out = []
            for m, p, b in cases:           # a connection each: some close
                reader, writer = await _conn(server)
                out.append(await _request(reader, writer, m, p, b))
                writer.close()
            app.draining = True
            reader, writer = await _conn(server)
            out.append(await _request(reader, writer, "POST", "/v1/choose",
                                      CHOOSE_BODY))
            writer.close()                  # a draining edge closes it
            reader, writer = await _conn(server)
            out.append(await _request(reader, writer, "GET", "/healthz"))
            writer.close()
        finally:
            app.draining = False
            await server.stop()
        return out

    got = asyncio.run(drive(serve_edge, gw))
    want = asyncio.run(drive(ref_serve_edge, ref_gw))
    assert got == want
    assert [s for s, _ in got] == [404, 404, 405, 405, 400, 413, 400, 400,
                                   404, 200, 503, 200]
    assert _decode(got[-2][1]).error_code == ERR_SHUTTING_DOWN


@pytest.fixture(scope="module")
def demo():
    from repro_torch.serve.edge import _demo_gateway, warm
    gw = _demo_gateway(("grep", "sort"), device="cpu")
    assert warm(gw) == 6
    return gw


def test_seeded_stream_coalesces_and_answers_the_inproc_bytes(demo):
    """The card's edge phase at the CPU: 1024 seeded requests at 64
    connections through the demo gateway; no errors, predict-lane mean
    batch > 1, and every HTTP body the in-process envelope's bytes."""
    workload = build_workload(1024, jobs=("grep", "sort"), seed=0)

    async def drive():
        app, server = await serve_edge(demo, tick_s=0.004)
        try:
            report = await run_loadgen(server.host, server.port,
                                       connections=64, workload=workload)
            reader, writer = await _conn(server)
            http = [(await _request(reader, writer, "POST", p, b))[1]
                    for p, b in workload]
            writer.close()
        finally:
            await server.stop()
        sem = asyncio.Semaphore(64)

        async def one(agw, q):
            async with sem:
                return await agw.handle_async(q)

        async with AsyncHubGateway(demo, tick_s=0.004) as agw:
            inproc = await asyncio.gather(*[
                one(agw, decode(b.decode("ascii"))) for _, b in workload])
        return report, http, inproc

    report, http, inproc = asyncio.run(drive())
    assert report.errors == 0 and report.requests == 1024
    assert report.predict_mean_batch() > 1.0
    assert [h for h in http] == [encode(r).encode("ascii") for r in inproc]


def test_cli_serves_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``python -m repro_torch.serve.edge`` defaults to cuda and refuses
    to start without a card; there is no silent CPU fallback."""
    import torch
    from repro_torch.serve import edge
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(edge, "_demo_gateway",
                        lambda *a, **k: built.append(k) or None)
    for argv in ([], ["--device", "cuda"], ["--device", "cuda:0"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            edge.main(argv)
    assert built == []
