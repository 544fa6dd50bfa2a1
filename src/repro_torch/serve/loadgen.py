"""Closed-loop load generator for the serving edge.

Drives a live edge (``repro_torch.serve.edge``) over a REAL socket: N
concurrent keep-alive connections, each looping request -> full response
-> next request (closed loop), over a seeded deterministic workload of
typed API v1 envelopes (single-row predicts + chooses + searches across
a job mix).  Reports client-side req/s and p50/p95/p99 latency, then
pulls ``GET /stats`` so the realized per-lane micro-batch sizes and
server-side percentiles ride in the same report — the socket-level
numbers the ROADMAP's "millions of users" claim needs.

The default op mix is READ-ONLY (predict/choose/search): the same
workload replayed against the same store is byte-deterministic, which is
what lets ``chip_smoke.py``'s ``edge`` phase assert byte-identical responses
between the HTTP path and the in-process gateway.

CLI (against an already-running edge):

    PYTHONPATH=src python -m repro_torch.serve.loadgen --port 8787 \\
        --connections 64 --requests 4096
"""
from __future__ import annotations

import argparse
import asyncio
import json
import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import codec
from repro_torch.api.types import (ChooseRequest, PredictRequest,
                                   SearchRequest, StatsResult)

#: default op mix (weights): mostly the two dispatch-bound hot paths
DEFAULT_MIX: Tuple[Tuple[str, float], ...] = (
    ("predict", 0.5), ("choose", 0.45), ("search", 0.05))


def build_workload(n: int, *, jobs: Sequence[str] = ("grep", "sort"),
                   seed: int = 0,
                   mix: Sequence[Tuple[str, float]] = DEFAULT_MIX,
                   ) -> List[Tuple[str, bytes]]:
    """Seeded deterministic request stream: ``n`` (path, body) pairs.

    Rows are drawn from each job's emulated measurement grid
    (``spark_emul``), so every request is schema-valid for its job:
    predicts take one stored feature row (scale-out first), chooses take
    the row's context with a deadline jittered around feasibility.  The
    same (n, jobs, seed, mix) always builds the same byte stream."""
    from repro_torch.workloads import spark_emul as W
    rng = np.random.default_rng(seed)
    pools = {}
    for job in jobs:
        d = W.generate_job_data(job)
        pools[job] = d
    ops, weights = zip(*mix)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    out: List[Tuple[str, bytes]] = []
    for _ in range(n):
        op = ops[int(rng.choice(len(ops), p=w))]
        job = jobs[int(rng.integers(0, len(jobs)))]
        d = pools[job]
        i = int(rng.integers(0, len(d)))
        row = tuple(float(v) for v in d.X[i])
        if op == "predict":
            req = PredictRequest(job, str(d.machine_type[i]), (row,))
        elif op == "choose":
            t_max = math.nan if rng.random() < 0.25 \
                else float(d.y[i] * rng.uniform(1.2, 3.0))
            req = ChooseRequest(job, row[1:], t_max=t_max)
        else:
            req = SearchRequest(job if rng.random() < 0.5 else "")
        out.append((f"/v1/{op}", codec.encode(req).encode("ascii")))
    return out


@dataclass(frozen=True)
class LoadReport:
    """One closed-loop run: client-side throughput/latency plus the
    server's own ``StatsResult`` snapshot pulled after the run."""
    requests: int
    ok: int
    errors: int
    connections: int
    wall_s: float
    rps: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    op_counts: Dict[str, int]
    server: Optional[StatsResult]

    def predict_mean_batch(self) -> float:
        """Realized request-weighted mean micro-batch over the server's
        predict lanes (named ``job@machine``); 0.0 without a snapshot."""
        if self.server is None:
            return 0.0
        req = bat = 0
        for lane in self.server.lanes:
            if "@" in lane.lane:
                req += lane.requests
                bat += lane.batches
        return req / bat if bat else 0.0

    def to_json(self) -> dict:
        d = {k: getattr(self, k) for k in
             ("requests", "ok", "errors", "connections", "wall_s", "rps",
              "p50_ms", "p95_ms", "p99_ms", "op_counts")}
        if self.server is not None:
            d["server"] = json.loads(codec.encode(self.server))
            d["predict_mean_batch"] = self.predict_mean_batch()
        # through the strict-JSON codec: an empty-window report carries
        # NaN rps/percentiles, which must travel as float-tag objects
        # ({"__float__": "nan"}), not the non-standard NaN literal
        return json.loads(codec.encode(d))


def _head(method: str, path: str, length: int) -> bytes:
    return (f"{method} {path} HTTP/1.1\r\n"
            "host: edge\r\n"
            "content-type: application/json\r\n"
            f"content-length: {length}\r\n\r\n").encode("ascii")


async def _request(reader: asyncio.StreamReader,
                   writer: asyncio.StreamWriter, method: str, path: str,
                   body: bytes = b"") -> Tuple[int, bytes]:
    """One HTTP/1.1 exchange on an open keep-alive connection."""
    writer.write(_head(method, path, len(body)) + body)
    await writer.drain()
    raw = await reader.readuntil(b"\r\n\r\n")
    lines = raw.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ")[1])
    length = 0
    for line in lines[1:]:
        k, _, v = line.partition(":")
        if k.strip().lower() == "content-length":
            length = int(v.strip())
    payload = await reader.readexactly(length) if length else b""
    return status, payload


async def fetch_stats(host: str, port: int) -> Optional[StatsResult]:
    """One-shot ``GET /stats``, decoded; None if the edge is gone."""
    try:
        reader, writer = await asyncio.open_connection(host, port)
    except OSError:
        return None
    try:
        _, payload = await _request(reader, writer, "GET", "/stats")
        resp = codec.decode(payload.decode("utf-8"))
        return resp.result if resp.ok else None
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


class _ClosedLoop(asyncio.BufferedProtocol):
    """One keep-alive connection playing its share of the workload: it
    writes a request, and on each full response records it and writes
    the next, from the protocol's own callbacks (no task per request).
    Reads land in the run's one receive buffer (``rbuf``), shared by the
    connections since the loop runs one read at a time."""

    def __init__(self, items, record, done: asyncio.Future,
                 rbuf: memoryview):
        self.items, self.record, self.done = items, record, done
        self.rbuf = rbuf
        self.k = 0
        self.buf = b""
        self.t0 = 0.0
        self.transport = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        self._next()

    def _next(self) -> None:
        if self.k == len(self.items):
            self.transport.close()
            return
        self.t0 = time.monotonic()
        self.transport.write(self.items[self.k][1])

    def get_buffer(self, sizehint: int) -> memoryview:
        return self.rbuf

    def buffer_updated(self, nbytes: int) -> None:
        data = bytes(self.rbuf[:nbytes])
        buf = self.buf + data if self.buf else data
        i = buf.find(b"\r\n\r\n")
        if i < 0:
            self.buf = buf
            return
        head = buf[:i].lower()
        length = 0
        j = head.find(b"\r\ncontent-length:")
        if j >= 0:
            e = head.find(b"\r\n", j + 17)
            length = int(head[j + 17:e if e >= 0 else i])
        end = i + 4 + length
        if len(buf) < end:
            self.buf = buf
            return
        self.buf = buf[end:]
        sp = buf.find(b" ")                 # status line: HTTP/1.1 NNN ...
        self.record(time.monotonic() - self.t0, int(buf[sp + 1:sp + 4]),
                    self.items[self.k][0])
        self.k += 1
        self._next()

    def connection_lost(self, exc) -> None:
        if self.done.done():
            return
        if self.k == len(self.items):
            self.done.set_result(None)
        else:
            self.done.set_exception(exc or ConnectionResetError(
                f"the edge closed the connection after {self.k} of "
                f"{len(self.items)} requests"))


async def run_loadgen(host: str, port: int, *, connections: int = 64,
                      requests: int = 2048,
                      jobs: Sequence[str] = ("grep", "sort"), seed: int = 0,
                      mix: Sequence[Tuple[str, float]] = DEFAULT_MIX,
                      workload: Optional[List[Tuple[str, bytes]]] = None,
                      ) -> LoadReport:
    """Closed-loop run: the fixed request budget is partitioned
    round-robin across ``connections`` keep-alive sockets; every
    connection plays its share strictly sequentially (send, await the
    full response, send the next), so concurrency — and therefore the
    coalescing pressure on the server's micro-batch lanes — is exactly
    the connection count.  The requests' bytes (``_request``'s head and
    the body) are laid out before the clock starts."""
    if workload is None:
        workload = build_workload(requests, jobs=jobs, seed=seed, mix=mix)
    wire = [(path.rsplit("/", 1)[-1], _head("POST", path, len(body)) + body)
            for path, body in workload]
    shares = [wire[c::connections] for c in range(connections)]
    latencies: List[float] = []
    statuses: List[int] = []
    op_counts: Dict[str, int] = {}

    def record(seconds: float, status: int, op: str) -> None:
        latencies.append(seconds)
        statuses.append(status)
        op_counts[op] = op_counts.get(op, 0) + 1

    rbuf = memoryview(bytearray(1 << 16))

    async def worker(items):
        loop = asyncio.get_running_loop()
        done = loop.create_future()
        transport, _ = await loop.create_connection(
            lambda: _ClosedLoop(items, record, done, rbuf), host, port)
        try:
            await done
        finally:
            transport.close()

    t0 = time.monotonic()
    await asyncio.gather(*(worker(s) for s in shares if s))
    wall = time.monotonic() - t0
    server = await fetch_stats(host, port)

    lat = np.sort(np.asarray(latencies, np.float64))

    def pct(p: float) -> float:
        if len(lat) == 0:
            return math.nan
        k = min(len(lat) - 1, max(0, math.ceil(p / 100 * len(lat)) - 1))
        return float(lat[k]) * 1e3

    ok = sum(1 for s in statuses if s == 200)
    return LoadReport(
        requests=len(statuses), ok=ok, errors=len(statuses) - ok,
        connections=connections, wall_s=wall,
        # a rep window with zero completed requests (warmup-only short
        # runs) has no throughput to report: NaN, like the latency
        # percentiles — never a division by zero or a fake infinity
        rps=len(statuses) / wall if statuses and wall > 0 else math.nan,
        p50_ms=pct(50), p95_ms=pct(95), p99_ms=pct(99),
        op_counts=dict(sorted(op_counts.items())), server=server)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="closed-loop load test against a running serving edge")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--connections", type=int, default=64)
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--jobs", default="grep,sort")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=256,
                    help="unmeasured warm-up requests (compiles/fits) "
                    "before the measured run; 0 skips")
    args = ap.parse_args(argv)
    jobs = tuple(j for j in args.jobs.split(",") if j)

    async def run():
        if args.warmup:
            await run_loadgen(args.host, args.port,
                              connections=min(8, args.connections),
                              requests=args.warmup, jobs=jobs,
                              seed=args.seed + 1)
        return await run_loadgen(args.host, args.port,
                                 connections=args.connections,
                                 requests=args.requests, jobs=jobs,
                                 seed=args.seed)

    report = asyncio.run(run())
    print(json.dumps(report.to_json(), indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
