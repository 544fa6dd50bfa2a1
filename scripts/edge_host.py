#!/usr/bin/env python3
"""Where the edge's socket pass spends its host time, on one card's host.

    python3 scripts/edge_host.py

Plays chip_smoke.py's edge workload (1024 seeded requests, 64 keep-alive
connections, run_loadgen in the edge's own event loop) four ways, each
pass on a fully collected heap: over the socket through the demo
gateway (``socket``), through the same gateway in process
(``inproc``), over the socket through an edge whose gateway answers
every request at once with one fixed envelope (``transport``: the socket
path alone, that is HTTP framing, the codec, the TCP loopback and the load
generator), and chip_smoke.py's bare-TCP pass (``tcp``: the workload's
request and response bytes exchanged over the loopback, nothing else).
For each it prints one JSON line: the time a request of 3
unprofiled passes (median; the load generator's window, or the in-process
pass's) and the time a request the event loop spent blocked in its
selector waiting for work (the lanes' ticks, data in flight) in those
passes, and from one pass under cProfile the time a request in the
sockets' send and receive calls and in epoll, which are system calls
that the profiler barely inflates.  Needs a CUDA card.
"""
import asyncio
import cProfile
import gc
import json
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
SYSCALLS = (("send", "'send' of '_socket.socket'"),
            ("recv", "'recv' of '_socket.socket'"),
            ("recv_into", "'recv_into' of '_socket.socket'"),
            ("epoll", "'poll' of 'select.epoll'"))


class _AtOnce:
    """Stands in for AsyncHubGateway under HubEdgeApp: one fixed envelope
    for every request, answered without a lane."""

    def __init__(self, gateway, response):
        self.gateway, self.response, self.lane_stats = gateway, response, {}

    async def handle_async(self, request):
        return self.response

    async def stop(self):
        pass


def main():
    import torch
    import chip_smoke as CS
    from repro_torch.api import PredictRequest
    from repro_torch.serve.edge import EdgeServer, HubEdgeApp, http_response
    from repro_torch.serve.loadgen import _head, build_workload, run_loadgen
    if not torch.cuda.is_available():
        print("edge_host: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps({"card": CS.nvidia_smi()}), flush=True)
    gw, _, _ = CS.edge_gateway()
    reqs = CS.edge_requests()
    data = gw.hub.get("grep").store.data
    fixed = gw.handle(PredictRequest("grep", str(data.machine_type[0]),
                                     (tuple(float(x) for x in data.X[0]),)))
    workload = build_workload(CS.EDGE_REQUESTS, jobs=CS.EDGE_JOBS, seed=0)

    async def transport():
        app = HubEdgeApp(_AtOnce(gw, fixed))
        server = await EdgeServer(app).start()
        try:
            rep = await run_loadgen(server.host, server.port,
                                    connections=CS.EDGE_CONNECTIONS,
                                    workload=workload)
            assert rep.errors == 0
            return rep.wall_s
        finally:
            await server.stop()

    async def socket():
        rep = await CS.edge_socket_pass(gw)
        assert rep.errors == 0
        return rep.wall_s

    async def inproc():
        return (await CS.edge_inproc_pass(gw, reqs))[1]

    wire = table = None

    async def tcp():
        return await CS.edge_tcp_pass(wire, table)

    async def run():
        nonlocal wire, table
        blocked = _watch_selector(asyncio.get_running_loop())
        for fn in (inproc, socket, transport):
            await fn()                                  # warm
        http = await CS.edge_capture(gw)
        wire = [(_head("POST", path, len(body)) + body,
                 http_response(status, payload, True))
                for (path, body), (status, payload) in zip(workload, http)]
        table = dict(wire)
        for name, fn in (("socket", socket), ("inproc", inproc),
                         ("transport", transport), ("tcp", tcp)):
            walls, idle = [], []
            for _ in range(3):
                gc.collect()
                blocked[0] = 0.0
                walls.append(await fn())
                idle.append(blocked[0])
            gc.collect()
            prof = cProfile.Profile()
            prof.enable()
            await fn()
            prof.disable()
            n = len(reqs)
            out = {"pass": name, "wall_us_a_request":
                   sorted(walls)[1] / n * 1e6,
                   "walls_s": walls,
                   "idle_us_a_request": sorted(idle)[1] / n * 1e6}
            for (_, _, fname), (_, calls, tt, _, _) in \
                    pstats.Stats(prof).stats.items():
                for key, sub in SYSCALLS:
                    if sub in fname:
                        out[f"{key}_us_a_request"] = tt / n * 1e6
                        out[f"{key}_calls_a_request"] = calls / n
            print(json.dumps(out), flush=True)

    asyncio.run(run())
    return 0


def _watch_selector(loop):
    """Time the loop spends in selector calls that may block (a timeout
    other than 0): its idle time, waiting for timers or sockets; a
    one-item list the caller resets and reads."""
    blocked = [0.0]
    select = loop._selector.select

    def timed(timeout=None):
        if timeout == 0:
            return select(timeout)
        t0 = time.perf_counter()
        try:
            return select(timeout)
        finally:
            blocked[0] += time.perf_counter() - t0

    loop._selector.select = timed
    return blocked


if __name__ == "__main__":
    sys.exit(main())
