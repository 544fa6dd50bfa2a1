#!/usr/bin/env python3
"""How far chip_smoke.py's edge gate spreads on one card's host.

    python3 scripts/edge_spread.py [--runs 3] [--fresh]

Brings this process to the state in which chip_smoke.py's edge phase
runs (the kernels built, then the smoke's phases before it: flash_build,
kernel_build, kernel, lm_kernel, and the paper loop's fit, serve, loop
and parity; ``--fresh`` skips them), warms the edge's demo gateway and
runs chip_smoke.edge_phase ``--runs`` times (each: EDGE_TRIPLES
interleaved triples of a socket, a bare-TCP and an in-process pass, then
the busy-wait control).  It prints one JSON line a run: each triple's
gate reading (t_socket - t_tcp) / t_inproc, its three times a request
and the time a request the event loop spent blocked in its selector
during each pass (waiting on the lanes' ticks or the wire; counted over
the whole pass function, the edge's start and stop included), the
median triple's reading and the control's.  Last, a summary over all
triples: their readings, the share over the budget, and the median of
each run's first 3 triples beside the median of all of its triples.
Needs a CUDA card.
"""
import asyncio
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src"), os.path.join(ROOT, "scripts")]


def main():
    import torch
    import chip_smoke as CS
    from edge_host import _watch_selector
    if not torch.cuda.is_available():
        print("edge_spread: needs a CUDA card", file=sys.stderr)
        return 2
    runs = int(sys.argv[sys.argv.index("--runs") + 1]) \
        if "--runs" in sys.argv else 3
    print(json.dumps({"card": CS.nvidia_smi(),
                      "edge_triples": CS.EDGE_TRIPLES,
                      "budget": CS.EDGE_BUDGET}), flush=True)
    from repro_torch.kernels import build
    built = build.build_all()
    from repro_torch.core import engine  # noqa: F401  (sets TF32 off)
    if "--fresh" not in sys.argv:
        CS.flash_build_phase(build, built["flash_attention"])
        CS.kernel_build_phase(build, built)
        CS.kernel_phase(torch.device("cuda"))
        CS.lm_kernel_phase()
        hub = CS.make_hub("cuda")
        fit_rows = CS.fit_phase(hub, "cuda")
        CS.serve_phase(hub)
        CS.loop_phase(hub)
        CS.parity_phase(fit_rows)
    gw, n_pred, warm_s = CS.edge_gateway()

    # each pass's loop idle: edge_phase runs its passes through
    # after_full_collection, so the selector is watched from there
    blocked, idle = [None], []
    inner = CS.after_full_collection

    async def watched(pass_fn):
        if blocked[0] is None:
            blocked[0] = _watch_selector(asyncio.get_running_loop())
        blocked[0][0] = 0.0
        out = await inner(pass_fn)
        idle.append(blocked[0][0] / CS.EDGE_REQUESTS * 1e6)
        return out

    CS.after_full_collection = watched
    lines = []
    CS.emit = lambda phase, t0, **kw: lines.append(kw)
    readings, first3, all_med = [], [], []
    for run in range(runs):
        blocked[0], idle[:], lines[:] = None, [], []
        res = CS.edge_phase(gw, warm_s, n_pred)
        e = lines[-1]
        gates = [t["socket_minus_tcp_over_inproc"] for t in e["triples"]]
        readings += gates
        first3.append(statistics.median(gates[:3]))
        all_med.append(res["over_budget"])
        print(json.dumps({
            "run": run, "gates": gates,
            "median_triple": res["over_budget"],
            "median_first_3": first3[-1], "control": res["control"],
            "t_us": [[t["t_socket_us"], t["t_tcp_us"], t["t_inproc_us"]]
                     for t in e["triples"]],
            "idle_us": [idle[3 * k:3 * k + 3]
                        for k in range(len(gates))],
            "predict_mean_batch": e["predict_mean_batch"],
            "errors": e["errors"]}), flush=True)
    print(json.dumps({"summary": {
        "triples": len(readings), "readings": sorted(readings),
        "over_budget": sum(g > CS.EDGE_BUDGET for g in readings)
        / len(readings),
        "median_of_first_3_by_run": first3,
        "median_of_all_by_run": all_med}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
