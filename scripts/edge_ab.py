#!/usr/bin/env python3
"""chip_smoke.py's edge phase from two trees on one card, in turns.

    python3 scripts/edge_ab.py TREE_A TREE_B [--runs 2]

Each turn is a fresh process that imports ``chip_smoke`` and
``repro_torch`` from its tree, builds that tree's GBM kernel, warms the
edge's demo gateway on the card and runs the edge phase ``--runs`` times
(each: 7 interleaved socket / bare-TCP / in-process triples of the
seeded 1024-request workload at 64 connections, gated on t_socket -
t_tcp <= 2 t_inproc in the median triple).  The turns go A, B, B, A, so
drift over the call hits both trees alike.  It prints one JSON line a
phase run (tree, the gate's reading (t_socket - t_tcp) / t_inproc and
the socket / in-process ratio of each triple, requests/s, mean batch,
p50/p99) and last a summary of each tree's median-triple readings.
Needs a CUDA card.
"""
import json
import os
import statistics
import subprocess
import sys


def turn(tree, runs):
    """One tree's turn in a fresh process: its edge phase ``runs`` times;
    the edge lines it printed."""
    code = (
        "import sys, chip_smoke as CS\n"
        "from repro_torch.kernels import build\n"
        "build.build_all(['gbm_predict'])\n"
        "from repro_torch.core import engine\n"
        "gw, n, warm_s = CS.edge_gateway()\n"
        f"for _ in range({runs}): CS.edge_phase(gw, warm_s, n)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [tree, os.path.join(tree, "src")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                         capture_output=True, text=True, check=True).stdout
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith('{"phase": "edge"')]


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    runs = int(sys.argv[sys.argv.index("--runs") + 1]) \
        if "--runs" in sys.argv else 2
    if len(args) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (os.path.abspath(t) for t in args[:2])
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}), flush=True)
    medians = {a: [], b: []}
    for tree in (a, b, b, a):
        for e in turn(tree, runs):
            medians[tree].append(e["socket_minus_tcp_over_inproc"])
            print(json.dumps({
                "tree": tree,
                "median_triple_gate": e["socket_minus_tcp_over_inproc"],
                "triple_gates": [p["socket_minus_tcp_over_inproc"]
                                 for p in e["triples"]],
                "triple_ratios": e["socket_vs_inproc_triples"],
                "socket_rps": [p["socket_rps"] for p in e["triples"]],
                "tcp_rps": [p["tcp_rps"] for p in e["triples"]],
                "inproc_rps": [p["inproc_rps"] for p in e["triples"]],
                "predict_mean_batch": e["predict_mean_batch"],
                "p50_ms": e["p50_ms"], "p99_ms": e["p99_ms"],
                "identical": e["identical"], "errors": e["errors"]}),
                flush=True)
    print(json.dumps({"summary": {
        t: {"median_triple_gates": r, "median": statistics.median(r)}
        for t, r in medians.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
