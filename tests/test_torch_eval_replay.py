"""The port's collaborative replay (``repro_torch.eval.replay``) against the
JAX package's on one small config, run on the CPU on both sides: the same
trajectory rows (keys, accept verdicts, compactions, selections), MAPE and
MAE per model within stated tolerances, and the CLI rerun byte for byte.

Tolerances (relative): ernest and linreg rows 1e-5; rows that involve
trees (gbm, ogb, bom, and c3o where it selects one of them) 2e-3.  A
larger difference would be fault R3 (GBM fits diverging at a late
near-tie split, ROADMAP.md §3) and is pinned with its round, never covered
by a wider tolerance.  The trajectory fingerprints differ across the
frameworks for that reason (R3 moves the last printed digits of the tree
rows); each side's reruns are byte-identical."""
import hashlib

import numpy as np
import pytest
import torch

from repro.eval import replay as RR
from repro_torch.eval import replay as R

SMALL = dict(jobs=("grep",), n_users=2, seed=0, chunks_per_user=2,
             max_cv_folds=8, compact_every=1, compact_min_rows=16)
KEYS = ("job", "held_out", "step", "store_rows", "rows_contributed",
        "epoch", "machine", "model", "selected")
EXACT_REL = 1e-5          # ernest, linreg
TREE_REL = 2e-3           # gbm, ogb, bom; c3o selecting one of them
TREES = ("gbm", "ogb", "bom")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's fits here are thousands of small tensor ops: one intra-op
    thread runs them faster than a pool that a loaded machine (or other
    test workers) keeps waiting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_tol(record) -> float:
    """The tolerance of one trajectory row."""
    if record["model"] in TREES or record["selected"] in TREES:
        return TREE_REL
    return EXACT_REL


@pytest.fixture(scope="module")
def pair():
    return (RR.run_replay(RR.ReplayConfig(**SMALL)),
            R.run_replay(R.ReplayConfig(device="cpu", **SMALL)))


def test_rows_verdicts_compactions_and_selections_match(pair):
    ref, got = pair
    assert len(got.records) == len(ref.records) > 0
    for a, b in zip(ref.records, got.records):
        assert tuple(a[k] for k in KEYS) == tuple(b[k] for k in KEYS)
    assert (got.contributions, got.accepted) == \
        (ref.contributions, ref.accepted)
    assert (got.compactions_attempted, got.compactions) == \
        (ref.compactions_attempted, ref.compactions)
    assert got.compactions_attempted > 0
    assert {r["model"] for r in got.records} == \
        set(R.ReplayConfig().track_models) | {"c3o"}
    for job, s in ref.summary.items():
        assert got.summary[job]["selected_counts"] == s["selected_counts"]
        assert got.summary[job]["final_epoch"] == s["final_epoch"]


def test_mape_and_mae_within_the_stated_tolerances(pair):
    ref, got = pair
    worst = {}
    for a, b in zip(ref.records, got.records):
        tol = rel_tol(a)
        for col in ("mape", "mae"):
            rel = abs(b[col] - a[col]) / abs(a[col])
            worst[(a["model"], col)] = max(rel, worst.get((a["model"], col),
                                                          0.0))
            assert rel <= tol, (a, b, col, rel)
    # the linear rows are the reference's to float32 rounding
    assert worst[("linreg", "mape")] <= EXACT_REL
    assert worst[("ernest", "mape")] <= EXACT_REL


def test_fingerprint_differs_from_the_reference_only_by_r3(pair):
    """Fault R3 (ROADMAP.md §3): the GBM fits of the two frameworks part
    at late near-tie splits, so tree rows differ in their last printed
    digits and the trajectory fingerprints cannot match; every other
    column of the TSV is the reference's."""
    ref, got = pair
    assert got.fingerprint == hashlib.sha256(got.tsv.encode()).hexdigest()
    assert got.fingerprint != ref.fingerprint
    ref_lines = ref.tsv.splitlines()
    got_lines = got.tsv.splitlines()
    assert got_lines[0] == ref_lines[0] == "\t".join(R.TRAJECTORY_COLUMNS)
    mape = R.TRAJECTORY_COLUMNS.index("mape")
    differ = 0
    for a, b in zip(ref_lines[1:], got_lines[1:]):
        a, b = a.split("\t"), b.split("\t")
        assert a[:mape] == b[:mape] and a[mape + 2:] == b[mape + 2:]
        differ += a != b
    assert differ > 0


def test_cli_reruns_byte_for_byte(tmp_path, capsys):
    """Two runs of the CLI on the CPU write the same TSV and print the
    same fingerprint (run_replay's determinism, through every flag the
    replay mode takes)."""
    argv = ["--users", "2", "--jobs", "grep", "--chunks", "1",
            "--compact-every", "1", "--track-models", "linreg",
            "--device", "cpu"]
    outs, prints = [], []
    for k in range(2):
        out = tmp_path / f"run{k}.tsv"
        rc = R.main(argv + ["--out", str(out)])
        assert rc in (0, 1)                # the summary's verdict
        outs.append(out.read_bytes())
        prints.append([ln for ln in capsys.readouterr().out.splitlines()
                       if not ln.startswith(("replay.wall_s",
                                             "replay.trajectory"))])
    assert outs[0] == outs[1]
    assert prints[0] == prints[1]
    fp = [ln for ln in prints[0] if ln.startswith("replay.fingerprint")]
    assert fp == [f"replay.fingerprint {hashlib.sha256(outs[0]).hexdigest()}"]
    assert any(ln.startswith("replay.compactions") for ln in prints[0])
    lines = outs[0].decode().splitlines()
    assert {ln.split("\t")[7] for ln in lines[1:]} == {"linreg", "c3o"}


def test_cli_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --device cpu"):
        R.main(["--users", "2", "--jobs", "grep"])
    with pytest.raises(SystemExit, match="pass --device cpu"):
        R.main(["--spot-market", "--jobs", "grep"])
    assert R.ReplayConfig().device == "cuda"
    assert R.ColdStartConfig().device == R.SpotMarketConfig().device == \
        "cuda"


def test_summary_rollups_are_the_references_on_shared_records(pair):
    """summarize, _quartile_medians and trajectory_tsv are numpy only:
    on the reference's own records they give the reference's results."""
    ref, _ = pair
    cfg = R.ReplayConfig(**SMALL)
    assert R.summarize(ref.records, cfg) == ref.summary
    assert R.trajectory_tsv(ref.records) == ref.tsv
    sizes = np.arange(10.0)[::-1]
    errs = np.linspace(1.0, 0.1, 10)
    assert R._quartile_medians(sizes, errs) == \
        RR._quartile_medians(sizes, errs)
