"""Deterministic collaborative-replay harness (paper §VI, Fig. 5/6).

Leave-one-user-out over a multi-user emulated dataset: for each held-out
user, the remaining users' measurements are ingested into a fresh
``RuntimeDataStore`` through ``contribute`` (validated, fingerprint-chained)
in a seeded shuffled contribution order, and after every contribution the
held-out user's configurations are scored — per machine type, per model —
producing MAPE/MAE *trajectories versus store size*: the paper's
error-vs-training-data curves, with all model selection flowing through
``engine.cv_select`` (via ``JobRepo.predictor_for``) and all per-model
scoring through the engine's fused, shape-bucketed ``val_executable``s.

Determinism: every RNG is seeded from SHA-256 of a structured identity key
(job, user, seed); trajectory rows are emitted in a canonical order and the
harness reports a SHA-256 fingerprint of the trajectory TSV — two runs of
``python -m repro_torch.eval.replay --users 8 --seed 0`` produce byte-identical
trajectories.

Periodic-compaction mode (``--compact-every N``) additionally attempts a
store epoch transition (``RuntimeDataStore.compact``, cap-escalation
ladder) every N contributions, tracing the accuracy-vs-store-size
frontier: trajectory rows carry both the live ``store_rows`` and the
lifetime ``rows_contributed``/``epoch``, so compacted and append-only
runs plot on the same x-axis.

Every fit, selection and prediction runs on the device a config names
(``device``, "cuda" unless "cpu" is asked for; there is no fallback):
``RuntimeDataStore(device=...)`` validates contributions there and
``JobRepo(predictor_kw={"device": ...})`` fits and predicts there, so on
the card every GBM-selected prediction reaches the ``gbm_predict`` kernel.

CLI:
    PYTHONPATH=src python -m repro_torch.eval.replay --users 8 --seed 0
    PYTHONPATH=src python -m repro_torch.eval.replay --device cpu ...
"""
from __future__ import annotations

import argparse
import hashlib
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api.types import ChooseRequest, PredictRequest
from repro_torch.core.datastore import RuntimeDataStore
from repro_torch.core.market import realized_completion_time_s
from repro_torch.core.hub import Hub, JobRepo
from repro_torch.core.predictor import DEFAULT_MODELS
from repro_torch.core.transfer import TransferPolicy
from repro_torch.eval.dataset import (MultiUserData, build_multi_user,
                                contribution_chunks, derived_rng,
                                user_contributor)
from repro_torch.workloads import spark_emul as W
from repro_torch.workloads.spark_emul import SCHEMAS

TRAJECTORY_COLUMNS = ("job", "held_out", "step", "store_rows",
                      "rows_contributed", "epoch", "machine",
                      "model", "mape", "mae", "selected")

#: cap-escalation ladder for periodic compaction: caps are tried tightest
#: first and the first ACCEPTED compaction wins — rejections are free
#: no-ops (no version bump, no reseed), so one config adapts per job to
#: however much redundancy the store actually carries
COMPACT_CAPS = (2, 3, 4, 6)

#: the C3O row must strictly beat these at full store size (paper
#: Table II: the optimistic BOM and a plain linear regressor are the
#: reference baselines the specialized selection is measured against)
BASELINE_MODELS = ("bom", "linreg")


@dataclass(frozen=True)
class ReplayConfig:
    jobs: Tuple[str, ...] = tuple(SCHEMAS)
    n_users: int = 8
    seed: int = 0
    chunks_per_user: int = 1          # contributions each user splits into
    model_names: Tuple[str, ...] = DEFAULT_MODELS      # c3o selection pool
    track_models: Tuple[str, ...] = DEFAULT_MODELS + ("linreg",)
    max_cv_folds: int = 20
    max_validation_rows: int = 1024
    # periodic store compaction (0 = off): every N accepted-or-not
    # contributions the store attempts an epoch transition through the
    # COMPACT_CAPS escalation ladder — the accuracy-vs-size frontier mode
    compact_every: int = 0
    compact_caps: Tuple[int, ...] = COMPACT_CAPS
    compact_floor: int = 2
    compact_width: float = 0.15
    compact_budget: float = 0.01
    compact_min_rows: int = 64
    device: str = "cuda"


@dataclass
class ReplayResult:
    config: ReplayConfig
    records: List[dict]
    tsv: str
    fingerprint: str
    summary: Dict[str, dict]
    wall_s: float
    contributions: int = 0
    accepted: int = 0
    compactions_attempted: int = 0    # ladder rungs tried (incl. rejected)
    compactions: int = 0              # epoch transitions actually taken

    @property
    def ok(self) -> bool:
        return all(s["ok"] for s in self.summary.values())


# ---------------------------------------------------------------------------
# replay core
# ---------------------------------------------------------------------------

def _predictor_kw(cfg) -> dict:
    """A replay repo's predictor settings: bucketed shapes (per-checkpoint
    refits against the growing store reuse them), the config's CV fold cap
    and its device."""
    return {"pad_rows": True, "max_cv_folds": cfg.max_cv_folds,
            "device": cfg.device}


def _checkpoint(job: str, held: int, step: int, repo: JobRepo,
                test, cfg, extra: Optional[dict] = None) -> List[dict]:
    """Score the held-out user's rows against the current store state.

    ``extra`` key/values are merged into every record — the adversarial
    replay stamps its ``weighting`` arm here so on/off trajectories share
    one record stream."""
    out = []
    store_rows = len(repo.store)
    for machine in test.present_machines():
        tr = repo.store.data.machine_view(machine)
        te = test.machine_view(machine)
        if len(tr) < 5 or len(te) < 2:
            continue            # too little shared data for this machine yet
        errs, selected = repo.model_errors(machine, test,
                                           track_models=cfg.track_models,
                                           seed=cfg.seed)
        for model, (mape, mae) in errs.items():
            rec = {"job": job, "held_out": held, "step": step,
                   "store_rows": store_rows,
                   "rows_contributed": repo.store.rows_contributed,
                   "epoch": repo.store.epoch, "machine": machine,
                   "model": model, "mape": mape, "mae": mae,
                   "selected": selected if model == "c3o" else ""}
            if extra:
                rec.update(extra)
            out.append(rec)
    return out


def _maybe_compact(store: RuntimeDataStore, cfg: ReplayConfig
                   ) -> Tuple[int, int]:
    """Run the cap-escalation ladder once: tightest cap first, first
    accepted epoch transition wins.  Returns (rungs tried, accepted 0/1);
    every rejected rung is a guaranteed no-op on the store."""
    tried = 0
    for cap in cfg.compact_caps:
        tried += 1
        report = store.compact(
            max_rows_per_cell=int(cap), support_floor=cfg.compact_floor,
            cell_rel_width=cfg.compact_width,
            accuracy_budget=cfg.compact_budget,
            min_store_rows=cfg.compact_min_rows, seed=cfg.seed)
        if report.accepted:
            return tried, 1
    return tried, 0


def replay_job(job: str, mu: MultiUserData, cfg: ReplayConfig
               ) -> Tuple[List[dict], int, int, int, int]:
    """Leave-one-user-out replay of one job.

    Returns (trajectory records, contributions attempted, accepted,
    compaction rungs attempted, compactions accepted)."""
    if len(mu.users) < 2:
        raise ValueError(
            f"leave-one-user-out needs at least 2 users, got {len(mu.users)}"
            " (with 1 user there is nobody left to contribute)")
    records: List[dict] = []
    contributions = accepted = 0
    comp_tried = comp_done = 0
    for held in mu.users:
        test = mu.per_user[held]
        chunks = []
        for u in mu.users:
            if u == held:
                continue
            # contributions carry REAL provenance: each chunk is stamped
            # with its user's contributor id, so the replayed store can be
            # split back into per-user datasets (eval.dataset.
            # split_by_contributor) and the gateway reports true
            # per-contributor stats over replay output
            chunks.extend(
                c.with_contributor(user_contributor(u))
                for c in contribution_chunks(
                    mu.per_user[u], cfg.chunks_per_user,
                    derived_rng("chunks", job, u, cfg.seed)))
        order = derived_rng("order", job, held, cfg.seed) \
            .permutation(len(chunks))
        store = RuntimeDataStore(chunks[order[0]], seed=cfg.seed,
                                 model_names=list(cfg.model_names),
                                 max_validation_rows=cfg.max_validation_rows,
                                 device=cfg.device)
        repo = JobRepo(job, job, test.schema, store,
                       model_names=list(cfg.model_names),
                       predictor_kw=_predictor_kw(cfg))
        records += _checkpoint(job, held, 0, repo, test, cfg)
        for step, ci in enumerate(order[1:], start=1):
            report = store.contribute(chunks[ci])
            contributions += 1
            accepted += bool(report.accepted)
            # compaction runs BEFORE the checkpoint so each trajectory row
            # scores the store state the next reader would actually see
            if cfg.compact_every > 0 and step % cfg.compact_every == 0:
                t, d = _maybe_compact(store, cfg)
                comp_tried += t
                comp_done += d
            records += _checkpoint(job, held, step, repo, test, cfg)
    return records, contributions, accepted, comp_tried, comp_done


# ---------------------------------------------------------------------------
# trajectory TSV + summary
# ---------------------------------------------------------------------------

def trajectory_tsv(records: Sequence[dict]) -> str:
    """Canonical TSV of the trajectory records (the determinism artifact:
    byte-identical across runs of the same config on the same platform)."""
    lines = ["\t".join(TRAJECTORY_COLUMNS)]
    for r in records:
        lines.append("\t".join((
            r["job"], str(r["held_out"]), str(r["step"]),
            str(r["store_rows"]),
            str(r.get("rows_contributed", r["store_rows"])),
            str(r.get("epoch", 0)), r["machine"], r["model"],
            "%.6g" % r["mape"], "%.6g" % r["mae"], r["selected"])))
    return "\n".join(lines) + "\n"


def _quartile_medians(sizes: np.ndarray, errs: np.ndarray) -> List[float]:
    """Median error per store-size quartile (Fig. 5's x-axis compressed to
    four buckets; medians across users/machines tame measurement noise).

    Quartiles are equal-count over the size-sorted records (stable sort, so
    ties split deterministically) — every bucket is non-empty even when the
    replay only visited a few distinct store sizes."""
    order = np.argsort(sizes, kind="stable")
    return [float(np.median(errs[part]))
            for part in np.array_split(order, 4) if len(part)]


def summarize(records: Sequence[dict], cfg: ReplayConfig) -> Dict[str, dict]:
    """Per-job rollup of the acceptance criteria: final-store MAPE per
    model, C3O vs baselines, and quartile-median error monotonicity."""
    summary: Dict[str, dict] = {}
    for job in cfg.jobs:
        rows = [r for r in records if r["job"] == job]
        if not rows:
            continue
        # final-store errors: the last checkpoint of each held-out user
        last_step: Dict[int, int] = {}
        for r in rows:
            last_step[r["held_out"]] = max(r["step"],
                                           last_step.get(r["held_out"], 0))
        final: Dict[str, List[float]] = {}
        for r in rows:
            if r["step"] == last_step[r["held_out"]]:
                final.setdefault(r["model"], []).append(r["mape"])
        final_mape = {m: float(np.mean(v)) for m, v in final.items()}
        c3o = [r for r in rows if r["model"] == "c3o"]
        # the x-axis is LIFETIME ingested rows (== live rows while the
        # store is append-only): under periodic compaction the live store
        # shrinks at epoch transitions, but collaboration progress — what
        # Fig. 5 plots — is how much data flowed in, not what was retained
        sizes = np.asarray([r.get("rows_contributed", r["store_rows"])
                            for r in c3o], np.float64)
        errs = np.asarray([r["mape"] for r in c3o], np.float64)
        quart = _quartile_medians(sizes, errs)
        # non-increasing across store-size quartiles, with a small noise
        # band between ADJACENT quartiles (5% relative + 0.005 absolute —
        # the emulator's measurement-noise floor: a job that converges in
        # the first quartile sits at its error floor, where medians wiggle
        # at that level) — but the full-store quartile must be STRICTLY
        # below the small-store one: a flat trajectory means collaboration
        # taught the predictor nothing, which is a failure, not a pass
        monotone = (all(quart[i + 1] <= quart[i] * 1.05 + 5e-3
                        for i in range(len(quart) - 1))
                    and quart[-1] < quart[0])
        baselines = {b: final_mape[b] for b in BASELINE_MODELS
                     if b in final_mape}
        beats = all(final_mape["c3o"] < v for v in baselines.values())
        selected = {}
        for r in c3o:
            if r["step"] == last_step[r["held_out"]] and r["selected"]:
                selected[r["selected"]] = selected.get(r["selected"], 0) + 1
        # store-size frontier at the final checkpoint: retained / ingested
        # (1.0 when compaction is off), and the epoch the store reached
        fin = [r for r in c3o if r["step"] == last_step[r["held_out"]]]
        retention = float(np.mean(
            [r["store_rows"] / max(r.get("rows_contributed",
                                         r["store_rows"]), 1)
             for r in fin])) if fin else 1.0
        final_epoch = max((r.get("epoch", 0) for r in fin), default=0)
        summary[job] = {
            "final_mape": final_mape,
            "c3o_final": final_mape["c3o"],
            "baselines": baselines,
            "beats_baselines": beats,
            "quartile_medians": quart,
            "monotone": monotone,
            "selected_counts": selected,
            "retention": retention,
            "final_epoch": final_epoch,
            "ok": final_mape["c3o"] < 0.10 and beats and monotone,
        }
    return summary


def run_replay(cfg: ReplayConfig) -> ReplayResult:
    t0 = time.time()
    records: List[dict] = []
    contributions = accepted = 0
    comp_tried = comp_done = 0
    for job in cfg.jobs:
        mu = build_multi_user(job, cfg.n_users, cfg.seed)
        recs, contribs, acc, ct, cd = replay_job(job, mu, cfg)
        records += recs
        contributions += contribs
        accepted += acc
        comp_tried += ct
        comp_done += cd
    tsv = trajectory_tsv(records)
    return ReplayResult(
        config=cfg, records=records, tsv=tsv,
        fingerprint=hashlib.sha256(tsv.encode()).hexdigest(),
        summary=summarize(records, cfg), wall_s=time.time() - t0,
        contributions=contributions, accepted=accepted,
        compactions_attempted=comp_tried, compactions=comp_done)


# ---------------------------------------------------------------------------
# zero-history cold-start evaluation (--cold-start-job)
# ---------------------------------------------------------------------------

COLD_COLUMNS = ("job", "step", "store_rows", "source", "confidence",
                "machine", "model", "mape", "mae")


@dataclass(frozen=True)
class ColdStartConfig:
    """Zero-history transfer evaluation: per job family, a held-out cold
    twin (``spark_emul.cold_probe`` — a few probe rows, far below the
    transfer policy's ``min_rows``) is served by a transfer-enabled
    gateway while the families' donor stores grow user by user, charting
    borrowed-model error vs donor store size against the no-history
    global-mean baseline."""
    jobs: Tuple[str, ...] = tuple(SCHEMAS)
    n_users: int = 6
    seed: int = 0
    model_names: Tuple[str, ...] = DEFAULT_MODELS
    max_cv_folds: int = 20
    max_validation_rows: int = 1024
    min_rows: int = 24                # TransferPolicy.min_rows
    device: str = "cuda"


@dataclass
class ColdStartResult:
    config: ColdStartConfig
    records: List[dict]
    tsv: str
    fingerprint: str
    summary: Dict[str, dict]
    wall_s: float

    @property
    def ok(self) -> bool:
        """Borrowed models must beat the no-history baseline at the final
        store size on >= 80% of the emulated families (4 of 5)."""
        need = math.ceil(0.8 * len(self.summary))
        return sum(bool(s["beats_mean"])
                   for s in self.summary.values()) >= need


def cold_tsv(records: Sequence[dict]) -> str:
    """Canonical TSV of the cold-start records (byte-identical across
    reruns of the same config on the same platform)."""
    lines = ["\t".join(COLD_COLUMNS)]
    for r in records:
        lines.append("\t".join((
            r["job"], str(r["step"]), str(r["store_rows"]), r["source"],
            "%.6g" % r["confidence"], r["machine"], r["model"],
            "%.6g" % r["mape"], "%.6g" % r["mae"])))
    return "\n".join(lines) + "\n"


def _cold_checkpoint(step: int, gw, stores: Dict[str, RuntimeDataStore],
                     tests: Dict[str, object],
                     cfg: ColdStartConfig) -> List[dict]:
    """Score every cold twin's full ground-truth dataset through the
    transfer-enabled gateway at the current donor store sizes.

    Two models per (family, machine): ``borrowed`` — the gateway's
    cold-start answer, stamped with its transfer source/confidence — and
    ``mean`` — the no-history baseline that predicts the global mean
    runtime pooled over every donor store (what a hub with no transfer
    and no job history could do)."""
    out = []
    pooled = np.concatenate([s.data.runtime for s in stores.values()])
    gmean = float(pooled.mean())
    for job in cfg.jobs:
        test = tests[job]
        cold_name = W.cold_job_name(job)
        rows = len(stores[job])
        for machine in sorted(test.present_machines()):
            te = test.machine_view(machine)
            y = np.asarray(te.y, np.float64)
            resp = gw.predict(PredictRequest(
                cold_name, machine,
                tuple(tuple(r) for r in te.X.tolist()), seed=cfg.seed))
            if not resp.ok:
                raise RuntimeError(
                    f"cold-start predict failed for {cold_name!r} on "
                    f"{machine!r}: {resp.error_code}: {resp.detail}")
            pred = np.asarray(resp.result.runtimes_s, np.float64)
            for model, p, src, conf in (
                    ("borrowed", pred, resp.result.transfer_source,
                     resp.result.transfer_confidence),
                    ("mean", np.full_like(y, gmean), "", 1.0)):
                out.append({
                    "job": job, "step": step, "store_rows": rows,
                    "source": src, "confidence": float(conf),
                    "machine": machine, "model": model,
                    "mape": float(np.mean(np.abs(p - y) / y)),
                    "mae": float(np.mean(np.abs(p - y)))})
    return out


def summarize_cold(records: Sequence[dict],
                   cfg: ColdStartConfig) -> Dict[str, dict]:
    """Per-family rollup: final borrowed vs baseline MAPE, the donors the
    lookup actually picked, and whether growing donor stores helped."""
    summary: Dict[str, dict] = {}
    for job in cfg.jobs:
        rows = [r for r in records if r["job"] == job]
        if not rows:
            continue
        last = max(r["step"] for r in rows)
        fin_b = [r["mape"] for r in rows
                 if r["step"] == last and r["model"] == "borrowed"]
        fin_m = [r["mape"] for r in rows
                 if r["step"] == last and r["model"] == "mean"]
        first_b = [r["mape"] for r in rows
                   if r["step"] == 0 and r["model"] == "borrowed"]
        summary[job] = {
            "borrowed_final": float(np.mean(fin_b)),
            "borrowed_first": float(np.mean(first_b)),
            "mean_final": float(np.mean(fin_m)),
            "beats_mean": bool(np.mean(fin_b) < np.mean(fin_m)),
            "sources": sorted({r["source"] for r in rows
                               if r["model"] == "borrowed"}),
            "confidence_final": float(np.mean(
                [r["confidence"] for r in rows
                 if r["step"] == last and r["model"] == "borrowed"])),
        }
    return summary


def run_cold_start(cfg: ColdStartConfig) -> ColdStartResult:
    """The zero-history evaluation loop (see ``ColdStartConfig``)."""
    t0 = time.time()
    hub = Hub()
    stores: Dict[str, RuntimeDataStore] = {}
    tests: Dict[str, object] = {}
    mus: Dict[str, MultiUserData] = {}
    repo_kw = dict(model_names=list(cfg.model_names),
                   predictor_kw=_predictor_kw(cfg))
    for job in cfg.jobs:
        mus[job] = build_multi_user(job, cfg.n_users, cfg.seed)
        first = mus[job].users[0]
        store = RuntimeDataStore(
            mus[job].per_user[first].with_contributor(
                user_contributor(first)),
            seed=cfg.seed, model_names=list(cfg.model_names),
            max_validation_rows=cfg.max_validation_rows, device=cfg.device)
        stores[job] = store
        hub.publish(JobRepo(job, job, SCHEMAS[job], store, **repo_kw))
        # the cold twin: published with only its probe rows (below
        # min_rows, so the gateway will borrow), tested on its full
        # ground-truth dataset (which a real hub never has)
        hub.publish(JobRepo(
            W.cold_job_name(job), f"{job} (cold twin)", W.cold_schema(job),
            RuntimeDataStore(W.cold_probe(job, cfg.seed), seed=cfg.seed,
                             model_names=list(cfg.model_names),
                             device=cfg.device), **repo_kw))
        tests[job] = W.generate_cold_job_data(job, cfg.seed)
    prices = {m.name: m.price for m in W.MACHINES.values()}
    gw = hub.gateway(prices, (2, 3, 4, 6, 8, 12), seed=cfg.seed,
                     transfer=TransferPolicy(min_rows=cfg.min_rows))
    records = _cold_checkpoint(0, gw, stores, tests, cfg)
    for step, pos in enumerate(range(1, cfg.n_users), start=1):
        for job in cfg.jobs:
            u = mus[job].users[pos]
            stores[job].contribute(mus[job].per_user[u].with_contributor(
                user_contributor(u)))
        records += _cold_checkpoint(step, gw, stores, tests, cfg)
    tsv = cold_tsv(records)
    return ColdStartResult(
        config=cfg, records=records, tsv=tsv,
        fingerprint=hashlib.sha256(tsv.encode()).hexdigest(),
        summary=summarize_cold(records, cfg), wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# spot-market replay (cloud market plane evaluation)
# ---------------------------------------------------------------------------

SPOT_COLUMNS = ("job", "query", "tick", "arm", "machine", "zone", "option",
                "scale_out", "predicted_s", "true_s", "realized_s",
                "listed_cost", "expected_cost", "realized_cost")


@dataclass(frozen=True)
class SpotMarketConfig:
    """Interruption-aware placement evaluation: per job family, a seeded
    stream of choose queries is answered by two gateways over the SAME
    emulated spot market (``spark_emul.generate_price_book``) — one
    ranking on interruption-adjusted expected cost, one on the naive
    cheapest listed price (the same book with every interruption rate
    zeroed).  Both choices are then charged their *realized* completion
    cost: true emulated runtime plus seeded Exp(rate) interruption draws
    with restart overhead, priced at the placement's listed rate."""
    jobs: Tuple[str, ...] = tuple(SCHEMAS)
    seed: int = 0
    n_queries: int = 40
    n_ticks: int = 64
    #: seeded interruption realizations averaged per (query, choice) —
    #: the workload recurs (a daily production job), so its realized cost
    #: is a mean over runs, not one lucky/unlucky draw
    n_trials: int = 16
    model_names: Tuple[str, ...] = DEFAULT_MODELS
    max_cv_folds: int = 20
    scaleouts: Tuple[int, ...] = (2, 3, 4, 6, 8, 12)
    device: str = "cuda"


@dataclass
class SpotMarketResult:
    config: SpotMarketConfig
    records: List[dict]
    tsv: str
    fingerprint: str
    summary: Dict[str, dict]
    wall_s: float

    @property
    def ok(self) -> bool:
        """Interruption-adjusted selection must strictly beat the naive
        cheapest-listed-price baseline on total realized completion cost
        for EVERY emulated job family."""
        return bool(self.summary) and all(s["ok"]
                                          for s in self.summary.values())


def spot_tsv(records: Sequence[dict]) -> str:
    """Canonical TSV of the spot-market records (byte-identical across
    reruns of the same config on the same platform)."""
    lines = ["\t".join(SPOT_COLUMNS)]
    for r in records:
        lines.append("\t".join((
            r["job"], str(r["query"]), str(r["tick"]), r["arm"],
            r["machine"], r["zone"], r["option"], str(r["scale_out"]),
            "%.6g" % r["predicted_s"], "%.6g" % r["true_s"],
            "%.6g" % r["realized_s"], "%.6g" % r["listed_cost"],
            "%.6g" % r["expected_cost"], "%.6g" % r["realized_cost"])))
    return "\n".join(lines) + "\n"


def _spot_query_context(job: str, q: int, seed: int) -> Tuple[float, ...]:
    """Seeded query context: a canonical design cell with the (physically
    continuous) dataset size jittered, integer parameters kept on-grid."""
    cells, _ = W._job_cells(job)
    rng = derived_rng("spot-query", job, q, seed)
    cell = list(cells[int(rng.integers(len(cells)))])
    cell[0] = float(cell[0]) * float(rng.uniform(0.85, 1.15))
    return tuple(float(v) for v in cell)


def _spot_realize(job: str, q: int, choice, book, n_trials: int,
                  seed: int) -> Tuple[float, float, float]:
    """(true runtime, realized wall-clock, realized $) for one choice,
    averaged over ``n_trials`` seeded interruption realizations.

    The realizations draw from the REAL market's interruption rate for
    the chosen placement — reality does not care whether the chooser
    priced the risk in — keyed on (job, query, placement, machine,
    scale-out) so both arms making the SAME choice are charged the
    identical draws."""
    ctx = _spot_query_context(job, q, seed)
    true_t = W.true_runtime(job, choice.machine_type,
                            float(choice.scale_out), ctx)
    rate = book.rate_of(choice.zone, choice.purchase_option)
    rng = derived_rng("spot-realize", job, q, choice.zone,
                      choice.purchase_option, choice.machine_type,
                      choice.scale_out, seed)
    realized_s = float(np.mean([
        realized_completion_time_s(true_t, rate, book.restart_overhead_s,
                                   rng) for _ in range(n_trials)]))
    price = book.price_of(choice.machine_type, choice.zone,
                          choice.purchase_option)
    realized_cost = price * (realized_s / 3600.0) * choice.scale_out
    return float(true_t), float(realized_s), float(realized_cost)


def summarize_spot(records: Sequence[dict],
                   cfg: SpotMarketConfig) -> Dict[str, dict]:
    """Per-family rollup: total realized cost per arm, the savings
    ratio, and how often the two arms actually chose differently."""
    summary: Dict[str, dict] = {}
    for job in cfg.jobs:
        rows = [r for r in records if r["job"] == job]
        if not rows:
            continue
        adj = sum(r["realized_cost"] for r in rows
                  if r["arm"] == "adjusted")
        nai = sum(r["realized_cost"] for r in rows if r["arm"] == "naive")
        by_q: Dict[int, dict] = {}
        for r in rows:
            by_q.setdefault(r["query"], {})[r["arm"]] = (
                r["machine"], r["zone"], r["option"], r["scale_out"])
        diverged = sum(1 for d in by_q.values()
                       if d.get("adjusted") != d.get("naive"))
        summary[job] = {
            "adjusted_cost": float(adj), "naive_cost": float(nai),
            "savings": float(nai / adj) if adj > 0 else float("inf"),
            "diverged": int(diverged), "queries": len(by_q),
            "ok": bool(adj < nai),
        }
    return summary


def run_spot_market(cfg: SpotMarketConfig) -> SpotMarketResult:
    """The spot-market evaluation loop (see ``SpotMarketConfig``)."""
    t0 = time.time()
    hub = Hub()
    for job in cfg.jobs:
        store = RuntimeDataStore(
            W.generate_job_data(job, cfg.seed), seed=cfg.seed,
            model_names=list(cfg.model_names), device=cfg.device)
        hub.publish(JobRepo(
            job, job, SCHEMAS[job], store,
            model_names=list(cfg.model_names),
            predictor_kw=_predictor_kw(cfg)))
    prices = {m.name: m.price for m in W.MACHINES.values()}
    book = W.generate_price_book(cfg.seed, cfg.n_ticks)
    naive_book = book.naive_view()
    gw_adj = hub.gateway(prices, cfg.scaleouts, seed=cfg.seed, market=book)
    gw_naive = hub.gateway(prices, cfg.scaleouts, seed=cfg.seed,
                           market=naive_book)
    records: List[dict] = []
    for job in cfg.jobs:
        for q in range(cfg.n_queries):
            tick = q % cfg.n_ticks
            book.seek(tick)
            naive_book.seek(tick)
            ctx = _spot_query_context(job, q, cfg.seed)
            for arm, gw in (("adjusted", gw_adj), ("naive", gw_naive)):
                resp = gw.choose(ChooseRequest(job, ctx, seed=cfg.seed))
                if not resp.ok:
                    raise RuntimeError(
                        f"spot-market choose failed for {job!r}: "
                        f"{resp.error_code}: {resp.detail}")
                c = resp.result
                true_t, realized_s, realized_cost = _spot_realize(
                    job, q, c, book, cfg.n_trials, cfg.seed)
                records.append({
                    "job": job, "query": q, "tick": tick, "arm": arm,
                    "machine": c.machine_type, "zone": c.zone,
                    "option": c.purchase_option,
                    "scale_out": int(c.scale_out),
                    "predicted_s": float(c.predicted_runtime_s),
                    "true_s": true_t, "realized_s": realized_s,
                    "listed_cost": float(c.cost_usd),
                    "expected_cost": float(c.expected_cost_usd),
                    "realized_cost": realized_cost})
    tsv = spot_tsv(records)
    return SpotMarketResult(
        config=cfg, records=records, tsv=tsv,
        fingerprint=hashlib.sha256(tsv.encode()).hexdigest(),
        summary=summarize_spot(records, cfg), wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def add_device_flag(ap: argparse.ArgumentParser) -> None:
    """The eval CLIs' ``--device``: the card unless "cpu" is asked for."""
    ap.add_argument("--device", default="cuda",
                    help='where predictors fit and predict ("cpu" must be '
                         "asked for; there is no fallback)")


def require_device(device: str) -> None:
    """Refuse to start on a card that is not there (as the edge does)."""
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {device}: no CUDA card is available "
                             "(pass --device cpu to run on the CPU)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval.replay",
        description="Leave-one-user-out collaborative replay (paper §VI)")
    ap.add_argument("--users", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jobs", default=",".join(SCHEMAS),
                    help="comma-separated job subset")
    ap.add_argument("--chunks", type=int, default=1,
                    help="contributions each user splits their data into")
    ap.add_argument("--track-models", default=None,
                    help="comma-separated model names to track per "
                         "checkpoint instead of the default pool (e.g. "
                         "'linreg,gbm'; registered custom maintainer "
                         "models are valid — the c3o row is always "
                         "reported)")
    ap.add_argument("--compact-every", type=int, default=0, metavar="N",
                    help="attempt a store compaction (epoch transition, "
                         "cap-escalation ladder) every N contributions; "
                         "0 disables — the accuracy-vs-size frontier mode")
    ap.add_argument("--spot-market", action="store_true",
                    help="cloud-market evaluation: a seeded multi-AZ "
                         "spot/on-demand market (spark_emul."
                         "generate_price_book) answers choose queries "
                         "via interruption-adjusted expected cost vs the "
                         "naive cheapest-listed-price baseline, scored "
                         "on realized completion cost (replay flags "
                         "other than --jobs/--seed/--queries/--out are "
                         "ignored)")
    ap.add_argument("--queries", type=int, default=40,
                    help="choose queries per job family in --spot-market "
                         "mode")
    ap.add_argument("--cold-start-job", default=None, metavar="JOB",
                    help="zero-history transfer evaluation: emulate a "
                         "held-out cold twin of JOB ('all' = every job) "
                         "served by a transfer-enabled gateway, charting "
                         "borrowed-model error vs donor store size "
                         "against the global-mean baseline (replay flags "
                         "other than --users/--seed/--out are ignored)")
    ap.add_argument("--out", default=None,
                    help="trajectory TSV path (default: "
                         "eval_out/replay_users<N>_seed<S>[_compact<N>]"
                         ".tsv)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.compact_every < 0:
        ap.error("--compact-every must be >= 0")
    require_device(args.device)
    if args.spot_market:
        return _main_spot_market(ap, args)
    if args.cold_start_job is not None:
        return _main_cold_start(ap, args)
    track_kw = ({} if args.track_models is None else
                {"track_models": tuple(args.track_models.split(","))})
    cfg = ReplayConfig(jobs=tuple(args.jobs.split(",")), n_users=args.users,
                       seed=args.seed, chunks_per_user=args.chunks,
                       compact_every=args.compact_every,
                       device=args.device, **track_kw)
    res = run_replay(cfg)

    tag = f"_compact{cfg.compact_every}" if cfg.compact_every else ""
    out = args.out or os.path.join(
        "eval_out", f"replay_users{cfg.n_users}_seed{cfg.seed}{tag}.tsv")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(res.tsv)

    for job, s in res.summary.items():
        base = " ".join(f"{m}={v:.4f}" for m, v in sorted(s["baselines"].items()))
        quart = ">".join(f"{q:.4f}" for q in s["quartile_medians"])
        sel = ",".join(f"{k}:{v}" for k, v in sorted(s["selected_counts"].items()))
        comp = (f" retention={s['retention']:.3f} "
                f"epoch={s['final_epoch']}" if cfg.compact_every else "")
        print(f"replay.{job} c3o_final={s['c3o_final']:.4f} {base} "
              f"beats_baselines={s['beats_baselines']} "
              f"quartile_medians={quart} monotone={s['monotone']} "
              f"selected={sel}{comp} ok={s['ok']}")
    print(f"replay.contributions {res.accepted}/{res.contributions} accepted")
    if cfg.compact_every:
        print(f"replay.compactions {res.compactions}/"
              f"{res.compactions_attempted} ladder rungs accepted")
    print(f"replay.trajectory {out} rows={len(res.records)}")
    print(f"replay.fingerprint {res.fingerprint}")
    print(f"replay.wall_s {res.wall_s:.1f}")
    print(f"replay.ok {res.ok}")
    return 0 if res.ok else 1


def _main_spot_market(ap, args) -> int:
    """--spot-market branch of the CLI."""
    jobs = tuple(args.jobs.split(","))
    unknown = [j for j in jobs if j not in SCHEMAS]
    if unknown:
        ap.error(f"--jobs names unknown job(s) {', '.join(unknown)} "
                 f"(known: {', '.join(SCHEMAS)})")
    if args.queries < 1:
        ap.error("--queries must be >= 1")
    cfg = SpotMarketConfig(jobs=jobs, seed=args.seed,
                           n_queries=args.queries, device=args.device)
    res = run_spot_market(cfg)
    out = args.out or os.path.join(
        "eval_out", f"spotmarket_q{cfg.n_queries}_seed{cfg.seed}.tsv")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(res.tsv)
    for job, s in res.summary.items():
        print(f"spotmarket.{job} adjusted=${s['adjusted_cost']:.4f} "
              f"naive=${s['naive_cost']:.4f} savings={s['savings']:.2f}x "
              f"diverged={s['diverged']}/{s['queries']} ok={s['ok']}")
    print(f"spotmarket.trajectory {out} rows={len(res.records)}")
    print(f"spotmarket.fingerprint {res.fingerprint}")
    print(f"spotmarket.wall_s {res.wall_s:.1f}")
    print(f"spotmarket.ok {res.ok}")
    return 0 if res.ok else 1


def _main_cold_start(ap, args) -> int:
    """--cold-start-job branch of the CLI."""
    jobs = tuple(SCHEMAS) if args.cold_start_job == "all" \
        else tuple(args.cold_start_job.split(","))
    unknown = [j for j in jobs if j not in SCHEMAS]
    if unknown:
        ap.error(f"--cold-start-job names unknown job(s) "
                 f"{', '.join(unknown)} (known: {', '.join(SCHEMAS)} "
                 "or 'all')")
    cfg = ColdStartConfig(jobs=jobs, n_users=args.users, seed=args.seed,
                          device=args.device)
    res = run_cold_start(cfg)
    out = args.out or os.path.join(
        "eval_out", f"coldstart_users{cfg.n_users}_seed{cfg.seed}.tsv")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(res.tsv)
    for job, s in res.summary.items():
        print(f"coldstart.{job} borrowed_final={s['borrowed_final']:.4f} "
              f"borrowed_first={s['borrowed_first']:.4f} "
              f"mean_final={s['mean_final']:.4f} "
              f"beats_mean={s['beats_mean']} "
              f"sources={','.join(s['sources'])} "
              f"confidence={s['confidence_final']:.3f}")
    print(f"coldstart.trajectory {out} rows={len(res.records)}")
    print(f"coldstart.fingerprint {res.fingerprint}")
    print(f"coldstart.wall_s {res.wall_s:.1f}")
    print(f"coldstart.ok {res.ok}")
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
