"""Adversarial replay: measuring the trust plane under poisoned traffic.

The collaborative premise is attacked directly: a fraction of the
emulated users are adversaries (``spark_emul.adversarial_user_data`` —
runtime-scaling poisoners, high-variance noise, dataset-size column
shift, near-duplicate spam), and each job is replayed twice over the
SAME contribution stream:

  * ``weighting=off`` — the plain §III-C.b store: validation accepts or
    rejects each chunk against the fixed threshold, accepted rows enter
    at full weight;
  * ``weighting=on``  — the same store with a ``ReputationLedger``:
    per-contributor acceptance thresholds adapt, accepted rows enter
    fits at reputation-derived weights, and high-reputation contributors
    get graceful degradation.

After every contribution the held-out honest user's rows are scored
(exactly the replay plane's checkpoint), producing twin error
trajectories whose gap IS the trust plane's measured value.  The run
passes when the reputation-weighted arm's final C3O MAPE is strictly
below the weighting-off arm's on EVERY job.

Determinism mirrors ``repro_torch.eval.replay``: all RNGs derive from
SHA-256 identity keys, the trajectory TSV is canonical, and its SHA-256
fingerprint is byte-identical across runs of the same config.

Every fit runs on the config's ``device`` ("cuda" unless "cpu" is
asked for), as in ``repro_torch.eval.replay``.

CLI:
    PYTHONPATH=src python -m repro_torch.eval.adversarial --users 8 \
        --poison 0.25 --seed 0 [--device cpu]
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

from repro_torch.core.datastore import RuntimeDataStore
from repro_torch.core.hub import JobRepo
from repro_torch.core.predictor import DEFAULT_MODELS
from repro_torch.core.trust import ReputationLedger
from repro_torch.eval.dataset import contribution_chunks, derived_rng, \
    user_contributor
from repro_torch.eval.replay import (TRAJECTORY_COLUMNS, _checkpoint,
                                     _predictor_kw, add_device_flag,
                                     require_device)
from repro_torch.workloads.spark_emul import (ADVERSARY_KINDS, SCHEMAS,
                                        adversarial_user_data,
                                        generate_user_data)

#: the replay columns plus which arm (off/on) a record belongs to
ADV_TRAJECTORY_COLUMNS = ("weighting",) + TRAJECTORY_COLUMNS

WEIGHTING_ARMS = ("off", "on")


@dataclass(frozen=True)
class AdversarialConfig:
    jobs: Tuple[str, ...] = tuple(SCHEMAS)
    n_users: int = 8
    poison_fraction: float = 0.25
    seed: int = 0
    chunks_per_user: int = 2          # early outcomes inform later chunks
    holdouts: int = 1                 # honest users held out per job
    model_names: Tuple[str, ...] = DEFAULT_MODELS
    track_models: Tuple[str, ...] = DEFAULT_MODELS + ("linreg",)
    max_cv_folds: int = 20
    max_validation_rows: int = 1024
    device: str = "cuda"

    def poisoners(self) -> Tuple[int, ...]:
        """The LAST ceil(n_users * poison_fraction) user ids are the
        adversaries (a fixed, order-independent convention)."""
        k = math.ceil(self.n_users * self.poison_fraction)
        return tuple(range(self.n_users - k, self.n_users))

    def honest(self) -> Tuple[int, ...]:
        cut = self.n_users - len(self.poisoners())
        return tuple(range(cut))

    def attack_of(self, user: int) -> str:
        """Deterministic attack assignment: poisoners cycle through the
        repertoire in id order."""
        poisoners = self.poisoners()
        return ADVERSARY_KINDS[poisoners.index(user) % len(ADVERSARY_KINDS)]


@dataclass
class AdversarialResult:
    config: AdversarialConfig
    records: List[dict]
    tsv: str
    fingerprint: str
    summary: Dict[str, dict]
    wall_s: float
    contributions: int = 0            # attempted, across both arms
    accepted: int = 0

    @property
    def ok(self) -> bool:
        return bool(self.summary) and \
            all(s["ok"] for s in self.summary.values())


# ---------------------------------------------------------------------------
# replay core
# ---------------------------------------------------------------------------

def _user_chunks(job: str, user: int, cfg: AdversarialConfig):
    """One user's contribution batches, poisoned if the user is an
    adversary, stamped with real provenance either way."""
    if user in cfg.poisoners():
        data = adversarial_user_data(job, user, cfg.seed,
                                     cfg.attack_of(user))
    else:
        data = generate_user_data(job, user, cfg.seed)
    return [c.with_contributor(user_contributor(user))
            for c in contribution_chunks(
                data, cfg.chunks_per_user,
                derived_rng("adv-chunks", job, user, cfg.seed))]


def replay_job_adversarial(job: str, cfg: AdversarialConfig
                           ) -> Tuple[List[dict], int, int]:
    """Twin-arm adversarial replay of one job.

    Returns (trajectory records, contributions attempted, accepted)."""
    poisoners = set(cfg.poisoners())
    honest = cfg.honest()
    if len(honest) < 2:
        raise ValueError(
            f"{cfg.n_users} users at poison_fraction="
            f"{cfg.poison_fraction} leaves {len(honest)} honest users; "
            "need >= 2 (a held-out honest user plus at least one honest "
            "contributor)")
    records: List[dict] = []
    contributions = accepted = 0
    for held in honest[:max(1, cfg.holdouts)]:
        test = generate_user_data(job, held, cfg.seed)
        chunks = []                    # (is_poison, RuntimeData)
        for u in range(cfg.n_users):
            if u == held:
                continue
            chunks.extend((u in poisoners, c)
                          for c in _user_chunks(job, u, cfg))
        order = list(derived_rng("adv-order", job, held, cfg.seed)
                     .permutation(len(chunks)))
        # the seeding chunk bypasses validation (it IS the baseline), so
        # rotate the shared order until an honest chunk leads: an
        # adversary must not get a free pass into either arm's store
        while chunks[order[0]][0]:
            order = order[1:] + order[:1]
        for arm in WEIGHTING_ARMS:
            trust = None if arm == "off" else ReputationLedger()
            store = RuntimeDataStore(
                chunks[order[0]][1], seed=cfg.seed,
                model_names=list(cfg.model_names),
                max_validation_rows=cfg.max_validation_rows, trust=trust,
                device=cfg.device)
            repo = JobRepo(job, job, test.schema, store,
                           model_names=list(cfg.model_names),
                           predictor_kw=_predictor_kw(cfg))
            extra = {"weighting": arm}
            records += _checkpoint(job, held, 0, repo, test, cfg,
                                   extra=extra)
            for step, ci in enumerate(order[1:], start=1):
                report = store.contribute(chunks[ci][1])
                contributions += 1
                accepted += bool(report.accepted)
                records += _checkpoint(job, held, step, repo, test, cfg,
                                       extra=extra)
    return records, contributions, accepted


# ---------------------------------------------------------------------------
# trajectory TSV + summary
# ---------------------------------------------------------------------------

def trajectory_tsv(records: Sequence[dict]) -> str:
    """Canonical TSV (byte-identical across runs of the same config)."""
    lines = ["\t".join(ADV_TRAJECTORY_COLUMNS)]
    for r in records:
        lines.append("\t".join((
            r["weighting"], r["job"], str(r["held_out"]), str(r["step"]),
            str(r["store_rows"]),
            str(r.get("rows_contributed", r["store_rows"])),
            str(r.get("epoch", 0)), r["machine"], r["model"],
            "%.6g" % r["mape"], "%.6g" % r["mae"], r["selected"])))
    return "\n".join(lines) + "\n"


def summarize(records: Sequence[dict],
              cfg: AdversarialConfig) -> Dict[str, dict]:
    """Per-job rollup: final-store C3O MAPE per arm; ``ok`` iff the
    reputation-weighted arm strictly beats weighting-off."""
    summary: Dict[str, dict] = {}
    for job in cfg.jobs:
        rows = [r for r in records if r["job"] == job and r["model"] == "c3o"]
        if not rows:
            continue
        finals: Dict[str, float] = {}
        for arm in WEIGHTING_ARMS:
            arm_rows = [r for r in rows if r["weighting"] == arm]
            last: Dict[int, int] = {}
            for r in arm_rows:
                last[r["held_out"]] = max(r["step"],
                                          last.get(r["held_out"], 0))
            vals = [r["mape"] for r in arm_rows
                    if r["step"] == last[r["held_out"]]]
            finals[arm] = sum(vals) / len(vals)
        improvement = finals["off"] - finals["on"]
        summary[job] = {
            "off_final": finals["off"],
            "on_final": finals["on"],
            "improvement": improvement,
            "ok": finals["on"] < finals["off"],
        }
    return summary


def run_adversarial(cfg: AdversarialConfig) -> AdversarialResult:
    t0 = time.time()
    records: List[dict] = []
    contributions = accepted = 0
    for job in cfg.jobs:
        recs, contribs, acc = replay_job_adversarial(job, cfg)
        records += recs
        contributions += contribs
        accepted += acc
    tsv = trajectory_tsv(records)
    return AdversarialResult(
        config=cfg, records=records, tsv=tsv,
        fingerprint=hashlib.sha256(tsv.encode()).hexdigest(),
        summary=summarize(records, cfg), wall_s=time.time() - t0,
        contributions=contributions, accepted=accepted)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval.adversarial",
        description="Adversarial replay: reputation weighting on vs off "
                    "under a poisoned contributor mix")
    ap.add_argument("--users", type=int, default=8)
    ap.add_argument("--poison", type=float, default=0.25,
                    help="fraction of users that are adversaries")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--jobs", default=",".join(SCHEMAS),
                    help="comma-separated job subset")
    ap.add_argument("--chunks", type=int, default=2,
                    help="contributions each user splits their data into")
    ap.add_argument("--holdouts", type=int, default=1,
                    help="honest users held out per job")
    ap.add_argument("--out", default=None,
                    help="trajectory TSV path (default: eval_out/"
                         "adversarial_users<N>_poison<P>_seed<S>.tsv)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    require_device(args.device)
    cfg = AdversarialConfig(jobs=tuple(args.jobs.split(",")),
                            n_users=args.users,
                            poison_fraction=args.poison, seed=args.seed,
                            chunks_per_user=args.chunks,
                            holdouts=args.holdouts, device=args.device)
    res = run_adversarial(cfg)

    out = args.out or os.path.join(
        "eval_out", f"adversarial_users{cfg.n_users}_poison"
        f"{cfg.poison_fraction:g}_seed{cfg.seed}.tsv")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(res.tsv)

    kinds = ",".join(f"{user_contributor(u)}:{cfg.attack_of(u)}"
                     for u in cfg.poisoners())
    print(f"adversarial.poisoners {kinds}")
    for job, s in res.summary.items():
        print(f"adversarial.{job} off_final={s['off_final']:.4f} "
              f"on_final={s['on_final']:.4f} "
              f"improvement={s['improvement']:.4f} ok={s['ok']}")
    print(f"adversarial.contributions {res.accepted}/{res.contributions} "
          f"accepted")
    print(f"adversarial.trajectory {out} rows={len(res.records)}")
    print(f"adversarial.fingerprint {res.fingerprint}")
    print(f"adversarial.wall_s {res.wall_s:.1f}")
    print(f"adversarial.ok {res.ok}")
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
