"""Multi-user dataset assembly for the collaborative replay plane.

Each simulated user runs one job under their own execution context
(``spark_emul.user_design``: a user-specific subset of context cells and
scale-outs with smoothly perturbed continuous features) and measures it
with a user-specific noise stream.  Users therefore overlap in *structure*
but never in exact context — the heterogeneity leave-one-user-out
generalization is measured over.

Everything here is deterministic in (job, user id, seed): RNGs are seeded
from SHA-256 of the identity key, never from global state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.features import RuntimeData
from repro_torch.workloads import spark_emul
from repro_torch.workloads.spark_emul import derived_rng  # single seed mapping

__all__ = ["MultiUserData", "build_multi_user", "contribution_chunks",
           "derived_rng", "user_contributor", "split_by_contributor"]


def user_contributor(user: int) -> str:
    """Canonical contributor id an emulated user's contributions carry."""
    return f"user{int(user)}"


def split_by_contributor(data: RuntimeData) -> Dict[str, RuntimeData]:
    """Partition provenance-carrying rows back into per-contributor
    datasets (row order preserved).  This is the leave-one-user-out
    inverse over REAL provenance: a store grown through contributions
    stamped with contributor ids — replay output, gateway traffic —
    splits into exactly the per-user datasets that built it, no synthetic
    user bookkeeping needed."""
    out = {}
    for code, name in enumerate(data.contributors):
        rows = np.nonzero(data.ccodes == code)[0]
        if len(rows):
            out[name] = data.subset(rows)
    return out


@dataclass(frozen=True)
class MultiUserData:
    """One job's multi-user dataset: per-user contribution-ready rows."""
    job: str
    users: Tuple[int, ...]
    per_user: Dict[int, RuntimeData]

    def rows_total(self) -> int:
        return sum(len(d) for d in self.per_user.values())


def build_multi_user(job: str, n_users: int, seed: int = 0,
                     **design_kw) -> MultiUserData:
    """Emulate ``n_users`` collaborating users of one job.

    Every user's row count is identical by construction (see
    ``spark_emul.user_design``), so replayed store sizes coincide across
    held-out users and the engine's shape-bucketed executables are shared
    across the whole leave-one-user-out sweep."""
    users = tuple(range(n_users))
    per_user = {u: spark_emul.generate_user_data(job, u, seed, **design_kw)
                for u in users}
    return MultiUserData(job, users, per_user)


def contribution_chunks(data: RuntimeData, n_chunks: int,
                        rng: np.random.Generator) -> List[RuntimeData]:
    """Split one user's rows into contribution batches.

    Rows are assigned to batches by a seeded permutation (a user uploads
    measurements in no particular order) but keep their original relative
    order inside each batch, so batch TSV encodings — and therefore the
    store's fingerprint chain — are canonical."""
    n = len(data)
    n_chunks = max(1, min(n_chunks, n))
    perm = rng.permutation(n)
    return [data.subset(np.sort(part))
            for part in np.array_split(perm, n_chunks) if len(part)]
