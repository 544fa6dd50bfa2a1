"""The port's eval dataset assembly (``repro_torch.eval.dataset``) against
the JAX package's (``repro.eval.dataset``): numpy only on both sides, so
per-user datasets, contribution chunks and provenance splits must match
byte for byte."""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.eval import dataset as RD
from repro.workloads.spark_emul import SCHEMAS
from repro_torch import eval as port_eval
from repro_torch.eval import dataset as D

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _assert_same_data(a, b):
    """Two RuntimeData (JAX package's, port's) hold the same bytes."""
    assert a.schema.job == b.schema.job
    assert a.schema.feature_names == b.schema.feature_names
    np.testing.assert_array_equal(np.asarray(a.machine_type),
                                  np.asarray(b.machine_type))
    for col in ("X", "y", "scale_out", "context", "runtime"):
        x, y = np.asarray(getattr(a, col)), np.asarray(getattr(b, col))
        assert x.dtype == y.dtype and x.shape == y.shape, col
        assert x.tobytes() == y.tobytes(), col
    assert tuple(a.contributors) == tuple(b.contributors)
    assert np.asarray(a.ccodes).tobytes() == np.asarray(b.ccodes).tobytes()


@pytest.mark.parametrize("job", sorted(SCHEMAS))
def test_multi_user_datasets_are_the_references_bytes(job):
    ref = RD.build_multi_user(job, 3, seed=1)
    got = D.build_multi_user(job, 3, seed=1)
    assert got.job == ref.job and got.users == ref.users
    assert got.rows_total() == ref.rows_total()
    for u in ref.users:
        _assert_same_data(ref.per_user[u], got.per_user[u])


@pytest.mark.parametrize("n_chunks", [1, 3, 1000])
def test_contribution_chunks_are_the_references_partition(n_chunks):
    ref_d = RD.build_multi_user("kmeans", 2, seed=0).per_user[1]
    d = D.build_multi_user("kmeans", 2, seed=0).per_user[1]
    ref = RD.contribution_chunks(ref_d, n_chunks,
                                 RD.derived_rng("chunks", "kmeans", 1, 0))
    got = D.contribution_chunks(d, n_chunks,
                                D.derived_rng("chunks", "kmeans", 1, 0))
    assert len(got) == len(ref) == min(n_chunks, len(d))
    for a, b in zip(ref, got):
        _assert_same_data(a, b)
    # a partition of the user's rows, each chunk in the rows' own order
    rows = np.concatenate([c.y for c in got])
    assert sorted(rows.tolist()) == sorted(d.y.tolist())


def test_provenance_stamps_and_splits_as_the_reference():
    assert D.user_contributor(7) == RD.user_contributor(7) == "user7"
    ref_mu = RD.build_multi_user("grep", 3, seed=0)
    mu = D.build_multi_user("grep", 3, seed=0)
    ref_all = got_all = None
    for u in (2, 0, 1):                    # out of id order
        r = ref_mu.per_user[u].with_contributor(RD.user_contributor(u))
        g = mu.per_user[u].with_contributor(D.user_contributor(u))
        ref_all = r if ref_all is None else ref_all.append(r)
        got_all = g if got_all is None else got_all.append(g)
    _assert_same_data(ref_all, got_all)
    ref_split = RD.split_by_contributor(ref_all)
    split = D.split_by_contributor(got_all)
    assert list(split) == list(ref_split)
    assert sorted(split) == ["user0", "user1", "user2"]
    for name in split:
        _assert_same_data(ref_split[name], split[name])
        u = int(name[len("user"):])
        np.testing.assert_array_equal(split[name].y, mu.per_user[u].y)


def test_package_exports_and_leaves_the_cli_unimported():
    """Same exports as ``repro.eval``; importing the package does not
    import the ``python -m`` entry point (runpy would run it twice)."""
    assert port_eval.__all__ == ["MultiUserData", "build_multi_user",
                                 "contribution_chunks"]
    import repro.eval as ref_eval
    assert port_eval.__all__ == ref_eval.__all__
    code = ("import sys, repro_torch.eval; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch.eval')))")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == "['repro_torch.eval', 'repro_torch.eval.dataset']"
