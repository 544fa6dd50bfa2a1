"""The port's fit sidecars (``JobRepo.save_fits`` / ``load_fits``): a
round trip restores every predictor without a refit and with the fitted
predictions' bits; a stale fingerprint, a moved trust version or a
changed model list drops the entries; a corrupt, foreign or JAX-package
sidecar is a logged cache miss that never imports JAX or the JAX
package."""
import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.core import JobRepo, RuntimeDataStore, engine
from repro_torch.core.trust import ReputationLedger
from repro_torch.workloads import spark_emul as W

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KW = {"device": "cpu", "max_cv_folds": 15, "pad_rows": True}


def _repo(data=None, trust=None, model_names=None):
    d = W.generate_job_data("grep") if data is None else data
    kw = {} if model_names is None else {"model_names": list(model_names)}
    return JobRepo("grep", "grep", d.schema,
                   RuntimeDataStore(d, seed=0, trust=trust, device="cpu"),
                   predictor_kw=dict(KW), **kw)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A repo with every machine's predictor fitted, and its sidecar."""
    repo = _repo()
    fitted = {m: repo.predictor_for(m)
              for m in repo.store.data.present_machines()}
    path = JobRepo.fits_path(str(tmp_path_factory.mktemp("fits")
                                 / "grep.tsv"))
    assert path.endswith(".fits.npz")
    assert repo.save_fits(path) == len(fitted)
    return repo, fitted, path


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_round_trip_restores_without_refit_and_predicts_the_same_bits(saved):
    repo, fitted, path = saved
    fresh = _repo()
    engine.cache_clear()
    assert fresh.load_fits(path) == len(fitted)
    rows = repo.store.data.X
    for m, want in fitted.items():
        got = fresh.predictor_for(m)
        assert got.selected == want.selected
        assert (got.mu, got.sigma) == (want.mu, want.sigma)
        assert got.cv_mape == want.cv_mape
        np.testing.assert_array_equal(_bits(got.predict(rows)),
                                      _bits(want.predict(rows)))
    stats = engine.cache_stats()
    assert stats["fit"] == 0 and stats["cv"] == 0, stats


def test_sidecar_holds_only_fits_of_the_current_store_version(saved,
                                                              tmp_path):
    """After an accepted contribution the stale fits are not saved, and a
    sidecar written before it no longer matches the store's
    fingerprint."""
    _, _, old_path = saved
    repo = _repo()
    repo.predictor_for("m5.xlarge")
    assert repo.contribute(W.generate_user_data("grep", 1),
                           contributor="u1").accepted
    path = str(tmp_path / "grown.fits.npz")
    assert repo.save_fits(path) == 0
    assert repo.load_fits(old_path) == 0          # stale fingerprint


def test_trust_version_drift_drops_entries(tmp_path):
    """A fit made under other reputation state used other row weights:
    same rows, a ledger that has judged one more outcome, no restore."""
    repo = _repo(trust=ReputationLedger(), model_names=("ernest",))
    repo.predictor_for("m5.xlarge")
    path = str(tmp_path / "t.fits.npz")
    assert repo.save_fits(path) == 1
    assert _repo(trust=ReputationLedger(),
                 model_names=("ernest",)).load_fits(path) == 1
    moved = ReputationLedger()
    moved.record_outcome("someone", False, 0.0)
    fresh = _repo(trust=moved, model_names=("ernest",))
    assert fresh.store.fingerprint == repo.store.fingerprint
    assert fresh.store.trust_version != repo.store.trust_version
    assert fresh.load_fits(path) == 0


def test_changed_model_list_drops_entries(saved):
    _, _, path = saved
    other = _repo(model_names=("ernest", "gbm"))
    assert other.load_fits(path) == 0


@pytest.mark.parametrize("damage", ["truncated", "garbage", "empty",
                                    "missing", "foreign_npz",
                                    "foreign_format"])
def test_damaged_or_foreign_sidecar_is_a_logged_miss(saved, tmp_path,
                                                     caplog, damage):
    _, _, good = saved
    path = str(tmp_path / f"{damage}.fits.npz")
    blob = open(good, "rb").read()
    if damage == "truncated":
        open(path, "wb").write(blob[:len(blob) // 2])
    elif damage == "garbage":
        open(path, "wb").write(os.urandom(4096))
    elif damage == "empty":
        open(path, "wb").close()
    elif damage == "foreign_npz":
        np.savez(open(path, "wb"), x=np.arange(3))
    elif damage == "foreign_format":
        import io
        import json
        meta = json.dumps({"format": "someone-else-1", "entries": []})
        buf = io.BytesIO()
        np.savez(buf, meta=np.frombuffer(meta.encode(), np.uint8))
        open(path, "wb").write(buf.getvalue())
    repo = _repo()
    with caplog.at_level(logging.WARNING):
        assert repo.load_fits(path) == 0
    if damage != "foreign_format":          # readable: a plain mismatch
        assert "unreadable" in caplog.text
    assert repo._fit_cache == {}


def test_unknown_params_class_in_a_sidecar_is_skipped(saved, tmp_path):
    """Reading resolves no class outside the port's params table."""
    import io
    import json
    _, _, good = saved
    with np.load(good, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(arrays.pop("meta").tobytes().decode())
    for e in meta["entries"]:
        e["params"]["kind"] = "os.system"
    buf = io.BytesIO()
    np.savez(buf, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             **arrays)
    path = str(tmp_path / "evil.fits.npz")
    open(path, "wb").write(buf.getvalue())
    assert _repo().load_fits(path) == 0


REFERENCE_SIDECAR = textwrap.dedent("""
    import sys
    from repro.core.datastore import RuntimeDataStore
    from repro.core.hub import JobRepo
    from repro.workloads import spark_emul as W
    d = W.generate_job_data("grep")
    repo = JobRepo("grep", "grep", d.schema, RuntimeDataStore(d, seed=0),
                   model_names=["ernest"], predictor_kw={"max_cv_folds": 8})
    repo.predictor_for("m5.xlarge")
    print("SAVED", repo.save_fits(sys.argv[1]))
""")

PORT_READS = textwrap.dedent("""
    import logging, sys
    logging.basicConfig(level=logging.WARNING)
    from repro_torch.core import JobRepo, RuntimeDataStore
    from repro_torch.workloads import spark_emul as W
    d = W.generate_job_data("grep")
    repo = JobRepo("grep", "grep", d.schema,
                   RuntimeDataStore(d, seed=0, device="cpu"),
                   model_names=["ernest"], predictor_kw={"device": "cpu"})
    print("RESTORED", repo.load_fits(sys.argv[1]))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print("LOADED", bad)
""")


def test_reference_sidecar_is_a_miss_that_imports_no_jax(tmp_path):
    """The JAX package's pickled sidecar, read by the port in a process
    of its own: a logged miss, and neither JAX nor the JAX package is
    imported (unpickling it would import both)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               JAX_PLATFORMS="cpu")
    path = str(tmp_path / "grep.tsv.fits.pkl")
    r = subprocess.run([sys.executable, "-c", REFERENCE_SIDECAR, path],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "SAVED 1" in r.stdout, r.stderr
    r = subprocess.run([sys.executable, "-c", PORT_READS, path], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "RESTORED 0" in r.stdout
    assert "LOADED []" in r.stdout
    assert "unreadable" in r.stderr
