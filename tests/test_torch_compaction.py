"""The port's store lifecycle (epoch-based compaction) against the JAX
package: accept and reject verdicts with their exact side effects
(version, epoch, fingerprint), reputation-preferred retention, epoch
restore through the port's fit sidecar, and the gateway's operator-gated
compact op.  The gate-free paths are numpy on both sides, so reports,
fingerprints and retained rows must be equal; the accuracy-gated path
fits on the port's engine and holds its MAPEs to rtol 1e-4."""
import hashlib

import numpy as np
import pytest

from repro.core import datastore as RD
from repro.core.features import RuntimeData as RefData
from repro.core.trust import ReputationLedger as RefLedger
from repro.workloads import spark_emul as RW
from repro_torch.api import (AuthedRequest, CompactRequest, HubGateway,
                             SearchRequest, TrustAuthority)
from repro_torch.api.types import ERR_UNAUTHORIZED
from repro_torch.core import datastore as PD
from repro_torch.core.features import RuntimeData
from repro_torch.core.hub import Hub, JobRepo
from repro_torch.core.trust import ReputationLedger
from repro_torch.workloads import spark_emul as W

SCALEOUTS = (2, 3, 4, 6, 8, 12, 16)
PRICES = {m.name: m.price for m in W.MACHINES.values()}

#: gate-free knobs — ``accuracy_budget=inf`` skips the engine entirely
GATE_FREE = dict(max_rows_per_cell=2, support_floor=1, cell_rel_width=0.15,
                 accuracy_budget=float("inf"), min_store_rows=1, seed=0)

SIDES = {"ref": (RD.RuntimeDataStore, RW, {}),
         "port": (PD.RuntimeDataStore, W, {"device": "cpu"})}


def _multi_user_store(side="port", job="sort", users=5, seed=0, trust=None):
    """A store grown the collaborative way: user 0 seeds, the rest flow
    through ``contribute`` with real provenance."""
    Store, Wm, kw = SIDES[side]
    store = Store(Wm.generate_user_data(job, 0, seed), seed=seed,
                  trust=trust, **kw)
    for u in range(1, users):
        rep = store.contribute(Wm.generate_user_data(job, u, seed),
                               contributor=f"user-{u}")
        assert rep.accepted
    return store


@pytest.fixture(scope="module")
def grown():
    """The five-user sort store's rows, with provenance, as TSV: grown
    once (every contribution validates through an engine)."""
    store = _multi_user_store("port")
    return store.data.to_tsv(), store.data.schema


def _copies(grown):
    """Fresh (reference, port) stores over the grown rows."""
    tsv, schema = grown
    ref = RD.RuntimeDataStore(RefData.from_tsv(tsv, RW.SCHEMAS["sort"]),
                              seed=0)
    port = PD.RuntimeDataStore(RuntimeData.from_tsv(tsv, schema), seed=0,
                               device="cpu")
    return ref, port


def _snapshot(store):
    return (store.version, store.epoch, store.compactions,
            store.fingerprint, store.data.to_tsv())


def _report(r):
    return (r.accepted, r.code, r.reason, r.rows_before, r.rows_after,
            r.epoch, r.cells)


def test_small_store_compaction_is_typed_rejected_noop():
    store = PD.RuntimeDataStore(W.generate_user_data("sort", 0, 0),
                                device="cpu")
    before = _snapshot(store)
    report = store.compact(seed=0)        # 60 rows < default min of 64
    assert not report.accepted
    assert report.code == PD.COMPACTION_REJECTED
    assert "too small" in report.reason
    assert report.rows_before == report.rows_after == len(store)
    assert _snapshot(store) == before
    assert store.last_compaction is report


@pytest.mark.parametrize("knobs", [
    {}, {"max_rows_per_cell": 1}, {"cell_rel_width": 0.5},
    {"support_floor": 10 ** 6}, {"max_rows_per_cell": 10 ** 6}])
def test_gate_free_compaction_equals_the_reference(grown, knobs):
    """Same verdict, same rows kept, same version, epoch and reseeded
    fingerprint as the JAX package's store."""
    ref, port = _copies(grown)
    assert _snapshot(port) == _snapshot(ref)
    rr = ref.compact(**{**GATE_FREE, **knobs})
    rp = port.compact(**{**GATE_FREE, **knobs})
    assert _report(rp) == _report(rr)
    assert _snapshot(port) == _snapshot(ref)
    assert port.rows_contributed == ref.rows_contributed


def test_accepted_compaction_bumps_epoch_and_reseeds_fingerprint(grown):
    store = _copies(grown)[1]
    n, ver = len(store), store.version
    contributed = store.rows_contributed
    report = store.compact(**GATE_FREE)
    assert report.accepted and report.code == PD.COMPACTED
    assert report.rows_before == n and report.rows_after == len(store) < n
    assert (store.version, store.epoch, store.compactions) == (ver + 1, 1, 1)
    assert store.fingerprint == hashlib.sha256(
        store.data.to_tsv().encode()).hexdigest()
    assert store.fingerprint == PD.RuntimeDataStore(
        store.data, device="cpu").fingerprint
    assert store.rows_contributed == contributed > len(store)


def test_compaction_knobs_are_validated():
    store = _multi_user_store(users=2)
    for bad in ({"max_rows_per_cell": 0}, {"support_floor": -1},
                {"cell_rel_width": 0.0}, {"cell_rel_width": 1.5}):
        with pytest.raises(ValueError):
            store.compact(**{**GATE_FREE, **bad})


def test_reputation_preferred_retention_as_the_reference():
    out = []
    for Ledger, Data, Store, Wm, kw in (
            (RefLedger, RefData, RD.RuntimeDataStore, RW, {}),
            (ReputationLedger, RuntimeData, PD.RuntimeDataStore, W,
             {"device": "cpu"})):
        led = Ledger()
        for _ in range(10):
            led.record_outcome("good", True, 1.0)
            led.record_outcome("bad", False, 0.0)
        assert led.row_weight("bad") < led.row_weight("good")
        d = Wm.generate_user_data("sort", 0, 0)
        good = d.with_contributor("good")
        bad = Data(d.schema, d.machine_type, d.X,
                   d.y * 1.01).with_contributor("bad")
        store = Store(good.append(bad), trust=led, **kw)
        report = store.compact(**{**GATE_FREE, "max_rows_per_cell": 1})
        assert report.accepted
        counts = store.data.contributor_counts()
        assert counts.get("bad", 0) == 0
        assert counts["good"] == len(store)
        out.append(_snapshot(store))
    assert out[1] == out[0]


def test_accuracy_gated_compaction_matches_the_reference(grown):
    """The engine-backed gate: the candidate store's holdout MAPE against
    the baseline's, fitted on the port's engine (CPU) and on the JAX
    package's."""
    knobs = dict(max_rows_per_cell=2, support_floor=1, cell_rel_width=0.15,
                 accuracy_budget=0.05, min_store_rows=1, seed=0)
    ref, port = _copies(grown)
    rr, rp = ref.compact(**knobs), port.compact(**knobs)
    assert _report(rp)[:2] == _report(rr)[:2]
    np.testing.assert_allclose([rp.baseline_mape, rp.candidate_mape],
                               [rr.baseline_mape, rr.candidate_mape],
                               rtol=1e-4)
    assert _snapshot(port) == _snapshot(ref)


def test_epoch_restored_from_fits_sidecar(grown, tmp_path):
    store = _copies(grown)[1]
    repo = JobRepo("sort", "sort", W.SCHEMAS["sort"], store,
                   model_names=["ernest"],
                   predictor_kw={"device": "cpu", "max_cv_folds": 8})
    assert store.compact(**GATE_FREE).accepted
    repo.predictor_for("c5.xlarge")
    path = JobRepo.fits_path(str(tmp_path / "sort.tsv"))
    assert repo.save_fits(path) == 1

    reopened = PD.RuntimeDataStore(
        RuntimeData.from_tsv(store.data.to_tsv(), store.data.schema),
        device="cpu")
    assert reopened.fingerprint == store.fingerprint
    assert (reopened.epoch, reopened.compactions) == (0, 0)
    repo2 = JobRepo("sort", "sort", W.SCHEMAS["sort"], reopened,
                    model_names=["ernest"], predictor_kw={"device": "cpu"})
    assert repo2.load_fits(path) == 1
    assert (reopened.epoch, reopened.compactions) == (1, 1)

    other = PD.RuntimeDataStore(W.generate_user_data("sort", 7, 0),
                                device="cpu")
    repo3 = JobRepo("sort", "sort", W.SCHEMAS["sort"], other,
                    model_names=["ernest"], predictor_kw={"device": "cpu"})
    assert repo3.load_fits(path) == 0
    assert (other.epoch, other.compactions) == (0, 0)


def test_restore_epoch_is_forward_only():
    store = _multi_user_store(users=2)
    store.restore_epoch(3, compactions=2)
    assert (store.epoch, store.compactions) == (3, 2)
    store.restore_epoch(1, compactions=9)
    assert (store.epoch, store.compactions) == (3, 2)


def _gateway(store, auth=None):
    hub = Hub()
    hub.publish(JobRepo("sort", "sort", W.SCHEMAS["sort"], store,
                        predictor_kw={"device": "cpu"}))
    return HubGateway(hub, PRICES, SCALEOUTS, auth=auth)


def test_gateway_compact_parity_with_direct_store(grown):
    shadow, port = _copies(grown)
    gw = _gateway(port)
    req = CompactRequest("sort", accuracy_budget=float("inf"),
                         min_store_rows=1, max_rows_per_cell=2,
                         support_floor=1, seed=0)
    resp = gw.compact(req)
    direct = shadow.compact(**{**GATE_FREE, "seed": gw._seed(None)})
    assert resp.ok and resp.result.accepted
    got = resp.result
    assert (got.code, got.rows_before, got.rows_after, got.epoch,
            got.cells) == (direct.code, direct.rows_before,
                           direct.rows_after, direct.epoch, direct.cells)
    assert got.fingerprint == shadow.fingerprint
    info = gw.search(SearchRequest("sort")).result.jobs[0]
    assert (info.rows, info.epoch, info.compactions) == (
        got.rows_after, 1, 1)
    assert info.rows_contributed == direct.rows_before


def test_gateway_rejected_compaction_is_ok_envelope():
    gw = _gateway(_multi_user_store(users=1))
    resp = gw.compact(CompactRequest("sort"))
    assert resp.ok and not resp.result.accepted
    assert resp.result.code == PD.COMPACTION_REJECTED
    assert gw.search(SearchRequest("sort")).result.jobs[0].epoch == 0


def test_gateway_compact_is_operator_only_under_auth(grown):
    gw = _gateway(_copies(grown)[1], auth=TrustAuthority())
    token = gw.issue_token("carol")
    req = AuthedRequest(token, CompactRequest(
        "sort", accuracy_budget=float("inf"), min_store_rows=1))
    resp = gw.compact(req)
    assert not resp.ok and resp.error_code == ERR_UNAUTHORIZED
    assert "operator" in resp.detail
    gw.grant_operator("carol")
    resp = gw.compact(req)
    assert resp.ok and resp.result.accepted and resp.result.epoch == 1
    gw.revoke_operator("carol")
    assert not gw.compact(req).ok
