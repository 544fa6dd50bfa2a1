"""Cold-start transfer in the port against the JAX package: job
signatures, similarity and nearest-job lookups on the same stores, the
signature properties (symmetric, bounded, permutation-invariant,
self-maximal) on seeded random data, and the version-keyed caches of the
hub's transfer index.  Both sides are numpy, so signatures and
similarities must be equal, not merely close."""
import numpy as np
import pytest

from repro.core import transfer as RT
from repro.core.datastore import RuntimeDataStore as RefStore
from repro.core.features import JobSchema as RefSchema
from repro.core.features import RuntimeData as RefData
from repro.core.hub import Hub as RefHub
from repro.core.hub import JobRepo as RefRepo
from repro.workloads import spark_emul as RW
from repro_torch.core import transfer as PT
from repro_torch.core.datastore import RuntimeDataStore
from repro_torch.core.features import JobSchema, RuntimeData
from repro_torch.core.hub import Hub, JobRepo
from repro_torch.workloads import spark_emul as PW

FAMILIES = ("sort", "grep", "sgd", "kmeans", "pagerank")


def _random_columns(seed, n, k):
    rng = np.random.default_rng(seed)
    names = [f"m{i}" for i in range(int(rng.integers(1, 4)))]
    machine_type = np.asarray(names)[rng.integers(0, len(names), size=n)]
    X = np.empty((n, k + 2))
    X[:, 0] = rng.integers(1, 64, size=n)
    X[:, 1:] = rng.uniform(0.05, 1000.0, size=(n, k + 1))
    y = rng.uniform(0.05, 5000.0, size=n)
    return machine_type, X, y


def _both(seed, n, k, job="prop"):
    """The same seeded random runtime data as (reference, port)."""
    mt, X, y = _random_columns(seed, n, k)
    cols = tuple(f"c{i}" for i in range(k))
    return (RefData(RefSchema(job, cols), mt, X, y),
            RuntimeData(JobSchema(job, cols), mt, X, y))


@pytest.mark.parametrize("seed,n,k", [(0, 1, 0), (1, 7, 1), (2, 30, 2),
                                      (3, 60, 3), (4, 2, 0)])
def test_signature_equals_the_reference(seed, n, k):
    ref, port = _both(seed, n, k)
    assert PT.job_signature(port).__dict__ == RT.job_signature(ref).__dict__


@pytest.mark.parametrize("seed", range(6))
def test_similarity_equals_the_reference_and_keeps_its_properties(seed):
    k = seed % 4
    ra, pa = _both(seed, 5 + 9 * seed, k, "a")
    rb, pb = _both(100 + seed, 3 + 11 * seed, k if seed % 3 else 3 - k, "b")
    sa, sb = PT.job_signature(pa), PT.job_signature(pb)
    got = PT.similarity(sa, sb)
    assert got == RT.similarity(RT.job_signature(ra), RT.job_signature(rb))
    assert got == PT.similarity(sb, sa)
    assert 0.0 <= got <= 1.0
    assert PT.similarity(sa, sa) == pytest.approx(1.0)
    assert PT.similarity(sa, sa) >= got
    perm = np.random.default_rng(seed).permutation(len(pa))
    assert PT.job_signature(pa.subset(perm)) == sa


def test_cold_probes_rank_their_own_family_first_as_the_reference():
    sigs = {j: PT.job_signature(PW.generate_job_data(j, 0), j)
            for j in FAMILIES}
    rsigs = {j: RT.job_signature(RW.generate_job_data(j, 0), j)
             for j in FAMILIES}
    for job in FAMILIES:
        probe = PT.job_signature(PW.cold_probe(job, 0))
        rprobe = RT.job_signature(RW.cold_probe(job, 0))
        scores = {d: PT.similarity(probe, s) for d, s in sigs.items()
                  if s.n_features == probe.n_features}
        want = {d: RT.similarity(rprobe, s) for d, s in rsigs.items()
                if s.n_features == rprobe.n_features}
        assert scores == want
        assert max(scores, key=scores.get) == job


def _hubs(cold_rows=True):
    ref, port = RefHub(), Hub()
    for job in ("grep", "sort"):
        ref.publish(RefRepo(job, job, RW.generate_job_data(job).schema,
                            RefStore(RW.generate_job_data(job), seed=0)))
        d = PW.generate_job_data(job)
        port.publish(JobRepo(job, job, d.schema,
                             RuntimeDataStore(d, seed=0, device="cpu"),
                             predictor_kw={"device": "cpu"}))
    if cold_rows:
        ref.publish(RefRepo("grep-cold", "grep (cold twin)",
                            RW.cold_schema("grep"),
                            RefStore(RW.cold_probe("grep", 0), seed=0)))
        port.publish(JobRepo("grep-cold", "grep (cold twin)",
                             PW.cold_schema("grep"),
                             RuntimeDataStore(PW.cold_probe("grep", 0),
                                              seed=0, device="cpu")))
    return ref, port


@pytest.mark.parametrize("job,n_features,cold_rows", [
    ("grep-cold", None, True), ("never-seen", 3, False),
    ("never-seen", None, False), ("never-seen", 5, False),
    ("grep", None, True)])
def test_nearest_job_equals_the_reference(job, n_features, cold_rows):
    ref, port = _hubs(cold_rows)
    pol_r, pol_p = RT.TransferPolicy(), PT.TransferPolicy()
    want = ref.nearest_job(job, n_features, policy=pol_r)
    got = port.nearest_job(job, n_features, policy=pol_p)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.__dict__ == want.__dict__
    if job == "grep-cold":
        assert got.source == "grep"
        assert got.confidence == pytest.approx(got.similarity
                                               * pol_p.discount)
    if job == "never-seen" and n_features == 3:
        assert got.similarity == 0.0
        assert got.confidence == pytest.approx(pol_p.unknown_prior
                                               * pol_p.discount)


def test_lookup_caches_amortize_across_unchanged_store_versions():
    _, hub = _hubs()
    index = hub.transfer_index(PT.TransferPolicy())
    assert hub.transfer_index() is index
    index.nearest("grep-cold")
    builds = index.stats["signature_builds"]
    pairs = index.stats["pair_evals"]
    for _ in range(5):
        assert index.nearest("grep-cold").source == "grep"
    assert index.stats["signature_builds"] == builds
    assert index.stats["pair_evals"] == pairs
    # an accepted contribution moves one store's version: exactly that
    # job re-sketches and its pair recomputes
    extra = PW.generate_user_data("grep", user=9, seed=3)
    assert hub.get("grep").store.contribute(extra).accepted
    assert index.nearest("grep-cold").source == "grep"
    assert index.stats["signature_builds"] == builds + 1
    assert index.stats["pair_evals"] == pairs + 1
    # a different policy rebuilds the index
    assert hub.transfer_index(PT.TransferPolicy(min_rows=8)) is not index
