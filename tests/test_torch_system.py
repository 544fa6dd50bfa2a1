"""The port's slice as a whole against the JAX package: the paper's loop
(publish on a hub, fit one predictor per machine type, choose clusters for
a backlog of contexts, contribute a run back) on sort and grep, and a check
that the port runs that loop without loading JAX or the JAX package.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core.datastore import RuntimeDataStore as RefStore
from repro.core.features import RuntimeData as RefData
from repro.core.hub import Hub as RefHub
from repro.core.hub import JobRepo as RefRepo
from repro.core.service import ConfigurationService as RefService
from repro.workloads import spark_emul as RW
from repro_torch.core import (ConfigurationService, Hub, JobRepo,
                              RuntimeDataStore)
from repro_torch.core.features import RuntimeData
from repro_torch.core.predictor import C3OPredictor
from repro_torch.workloads import spark_emul as PW

JOBS = ("sort", "grep")
SCALEOUTS = (2, 3, 4, 6, 8, 12)
PRICES = {m.name: m.price for m in RW.MACHINES.values()}
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _hubs():
    ref, port = RefHub(), Hub()
    for job in JOBS:
        d = RW.generate_job_data(job)
        ref.publish(RefRepo(job, f"spark {job}", d.schema, RefStore(d)))
        p = PW.generate_job_data(job)
        port.publish(JobRepo(job, f"spark {job}", p.schema,
                             RuntimeDataStore(p, device="cpu"),
                             predictor_kw={"device": "cpu"}))
    return ref, port


@pytest.fixture(scope="module")
def hubs():
    return _hubs()


def _contexts(repo, n=64, seed=0):
    """Seeded contexts inside the job's data range, with mixed deadlines
    (a quarter NaN: no deadline)."""
    rng = np.random.default_rng(seed)
    ctx = repo.store.data.X[:, 1:]
    c = rng.uniform(ctx.min(0), ctx.max(0), (n, ctx.shape[1]))
    t = rng.uniform(0.5, 3.0, n) * float(np.median(repo.store.data.y))
    t[rng.random(n) < 0.25] = np.nan
    return c, t


def test_emulators_generate_the_same_data():
    for job in ("sort", "grep", "sgd", "kmeans", "pagerank"):
        a, b = RW.generate_job_data(job), PW.generate_job_data(job)
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.y, b.y)
        assert list(a.machines) == list(b.machines)


def test_same_selected_model_for_every_predictor(hubs):
    ref, port = hubs
    for job in JOBS:
        for m in ref.get(job).store.data.present_machines():
            want = ref.get(job).predictor_for(m)
            got = port.get(job).predictor_for(m)
            assert got.selected == want.selected, (job, m)


def _choices(svc, ctx, t_max):
    return [(c.machine_type, c.scale_out, c.zone, c.purchase_option)
            for c in svc.choose_cluster_batch(ctx, t_max)]


@pytest.mark.parametrize("job", JOBS)
@pytest.mark.parametrize("market", [False, True])
def test_choose_cluster_batch_same_choices(hubs, job, market):
    ref, port = hubs
    kw_r = {"market": RW.generate_price_book(seed=0)} if market else {}
    kw_p = {"market": PW.generate_price_book(seed=0)} if market else {}
    r = RefService.from_repo(ref.get(job), None, PRICES, SCALEOUTS, **kw_r)
    p = ConfigurationService.from_repo(port.get(job), None, PRICES,
                                       SCALEOUTS, **kw_p)
    ctx, t_max = _contexts(ref.get(job))
    assert _choices(p, ctx, t_max) == _choices(r, ctx, t_max)


@pytest.mark.parametrize("job", JOBS)
def test_costs_and_bounds_match(hubs, job):
    """Costs from the port's own fits; bounds (runtime + CV confidence
    margin) on the reference fits carried over, since LOO statistics of
    GBM fits can differ where a fold's fit meets R3."""
    ref, port = hubs
    r = RefService.from_repo(ref.get(job), None, PRICES, SCALEOUTS)
    p = ConfigurationService.from_repo(port.get(job), None, PRICES,
                                       SCALEOUTS)
    ctx, _ = _contexts(ref.get(job))
    names_r, t_r, bound_r, cost_r, _ = r.score_cluster_grid(ctx)
    names_p, t_p, _, cost_p, _ = p.score_cluster_grid(ctx)
    assert names_p == names_r
    np.testing.assert_allclose(cost_p, cost_r, rtol=1e-4)
    np.testing.assert_allclose(t_p, t_r, rtol=1e-4)
    carried = {m: C3OPredictor.from_reference_state(
        ref.get(job).predictor_for(m).export_state(),
        ref.get(job).store.data.machine_view(m).X, device="cpu")
        for m in names_r}
    for m in names_r:
        want = ref.get(job).predictor_for(m)
        assert (carried[m].mu, carried[m].sigma) == (want.mu, want.sigma)
    c = ConfigurationService(carried, PRICES, SCALEOUTS)
    _, _, bound_c, cost_c, _ = c.score_cluster_grid(ctx)
    np.testing.assert_allclose(bound_c, bound_r, rtol=1e-4)
    np.testing.assert_allclose(cost_c, cost_r, rtol=1e-5)


def test_model_errors_match(hubs):
    """A replay checkpoint: every pool model's holdout (MAPE, MAE) on one
    user's runs, plus the C3O predictor's."""
    ref, port = hubs
    want, sel_r = ref.get("grep").model_errors(
        "c5.xlarge", RW.generate_user_data("grep", 0), track_models=None)
    got, sel_p = port.get("grep").model_errors(
        "c5.xlarge", PW.generate_user_data("grep", 0), track_models=None)
    assert sel_p == sel_r and set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=0)


def test_trust_weighted_contributions_match():
    """The trust plane: an honest, a poisoned and another honest
    contribution judged by a reputation-keeping store on both sides."""
    from repro.core.trust import ReputationLedger as RefLedger
    from repro_torch.core.trust import ReputationLedger
    stores = (RefStore(RW.generate_job_data("grep"), trust=RefLedger()),
              RuntimeDataStore(PW.generate_job_data("grep"),
                               trust=ReputationLedger(), device="cpu"))
    out = []
    for store, W in zip(stores, (RW, PW)):
        reports = []
        for who, data in (("u1", W.generate_user_data("grep", 1)),
                          ("bad", W.adversarial_user_data("grep", 2, 0,
                                                          "noise")),
                          ("u3", W.generate_user_data("grep", 3))):
            r = store.contribute(data, contributor=who)
            reports.append((r.accepted, r.baseline_mape, r.candidate_mape))
        out.append((reports, [store.trust.reputation(c)
                              for c in ("u1", "bad", "u3")]))
    (ref_reports, ref_rep), (reports, rep) = out
    assert [r[0] for r in reports] == [r[0] for r in ref_reports]
    # reputations are functions of the judged MAPEs, held to the same 1e-4
    np.testing.assert_allclose(rep, ref_rep, rtol=1e-4)
    # the first two are judged at full row weights; the third under the
    # poisoner's reputation weight (0.748), whose float32 sums depend on
    # summation order, so its GBM fits meet R3 (ROADMAP.md §3: candidate
    # MAPE 0.069316 here against 0.069739 in the JAX package)
    np.testing.assert_allclose([r[1:] for r in reports[:2]],
                               [r[1:] for r in ref_reports[:2]], rtol=1e-4)


def test_quickstart_contribution_accepted_on_both_sides():
    """The quickstart's loop: choose for grep at (18 GB, 2%) under 420 s,
    check the emulator's truth, contribute the run back."""
    ref, port = _hubs()
    ctx = np.asarray([18.0, 0.02])
    out = []
    for hub, Data in ((ref, RefData), (port, RuntimeData)):
        repo = hub.search("grep")[0]
        conf = repo.configurator("m5.xlarge", PRICES, list(SCALEOUTS))
        choice = conf.choose_scaleout(ctx, t_max=420.0)
        assert choice.runtime_bound_s <= 420.0
        truth = RW.true_runtime("grep", "m5.xlarge", choice.scale_out,
                                (18.0, 0.02))
        assert truth <= 420.0 * 1.05
        new = Data(repo.schema, np.asarray(["m5.xlarge"]),
                   np.asarray([[choice.scale_out, 18.0, 0.02]]),
                   np.asarray([truth]))
        rep = repo.contribute(new, contributor="quickstart-user")
        assert rep.accepted, rep.reason
        out.append((choice.scale_out, rep.baseline_mape, rep.candidate_mape))
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[1][1:], out[0][1:], rtol=0, atol=1e-4)


PURITY = textwrap.dedent("""
    import sys
    import numpy as np
    from repro_torch.core import ConfigurationService, Hub, JobRepo
    from repro_torch.core import RuntimeDataStore
    from repro_torch.core.features import RuntimeData
    from repro_torch.kernels import gbm_predict
    from repro_torch.workloads import spark_emul as W
    hub = Hub()
    d = W.generate_job_data("grep")
    d = d.subset(d.machine_indices("m5.xlarge")[:30])
    hub.publish(JobRepo("grep", "spark grep", d.schema,
                        RuntimeDataStore(d, device="cpu"),
                        model_names=["ernest", "gbm"],
                        predictor_kw={"device": "cpu", "max_cv_folds": 8}))
    repo = hub.search("grep")[0]
    prices = {m.name: m.price for m in W.MACHINES.values()}
    svc = ConfigurationService.from_repo(repo, None, prices, (2, 4, 8))
    out = svc.choose_cluster_batch(np.asarray([[18.0, 0.02], [5.0, 0.1]]),
                                   np.asarray([420.0, np.nan]))
    assert len(out) == 2
    rep = repo.contribute(RuntimeData(
        repo.schema, np.asarray([out[0].machine_type]),
        np.asarray([[out[0].scale_out, 18.0, 0.02]]), np.asarray([300.0])))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print("LOADED", bad)
    assert not bad, bad
""")


def test_port_loads_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run([sys.executable, "-c", PURITY], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout


def _imported_roots(path):
    import ast
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_and_chip_smoke_import_no_jax_or_reference():
    root = os.path.join(os.path.dirname(__file__), "..")
    paths = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        paths += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(paths) > 20
    for p in paths:
        bad = _imported_roots(p) & {"jax", "jaxlib", "repro"}
        assert not bad, (p, bad)
