"""The port's own replay of the golden config (``tests/test_eval_replay.py``'s
MINI_CFG: grep and kmeans, 2 users, 3 contributions each, seed 0) on the
CPU, held to ``tests/goldens/replay_mini.json`` (the JAX package's final
MAPE per job and model, 6 significant digits) at the port's per-model
tolerances, not the reference test's rtol 0.05: ernest and linreg 1e-5
relative; gbm, ogb and bom 2e-3; c3o 2e-3 where a final checkpoint
selected a tree model, else 1e-5.

The replay runs job by job (each job's records depend on that job
alone), so each job is its own case."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.eval import replay as R

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "replay_mini.json")
MINI = dict(n_users=2, seed=0, chunks_per_user=3)
EXACT_REL = 1e-5
TREE_REL = 2e-3
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


def golden_tolerance(model: str, selected_counts) -> float:
    if model in TREES or (model == "c3o"
                          and any(m in TREES for m in selected_counts)):
        return TREE_REL
    return EXACT_REL


@pytest.mark.parametrize("job", ["grep", "kmeans"])
def test_port_replay_meets_the_golden(job):
    with open(GOLDEN_PATH) as f:
        expected = json.load(f)[job]
    res = R.run_replay(R.ReplayConfig(jobs=(job,), device="cpu", **MINI))
    s = res.summary[job]
    assert set(s["final_mape"]) == set(expected)
    for model, mape in expected.items():
        tol = golden_tolerance(model, s["selected_counts"])
        np.testing.assert_allclose(s["final_mape"][model], mape, rtol=tol,
                                   atol=0, err_msg=f"{job}/{model}")
