"""Tests of the port that need a CUDA card: the hand-written GBM-ensemble
kernel against its plain PyTorch version, the engine's routing to it, and a
predictor fitted on the card against the same fit on the CPU.  They skip
without a card.  This file imports no JAX, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.models.api import ModelSpec
from repro_torch.core.models.gbm import GBM_SPEC
from repro_torch.core.predictor import C3OPredictor
from repro_torch.kernels import gbm_predict as K
from repro_torch.workloads import spark_emul as W

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def _ensemble(seed, n, d, T, depth, device):
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    X = rng.uniform(0, 10, (n, d)).astype(np.float32)
    m = rng.random(X.shape)
    X[m < 0.05] = np.inf
    X[(m >= 0.05) & (m < 0.1)] = -np.inf
    X[(m >= 0.1) & (m < 0.15)] = np.nan
    feat = rng.integers(0, d, (T, n_int)).astype(np.int32)
    thr = rng.uniform(0, 10, (T, n_int)).astype(np.float32)
    thr[rng.random((T, n_int)) < 0.2] = np.inf
    leaf = rng.normal(0, 0.1, (T, n_int + 1)).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (X, feat, thr, leaf)]


@pytest.mark.parametrize("n,d,T,depth", [
    (1, 1, 1, 1), (1, 3, 200, 3), (7, 2, 20, 2), (257, 4, 200, 3),
    (300, 16, 30, 4), (513, 1, 10, 1), (24576, 4, 200, 3)])
@pytest.mark.parametrize("y_scale", [0.0, 250.0])
def test_kernel_matches_plain(cuda_device, n, d, T, depth, y_scale):
    t = _ensemble(n + d, n, d, T, depth, cuda_device)
    before = K.LAUNCHES
    got = K.gbm_predict(*t, 0.3, y_scale)
    torch.cuda.synchronize()
    assert K.LAUNCHES == before + 1
    want = K.gbm_predict_plain(*t, 0.3, y_scale)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    X, feat, thr, leaf = _ensemble(0, 8, 3, 4, 2, cuda_device)
    with pytest.raises(ValueError):
        K.gbm_predict(torch.zeros(8, K.MAX_FEATURES + 1, device=cuda_device),
                      feat, thr, leaf, 0.0, 1.0)
    with pytest.raises(TypeError):
        K.gbm_predict(X, feat.long(), thr, leaf, 0.0, 1.0)
    with pytest.raises(ValueError):
        K.gbm_predict(X, feat, thr.cpu(), leaf, 0.0, 1.0)


def test_gbm_routes_through_kernel_on_spec_identity(cuda_device):
    v = W.generate_job_data("grep").machine_view("c5.xlarge")
    aux = GBM_SPEC.make_aux(v.X, cuda_device)
    params = engine.fit(GBM_SPEC, v.X, v.y, np.ones(len(v.y)), aux,
                        cuda_device)
    before = K.LAUNCHES
    got = engine.predict(GBM_SPEC, params, v.X, aux, cuda_device)
    assert K.LAUNCHES == before + 1
    clone = ModelSpec("gbm", GBM_SPEC.make_aux, GBM_SPEC.fit,
                      GBM_SPEC.predict)
    same = engine.predict(clone, params, v.X, aux, cuda_device)
    assert K.LAUNCHES == before + 1          # a look-alike is not routed
    np.testing.assert_allclose(got.cpu().numpy(), same.cpu().numpy(),
                               rtol=1e-6)


def test_cpu_fit_carried_to_card_predicts_the_same(cuda_device):
    v = W.generate_job_data("grep").machine_view("r5.xlarge")
    cpu = C3OPredictor(device="cpu").fit(v.X, v.y)
    card = C3OPredictor.from_state(cpu.export_state(), v.X, device="cuda")
    np.testing.assert_allclose(card.predict(v.X), cpu.predict(v.X),
                               rtol=1e-5)
