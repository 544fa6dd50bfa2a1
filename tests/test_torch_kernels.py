"""The port's GBM-ensemble kernel: its plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and oracle, and the wrapper's checks.
The CUDA kernel itself is held against its plain version on the card by
``tests/test_torch_gpu.py``.

Inputs are made from a seed with numpy and handed to both frameworks.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import engine as ref_engine
from repro.kernels.gbm_predict import gbm_predict as pallas_gbm
from repro.kernels.ref import gbm_predict_ref
from repro_torch.core.models.gbm import GBMParams, gbm_predict as model_predict
from repro_torch.kernels import gbm_predict as K

RTOL = ATOL = 1e-5


def _ensemble(seed, n, d, T, depth, inf_frac=0.0):
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    X = rng.uniform(0, 10, (n, d)).astype(np.float32)
    feat = rng.integers(0, d, (T, n_int)).astype(np.int32)
    thr = rng.uniform(0, 10, (T, n_int)).astype(np.float32)
    thr[rng.random((T, n_int)) < inf_frac] = np.inf     # unsplittable nodes
    leaf = rng.normal(0, 0.1, (T, n_int + 1)).astype(np.float32)
    return X, feat, thr, leaf, np.float32(rng.normal(4.0, 1.0))


def _plain(X, feat, thr, leaf, f0, y_scale=1.0):
    return K.gbm_predict_plain(torch.as_tensor(X), torch.as_tensor(feat),
                               torch.as_tensor(thr), torch.as_tensor(leaf),
                               float(f0), y_scale).numpy()


SHAPES = [(1, 1, 1, 1), (1, 3, 200, 3), (7, 2, 20, 2), (255, 3, 200, 3),
          (257, 4, 200, 3), (300, 16, 30, 4), (513, 1, 10, 1)]


@pytest.mark.parametrize("n,d,T,depth", SHAPES)
def test_plain_matches_pallas_interpret(n, d, T, depth):
    X, feat, thr, leaf, f0 = _ensemble(n * 7 + d, n, d, T, depth)
    want = pallas_gbm(jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr),
                      jnp.asarray(leaf), f0, 1.0, interpret=True)
    np.testing.assert_allclose(_plain(X, feat, thr, leaf, f0),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("y_scale", [0.0, 250.0])
def test_plain_epilogue_matches_engine_kernel_path(y_scale):
    """The fused epilogue: log target (y_scale 0) and plain scaling, held
    against the JAX engine's jitted Pallas path."""
    X, feat, thr, leaf, f0 = _ensemble(11, 300, 3, 200, 3)
    f0 = np.float32(0.3)        # keeps exp() of the raw sum in range
    want = ref_engine._gbm_kernel_executable(True)(
        jnp.asarray(X), jnp.asarray(feat), jnp.asarray(thr),
        jnp.asarray(leaf), jnp.asarray(f0), jnp.asarray(y_scale))
    np.testing.assert_allclose(_plain(X, feat, thr, leaf, f0, y_scale),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,d,T,depth", [(1, 2, 5, 2), (97, 3, 40, 3),
                                         (260, 5, 20, 4)])
def test_plain_matches_oracle_on_nonfinite_inputs(n, d, T, depth):
    """R2: thr = inf nodes stay unclamped, and +-inf / NaN features route
    as in ``ref.gbm_predict_ref`` (NaN and +inf go left at thr = inf)."""
    X, feat, thr, leaf, f0 = _ensemble(n + T, n, d, T, depth, inf_frac=0.3)
    rng = np.random.default_rng(n)
    mask = rng.random(X.shape)
    X[mask < 0.1] = np.inf
    X[(mask >= 0.1) & (mask < 0.2)] = -np.inf
    X[(mask >= 0.2) & (mask < 0.3)] = np.nan
    want = gbm_predict_ref(jnp.asarray(X), jnp.asarray(feat),
                           jnp.asarray(thr), jnp.asarray(leaf), f0)
    np.testing.assert_allclose(_plain(X, feat, thr, leaf, f0),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def test_plus_inf_feature_goes_left_at_unsplittable_node():
    """R2's reproducer: a depth-1 tree with thr = inf and x = +inf routes
    left (-1.0), where the TPU kernel's clamp to 1e30 routes it right."""
    X = np.asarray([[np.inf], [np.nan], [5.0]], np.float32)
    feat = np.zeros((1, 1), np.int32)
    thr = np.full((1, 1), np.inf, np.float32)
    leaf = np.asarray([[-1.0, 1.0]], np.float32)
    oracle = np.asarray(gbm_predict_ref(jnp.asarray(X), jnp.asarray(feat),
                                        jnp.asarray(thr), jnp.asarray(leaf),
                                        0.0))
    got = _plain(X, feat, thr, leaf, 0.0)
    np.testing.assert_array_equal(got, [-1.0, -1.0, -1.0])
    np.testing.assert_array_equal(got, oracle)


def test_wrapper_on_cpu_is_plain_and_counts_nothing():
    X, feat, thr, leaf, f0 = _ensemble(3, 64, 3, 50, 3)
    before = K.LAUNCHES
    t = [torch.as_tensor(a) for a in (X, feat, thr, leaf)]
    got = K.gbm_predict(*t, torch.tensor(f0), torch.tensor(0.0))
    np.testing.assert_array_equal(got.numpy(),
                                  _plain(X, feat, thr, leaf, f0, 0.0))
    assert K.LAUNCHES == before


def test_model_predict_matches_plain_version():
    """The fold-batched model predict (used inside fits and CV) and the
    kernel's plain version compute the same function."""
    X, feat, thr, leaf, f0 = _ensemble(5, 100, 3, 200, 3, inf_frac=0.2)
    p = GBMParams(torch.tensor([f0]), torch.as_tensor(feat)[None],
                  torch.as_tensor(thr)[None], torch.as_tensor(leaf)[None],
                  torch.tensor([0.0]))
    got = model_predict(p, torch.as_tensor(X))[0].numpy()
    np.testing.assert_array_equal(got, _plain(X, feat, thr, leaf, f0, 0.0))


@pytest.mark.parametrize("bad", ["d", "dtype", "contig", "tables", "depth"])
def test_wrapper_checks_what_the_kernel_does_not_take(bad):
    X, feat, thr, leaf, _ = _ensemble(9, 8, 3, 4, 2)
    X, feat, thr, leaf = (torch.as_tensor(a) for a in (X, feat, thr, leaf))
    if bad == "d":
        X = torch.zeros(8, K.MAX_FEATURES + 1)
    elif bad == "dtype":
        feat = feat.long()
    elif bad == "contig":
        X = torch.zeros(3, 8).T
    elif bad == "tables":
        leaf = leaf[:, :2].contiguous()
    else:
        n_int = 2 ** (K.MAX_DEPTH + 1) - 1
        feat = torch.zeros(4, n_int, dtype=torch.int32)
        thr = torch.zeros(4, n_int)
        leaf = torch.zeros(4, n_int + 1)
    with pytest.raises((ValueError, TypeError)):
        K._check(X, feat, thr, leaf)
