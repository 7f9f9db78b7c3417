"""The port's federated PCA against ``repro.core.pca``.

``torch.linalg.eigh`` may flip an eigenvector's sign against
``jnp.linalg.eigh``, so components are compared after sign alignment and as
the projector U U^T. Tolerance: 1e-4 absolute (float32 eigensolvers on a
64 x 64 covariance with well separated leading eigenvalues)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pca as jpca
from repro_torch.core import pca as tpca
from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _stack(seed=0, n=4, cap=30, d=64):
    rng = np.random.default_rng(seed)
    scales = np.linspace(3.0, 0.1, d)          # separated spectrum
    x = (rng.normal(size=(n, cap, d)) * scales).astype(np.float32)
    sizes = np.array([30, 12, 25, 20])
    mask = (np.arange(cap)[None] < sizes[:, None]).astype(np.float32)
    return x, mask


def test_federated_pca_matches_reference():
    x, mask = _stack()
    want = jpca.fit_pca_federated_stacked(jnp.asarray(x), jnp.asarray(mask),
                                          8)
    got = tpca.fit_pca_federated_stacked(torch.as_tensor(x),
                                         torch.as_tensor(mask), 8)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               atol=1e-5)
    np.testing.assert_allclose(got.explained_var.numpy(),
                               np.asarray(want.explained_var), rtol=1e-4)
    u, v = got.components.numpy(), np.asarray(want.components)
    np.testing.assert_allclose(u @ u.T, v @ v.T, atol=1e-4)
    sign = np.sign((u * v).sum(0))
    np.testing.assert_allclose(u * sign, v, atol=1e-4)


def test_transform_distances_are_sign_invariant():
    x, mask = _stack(1)
    want = jpca.fit_pca_federated_stacked(jnp.asarray(x), jnp.asarray(mask),
                                          4)
    got = tpca.fit_pca_federated_stacked(torch.as_tensor(x),
                                         torch.as_tensor(mask), 4)
    zj = np.asarray(want.transform(jnp.asarray(x[0])))
    zt = got.transform(torch.as_tensor(x[0])).numpy()
    dj = ((zj[:, None] - zj[None]) ** 2).sum(-1)
    dt = ((zt[:, None] - zt[None]) ** 2).sum(-1)
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-4)
