"""The reference's list forms on the port, against JAX on the same inputs:
``pca.fit_pca`` and ``fit_pca_federated`` (components sign-aligned and as
the projector, 1e-4 absolute as in ``test_torch_pca``; the list fit also
equals the stacked fit of the same clients), ``dissimilarity.lambda_pair``,
``stack_trust``, ``lambda_matrix`` on the ragged lists and
``lambda_matrix_stacked`` (exact: int32 counts over distances with a margin
of 1e-3 to beta), the list form of ``median_heuristic_beta`` (1e-6), and
``batching.stack_clients`` (exact)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batching as jbatch
from repro.core import dissimilarity as jds
from repro.core import pca as jpca
from repro_torch.core import batching as tbatch
from repro_torch.core import dissimilarity as tds
from repro_torch.core import pca as tpca

from test_torch_draws import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _clients(seed=0, sizes=(30, 12, 25, 20), d=64):
    rng = np.random.default_rng(seed)
    scales = np.linspace(3.0, 0.1, d)
    return [(rng.normal(size=(s, d)) * scales).astype(np.float32)
            for s in sizes]


def _assert_pca_close(got, want):
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               atol=1e-5)
    np.testing.assert_allclose(got.explained_var.numpy(),
                               np.asarray(want.explained_var), rtol=1e-4)
    u, v = got.components.numpy(), np.asarray(want.components)
    np.testing.assert_allclose(u @ u.T, v @ v.T, atol=1e-4)
    sign = np.sign((u * v).sum(0))
    np.testing.assert_allclose(u * sign, v, atol=1e-4)


def test_fit_pca_matches_reference():
    x = np.concatenate(_clients())
    _assert_pca_close(tpca.fit_pca(torch.as_tensor(x), 8),
                      jpca.fit_pca(jnp.asarray(x), 8))
    # with every component kept, inverse undoes transform
    full = tpca.fit_pca(torch.as_tensor(x), x.shape[1])
    np.testing.assert_allclose(full.inverse(full.transform(
        torch.as_tensor(x[:5]))).numpy(), x[:5], atol=1e-4)


def test_fit_pca_federated_matches_reference_and_stacked():
    xs = _clients(1)
    got = tpca.fit_pca_federated([torch.as_tensor(x) for x in xs], 8)
    _assert_pca_close(got, jpca.fit_pca_federated(
        [jnp.asarray(x) for x in xs], 8))
    cd = tbatch.client_data_from_lists(xs)
    stacked = tpca.fit_pca_federated_stacked(cd.data, cd.mask(), 8)
    _assert_pca_close(got, stacked)


def _cents_world(seed=2, n=5, k=3, d=4, beta=1.5):
    """Centroids whose pair distances all keep 1e-3 from beta."""
    rng = np.random.default_rng(seed)
    while True:
        cents = rng.normal(size=(n, k, d)).astype(np.float32)
        dd = np.linalg.norm(cents[:, None, :, None] - cents[None, :, None],
                            axis=-1)
        if np.min(np.abs(dd - beta)) > 1e-3:
            break
    trust = [(rng.random((n, k)) < 0.7).astype(np.int8) for _ in range(n)]
    return cents, trust, beta


def test_lambda_pair_and_list_forms_match_reference():
    cents, trust, beta = _cents_world()
    n = cents.shape[0]
    for i in range(n):
        for j in range(n):
            got = tds.lambda_pair(torch.as_tensor(cents[i]),
                                  torch.as_tensor(cents[j]),
                                  torch.as_tensor(trust[j][i]), beta)
            want = jds.lambda_pair(jnp.asarray(cents[i]),
                                   jnp.asarray(cents[j]),
                                   jnp.asarray(trust[j][i]), beta)
            assert got.dtype == torch.int32 and int(got) == int(want)
    want = np.asarray(jds.lambda_matrix([jnp.asarray(c) for c in cents],
                                        [jnp.asarray(t) for t in trust],
                                        beta))
    got_list = tds.lambda_matrix([torch.as_tensor(c) for c in cents],
                                 [torch.as_tensor(t) for t in trust], beta)
    np.testing.assert_array_equal(got_list.numpy(), want)
    got_stacked = tds.lambda_matrix_stacked(
        torch.as_tensor(cents), [torch.as_tensor(t) for t in trust], beta)
    np.testing.assert_array_equal(got_stacked.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jds.lambda_matrix_stacked(jnp.asarray(cents),
                                             [jnp.asarray(t) for t in trust],
                                             beta)), want)
    got_beta = tds.median_heuristic_beta([torch.as_tensor(c) for c in cents],
                                         0.8)
    want_beta = jds.median_heuristic_beta([jnp.asarray(c) for c in cents],
                                          0.8)
    np.testing.assert_allclose(float(got_beta), float(want_beta), rtol=1e-6)


def test_stack_trust_matches_reference():
    _, trust, _ = _cents_world(3)
    got = tds.stack_trust([torch.as_tensor(t) for t in trust])
    want = jds.stack_trust([jnp.asarray(t) for t in trust])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tds.stack_trust(got) is got
    ragged = [torch.ones((3, 2), dtype=torch.int8),
              torch.ones((3, 3), dtype=torch.int8)]
    with pytest.raises(ValueError, match="uniform cluster count"):
        tds.stack_trust(ragged)
    with pytest.raises(ValueError, match="uniform cluster count"):
        jds.stack_trust([jnp.asarray(t.numpy()) for t in ragged])


def test_stack_clients_matches_reference():
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(s, 3, 2)).astype(np.float32) for s in (5, 2, 7)]
    data, sizes = tbatch.stack_clients(xs)
    jdata, jsizes = jbatch.stack_clients([jnp.asarray(x) for x in xs])
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(jsizes))
    mask = tbatch.valid_mask(sizes, data.shape[1])
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jbatch.valid_mask(jsizes, jdata.shape[1])))
