"""The port's batched K-means++ and clustering stage against
``repro.core.kmeans`` / ``repro.core.pipeline.cluster_clients``, with the
reference's draws replayed (``test_torch_draws``).

Tolerance: centroids and inertia 1e-4 (float32 sums in another order);
assignments exact. Clustering centroids are compared after aligning each
PCA axis's sign (torch and JAX eigensolvers may flip it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import pipeline as jpl
from repro_torch.core import kmeans as tkm
from repro_torch.core import pipeline as tpl

from test_torch_draws import kmeans_draws


def _blobs(seed, n=5, cap=40, d=6, k=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n, k, d)) * 4
    lab = rng.integers(0, k, size=(n, cap))
    x = centers[np.arange(n)[:, None], lab] + rng.normal(size=(n, cap, d))
    sizes = rng.integers(cap // 2, cap + 1, size=n)
    sizes[0] = cap
    return x.astype(np.float32), sizes


@pytest.mark.parametrize("k,iters", [(3, 5), (4, 3)])
def test_kmeans_batched_matches_reference(k, iters):
    x, sizes = _blobs(k)
    key = jax.random.PRNGKey(k)
    want = jkm.kmeans_batched(key, jnp.asarray(x), jnp.asarray(sizes), k,
                              iters)
    got = tkm.kmeans_batched(torch.as_tensor(x), torch.as_tensor(sizes), k,
                             kmeans_draws(key, sizes, k), iters)
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-4,
                               atol=1e-4)
    valid = np.arange(x.shape[1])[None] < sizes[:, None]
    np.testing.assert_array_equal(got.assignments.numpy()[valid],
                                  np.asarray(want.assignments)[valid])
    np.testing.assert_allclose(got.inertia.numpy(), np.asarray(want.inertia),
                               rtol=1e-4)


def test_lloyd_step_one_assignment_call_for_all_clients(monkeypatch):
    x, sizes = _blobs(9)
    calls = []
    real = tkm.kops.kmeans_assign
    monkeypatch.setattr(tkm.kops, "kmeans_assign",
                        lambda a, c: calls.append(a.shape) or real(a, c))
    tkm.kmeans_batched(torch.as_tensor(x), torch.as_tensor(sizes), 3,
                       kmeans_draws(jax.random.PRNGKey(0), sizes, 3), 4)
    assert calls == [x.shape] * 4


def test_cluster_clients_matches_reference():
    x, sizes = _blobs(2, n=4, cap=30, d=16)
    images = [x[i, :s].reshape(s, 4, 4, 1) for i, s in enumerate(sizes)]
    key = jax.random.PRNGKey(7)
    jcfg = jpl.PipelineConfig(n_pca=4, n_clusters=3, kmeans_iters=5)
    tcfg = tpl.PipelineConfig(n_pca=4, n_clusters=3, kmeans_iters=5)
    jp, jc, ja = jpl.cluster_clients(key, images, jcfg)
    tp, tc, ta = tpl.cluster_clients(images, tcfg,
                                     kmeans_draws(key, sizes, 3),
                                     device="cpu")
    sign = np.sign((tp.components.numpy()
                    * np.asarray(jp.components)).sum(0))
    np.testing.assert_allclose(tc.numpy() * sign, np.asarray(jc), atol=1e-4)
    valid = np.arange(30)[None] < sizes[:, None]
    np.testing.assert_array_equal(ta.numpy()[valid], np.asarray(ja)[valid])


def test_draw_kmeans_stays_in_each_prefix():
    g = torch.Generator().manual_seed(0)
    d = tkm.draw_kmeans(g, torch.tensor([1, 5, 40]), 3)
    assert (d.first < torch.tensor([1, 5, 40])).all() and d.u.shape == (3, 2)
