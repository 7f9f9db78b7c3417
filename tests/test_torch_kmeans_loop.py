"""The unbatched K-means forms, the elbow and the clustering host loop
against ``repro.core.kmeans`` / ``repro.core.pipeline``, and the
size-free k-means and minibatch draws.

K-means on the same k-means++ picks (replayed from the reference's keys):
assignments exactly, centroids and inertia within 1e-5 relative. The
clustering loop's PCA basis is compared column by column after aligning
each column's sign (``eigh`` may return either), its centroids in the
aligned basis within 1e-4 absolute, its assignments exactly: tolerance and
sign alignment, never bitwise equality (the reference's own stacked and
loop bases are not bit-equal on the CPU, ROADMAP Queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkm
from repro.core import pca as jpca
from repro.core import pipeline as jpl
from repro_torch.core import kmeans as tkm
from repro_torch.core import pca as tpca
from repro_torch.core import pipeline as tpl
from repro_torch.dynamics import SeededDraws
from repro_torch.fl.trainer import FLConfig, draw_batch_indices

from test_torch_draws import kmeans_draws, t, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@functools.partial(jax.jit, static_argnums=(2,))
def _picks(key, size, k: int):
    """``kmeans_plus_plus_init(_masked)(key, ...)``'s picks: the first index
    and one uniform per ``jax.random.choice``."""
    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, size)
    us = []
    for _ in range(1, k):
        key, kc = jax.random.split(key)
        us.append(jax.random.uniform(kc, ()))
    return first, jnp.stack(us) if us else jnp.zeros((0,))


def single_draws(key, size, k) -> tkm.KMeansDraws:
    first, u = _picks(key, size, k)
    return tkm.KMeansDraws(t(first, torch.int64), t(u))


def _data(n=60, d=5, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, d)) * 4
    return (centers[rng.integers(0, 4, n)]
            + rng.normal(size=(n, d))).astype(np.float32)


def _assert_fit(got, want):
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(want.assignments))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_kmeans_matches_reference(k):
    x = _data()
    key = jax.random.PRNGKey(k)
    want = jax.jit(jkm.kmeans, static_argnums=(2, 3))(key, x, k, 10)
    got = tkm.kmeans(torch.as_tensor(x), k, single_draws(key, len(x), k), 10)
    _assert_fit(got, want)


def test_kmeans_masked_matches_reference():
    x = np.concatenate([_data(40), np.zeros((12, 5), np.float32)])
    key = jax.random.PRNGKey(9)
    want = jax.jit(jkm.kmeans_masked, static_argnums=(3, 4))(
        key, x, 40, 3, 8)
    got = tkm.kmeans_masked(torch.as_tensor(x), torch.tensor(40), 3,
                            single_draws(key, 40, 3), 8)
    np.testing.assert_array_equal(got.assignments[:40].numpy(),
                                  np.asarray(want.assignments)[:40])
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-5)


def test_wcss_elbow_matches_reference():
    x = _data(80, 4, seed=3)
    key = jax.random.PRNGKey(1)
    ks = [1, 2, 3, 4, 5]
    want = jkm.wcss_elbow(key, jnp.asarray(x), ks)
    got = tkm.wcss_elbow(torch.as_tensor(x), ks,
                         lambda k: single_draws(key, len(x), k))
    assert got == want
    assert tkm.wcss_elbow(torch.as_tensor(x), [2, 3],
                          lambda k: single_draws(key, len(x), k)) == \
        jkm.wcss_elbow(key, jnp.asarray(x), [2, 3])


def test_client_moments_match_reference():
    x = _data(30)
    mask = (np.arange(30) < 21).astype(np.float32)
    want = jpca.client_moments(jnp.asarray(x), jnp.asarray(mask))
    got = tpca.client_moments(torch.as_tensor(x), torch.as_tensor(mask))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def clustered():
    """Ragged clients of 6 x 6 x 1 images from 4 prototypes, projected on
    the 3 leading components (well apart, so each is well defined); the
    JAX loop and the port's loop and batched forms on the same picks."""
    rng = np.random.default_rng(2)
    protos = rng.uniform(size=(4, 6, 6, 1)).astype(np.float32)
    xs = []
    for i, size in enumerate([30, 22, 27, 18]):
        lab = rng.integers(0, 4, size)
        xs.append((protos[lab] + 0.05 * rng.normal(size=(size, 6, 6, 1)))
                  .astype(np.float32))
    jcfg = jpl.PipelineConfig(n_pca=3, n_clusters=3, kmeans_iters=6)
    tcfg = tpl.PipelineConfig(n_pca=3, n_clusters=3, kmeans_iters=6)
    key = jax.random.PRNGKey(4)
    want = jpl.cluster_clients_loop(key, xs, jcfg)
    draws = kmeans_draws(key, [len(x) for x in xs], 3)
    got = tpl.cluster_clients_loop(xs, tcfg, draws, device="cpu")
    batched = tpl.cluster_clients(xs, tcfg, draws, device="cpu")
    return xs, want, got, batched


def test_cluster_clients_loop_matches_reference(clustered):
    xs, (jp, jc, ja), (tp, tc, ta), _ = clustered
    np.testing.assert_allclose(tp.mean.numpy(), np.asarray(jp.mean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tp.explained_var.numpy(),
                               np.asarray(jp.explained_var), rtol=1e-4,
                               atol=1e-6)
    comp_t, comp_j = tp.components.numpy(), np.asarray(jp.components)
    signs = np.sign(np.sum(comp_t * comp_j, axis=0))
    assert (signs != 0).all()
    np.testing.assert_allclose(comp_t * signs, comp_j, atol=1e-4)
    np.testing.assert_allclose(tc.numpy() * signs, np.asarray(jc), atol=1e-4)
    for i, x in enumerate(xs):
        np.testing.assert_array_equal(ta[i, :len(x)].numpy(),
                                      np.asarray(ja)[i, :len(x)])


def test_cluster_clients_loop_matches_the_batched_form(clustered):
    xs, _, (tp, tc, ta), (bp, bc, ba) = clustered
    np.testing.assert_allclose(tp.components.abs().numpy(),
                               bp.components.abs().numpy(), atol=1e-5)
    signs = np.sign(np.sum(tp.components.numpy() * bp.components.numpy(),
                           axis=0))
    np.testing.assert_allclose(tc.numpy() * signs, bc.numpy(), atol=1e-4)
    for i, x in enumerate(xs):
        assert torch.equal(ta[i, :len(x)], ba[i, :len(x)].to(ta.dtype))


# ---------------------------------------------------------------------------
# size-free draws: seeded runs unchanged
# ---------------------------------------------------------------------------

def _old_draw_kmeans(generator, sizes, k):
    """``draw_kmeans`` as it was before it drew size-free uniforms."""
    dev = generator.device
    sizes = torch.as_tensor(sizes, device=dev)
    n = sizes.shape[0]
    first = torch.floor(torch.rand(n, generator=generator, device=dev)
                        * sizes).long().clamp_max(sizes - 1)
    return tkm.KMeansDraws(first, torch.rand((n, k - 1), generator=generator,
                                             device=dev))


def test_draw_kmeans_unchanged_for_a_seed():
    sizes = [1998, 7, 1, 40, 2958]
    for seed in range(3):
        old = _old_draw_kmeans(torch.Generator().manual_seed(seed), sizes, 3)
        new = tkm.draw_kmeans(torch.Generator().manual_seed(seed), sizes, 3)
        assert torch.equal(old.first, new.first)
        assert torch.equal(old.u, new.u)
    draws = SeededDraws(7, "cpu")
    sz = torch.tensor(sizes)
    old = _old_draw_kmeans(torch.Generator().manual_seed(
        draws._seed("cluster", 2)), sz, 3)
    for got in (draws.cluster(2, sz, 3), draws.cluster(2, len(sizes), 3)(sz)):
        assert torch.equal(got.first, old.first)
        assert torch.equal(got.u, old.u)


def test_fl_batch_draws_unchanged_for_a_seed():
    cfg = FLConfig(tau_a=4, batch_size=6)
    draws = SeededDraws(3, "cpu")
    sz = torch.tensor([5, 90, 1, 33])
    # the source's minibatch draws as they were: draw_batch_indices on the
    # site's generator, one round
    gen = torch.Generator().manual_seed(draws._seed("fl_batch", 5))
    u = torch.rand((1, cfg.tau_a, 4, cfg.batch_size), generator=gen)
    old = torch.minimum(torch.floor(u * sz[:, None]).long(),
                        (sz - 1)[:, None])[0]
    assert torch.equal(draws.fl_batch(5, sz, cfg), old)
    assert torch.equal(draws.fl_batch(5, 4, cfg)(sz), old)
    again = draw_batch_indices(torch.Generator().manual_seed(
        draws._seed("fl_batch", 5)), [5, 90, 1, 33], cfg, 1)[0]
    assert torch.equal(again, old)
