"""Replays the reference's ``jax.random`` key splits to produce the explicit
draws the port takes, and checks that the replay is faithful: JAX's own
functions fed the replayed draws' keys give what the port gives with the
draws. The other ``test_torch_*`` files import these helpers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import channel as jch
from repro.core import kmeans as jkm
from repro.models import autoencoder as jae
from repro_torch import convert
from repro_torch.core import exchange as tex
from repro_torch.core import kmeans as tkm
from repro_torch.core import pipeline as tpl
from repro_torch.core import qlearning as tql


def t(a, dtype=None):
    """numpy/JAX array -> CPU tensor (a copy)."""
    out = torch.as_tensor(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def kmeans_draws(key, sizes, k: int) -> tkm.KMeansDraws:
    """The k-means++ picks of ``kmeans_batched(key, ...)``: per client,
    ``randint(k0, (), 0, size)`` and one uniform per ``jax.random.choice``."""
    sizes = jnp.asarray(np.asarray(sizes), jnp.int32)

    def one(kk, size):
        k0, kk = jax.random.split(kk)
        first = jax.random.randint(k0, (), 0, size)
        us = []
        for _ in range(1, k):
            kk, kc = jax.random.split(kk)
            us.append(jax.random.uniform(kc, ()))
        return first, jnp.stack(us) if us else jnp.zeros((0,))
    first, u = jax.jit(jax.vmap(one))(jax.random.split(key, sizes.shape[0]),
                                      sizes)
    return tkm.KMeansDraws(t(first, torch.int64), t(u))


def trust_uniforms(key, n: int, k: int):
    """The uniforms of ``make_trust(key, n, k)``: one (n, k) draw per
    transmitter key."""
    return t(jax.jit(jax.vmap(lambda kk: jax.random.uniform(kk, (n, k))))(
        jax.random.split(key, n)))


def rl_draws(key, n: int, n_ep: int) -> tql.RLDraws:
    def one(kk):
        ku, ks = jax.random.split(kk)
        return (jax.random.uniform(ku, (n, n)),
                jax.random.gumbel(ks, (n, n)))
    u, g = jax.jit(jax.vmap(one))(jax.random.split(key, n_ep))
    return tql.RLDraws(t(u), t(g))


def exchange_draws(key, n: int, ae_cfg) -> tex.ExchangeDraws:
    k_pre, k_sel, k_ch = jax.random.split(key, 3)
    init = jax.jit(jax.vmap(lambda kk: jae.init_ae(kk, ae_cfg)))(
        jax.random.split(k_pre, n))
    seed = int(jax.random.randint(k_sel, (), 0, 2**31 - 1))
    return tex.ExchangeDraws(convert.ae_params(jax.device_get(init)), seed,
                             t(jax.random.uniform(k_ch, (n,))))


def pipeline_draws(key, cfg, ae_cfg, sizes, sizes_after) -> tpl.PipelineDraws:
    """Every draw of the reference's ``run_pipeline(key, ...)``."""
    k_cl, k_tr, k_ch, k_rl, k_ex = jax.random.split(key, 5)
    n = len(sizes)
    kp, kf = jax.random.split(k_ch)
    rl = None if cfg.rl.policy == "ucb" else \
        rl_draws(k_rl, n, cfg.rl.n_episodes)
    return tpl.PipelineDraws(
        cluster=kmeans_draws(k_cl, sizes, cfg.n_clusters),
        cluster_after=kmeans_draws(k_cl, sizes_after, cfg.n_clusters),
        trust_u=trust_uniforms(k_tr, n, cfg.n_clusters),
        positions=t(jax.jit(jch.make_positions, static_argnums=(1, 2))(
            kp, n, cfg.channel)),
        fading=t(jax.jit(jch.init_fading, static_argnums=1)(kf, n)), rl=rl,
        exchange=exchange_draws(k_ex, n, ae_cfg))


def batch_indices(key, sizes, cfg) -> torch.Tensor:
    """(n_rounds, tau_a, N, B) minibatch indices of ``fl_train(key, ...)``."""
    sizes = jnp.asarray(np.asarray(sizes), jnp.int32)
    n_rounds = cfg.total_iters // cfg.tau_a
    keys = jax.random.split(jax.random.fold_in(key, 1), n_rounds)

    def it(kt):
        return jax.vmap(lambda kk, s: jax.random.randint(
            kk, (cfg.batch_size,), 0, s))(
            jax.random.split(kt, sizes.shape[0]), sizes)
    return t(jax.jit(jax.vmap(lambda kr: jax.vmap(it)(
        jax.random.split(kr, cfg.tau_a))))(keys), torch.int64)


# ---------------------------------------------------------------------------
# the replay is faithful
# ---------------------------------------------------------------------------

def test_kmeans_draws_reproduce_reference_seeding():
    """Replayed picks seed the same centroids as the reference's
    ``kmeans_plus_plus_init_masked`` under its own keys."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 17, 4)).astype(np.float32)
    sizes = np.array([17, 9, 12])
    key = jax.random.PRNGKey(3)
    want = jax.jit(jax.vmap(lambda kk, xx, ss: jkm.kmeans_plus_plus_init_masked(
        kk, xx, ss, 4)))(jax.random.split(key, 3), jnp.asarray(x),
                        jnp.asarray(sizes))
    got = tkm.kmeans_plus_plus_init_batched(
        t(x), t(sizes), 4, kmeans_draws(key, sizes, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_indices_in_range_and_seeded():
    from repro.fl.trainer import FLConfig
    cfg = FLConfig(total_iters=20, tau_a=10, batch_size=5)
    idx = batch_indices(jax.random.PRNGKey(0), [4, 7, 9], cfg)
    assert idx.shape == (2, 10, 3, 5)
    assert (idx >= 0).all()
    assert (idx.amax(dim=(0, 1, 3)) < torch.tensor([4, 7, 9])).all()
    again = batch_indices(jax.random.PRNGKey(0), [4, 7, 9], cfg)
    assert torch.equal(idx, again)
