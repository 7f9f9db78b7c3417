"""Replays the reference's ``jax.random`` key splits to produce the explicit
draws the port takes, and checks that the replay is faithful: JAX's own
functions fed the replayed draws' keys give what the port gives with the
draws. The other ``test_torch_*`` files import these helpers.

:class:`JaxReplayDraws` is the orchestrator's draw source replaying the
reference's key chain (``repro.dynamics.orchestrator``), site by site.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jch
from repro.core import kmeans as jkm
from repro.core import qlearning as jql
from repro.models import autoencoder as jae
from repro_torch import convert
from repro_torch.core import exchange as tex
from repro_torch.core import kmeans as tkm
from repro_torch.core import pipeline as tpl
from repro_torch.core import qlearning as tql
from repro_torch.dynamics.environment import EnvDraws


@pytest.fixture(scope="module")
def one_torch_thread():
    """Runs a module's tests on one torch intra-op thread, restoring the
    count after. The suite's parallel workers leave fewer free cores than
    torch starts threads, and its many small ops then wait on each other:
    on an 8-core host beside 6 busy processes, 3 smoke-Llama train steps
    took 88 s on 8 threads and 1.7 s on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a, dtype=None):
    """numpy/JAX array -> CPU tensor (a copy)."""
    out = torch.as_tensor(np.array(a, copy=True))
    return out if dtype is None else out.to(dtype)


def _host_ints(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@functools.partial(jax.jit, static_argnums=2)
def _kmeans_picks(key, sizes, k: int):
    def one(kk, size):
        k0, kk = jax.random.split(kk)
        first = jax.random.randint(k0, (), 0, size)
        us = []
        for _ in range(1, k):
            kk, kc = jax.random.split(kk)
            us.append(jax.random.uniform(kc, ()))
        return first, jnp.stack(us) if us else jnp.zeros((0,))
    return jax.vmap(one)(jax.random.split(key, sizes.shape[0]), sizes)


def kmeans_draws(key, sizes, k: int) -> tkm.KMeansDraws:
    """The k-means++ picks of ``kmeans_batched(key, ...)``: per client,
    ``randint(k0, (), 0, size)`` and one uniform per ``jax.random.choice``."""
    first, u = _kmeans_picks(key, jnp.asarray(_host_ints(sizes), jnp.int32),
                             k)
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


def _jax_ae_cfg(ae_cfg) -> jae.AEConfig:
    """The JAX package's AEConfig of a port (or JAX) AEConfig."""
    return jae.AEConfig(**dataclasses.asdict(ae_cfg))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _exchange_keys(key, n: int, ae_cfg, sel_shape):
    k_pre, k_sel, k_ch = jax.random.split(key, 3)
    init = jax.vmap(lambda kk: jae.init_ae(kk, ae_cfg))(
        jax.random.split(k_pre, n))
    sel_u = None if sel_shape is None else \
        jax.random.uniform(k_sel, (n,) + sel_shape)
    return (init, jax.random.randint(k_sel, (), 0, 2**31 - 1),
            jax.random.uniform(k_ch, (n,)), sel_u)


def exchange_draws(key, n: int, ae_cfg, sel_shape=None) -> tex.ExchangeDraws:
    """``run_exchange(key, ...)``'s draws; ``sel_shape`` (k_max, cap) adds
    the device selector's ``uniform(k_sel, (n, k_max, cap))``."""
    init, seed, fail_u, sel_u = _exchange_keys(
        key, n, _jax_ae_cfg(ae_cfg),
        None if sel_shape is None else tuple(int(v) for v in sel_shape))
    return tex.ExchangeDraws(convert.ae_params(jax.device_get(init)),
                             int(seed), t(fail_u),
                             None if sel_u is None else t(sel_u))


def pipeline_draws(key, cfg, ae_cfg, sizes, sizes_after,
                   cap=None) -> tpl.PipelineDraws:
    """Every draw of the reference's ``run_pipeline(key, ...)``."""
    k_cl, k_tr, k_ch, k_rl, k_ex = jax.random.split(key, 5)
    n = len(sizes)
    sel_shape = None
    if cfg.exchange.reserve_selector == "device":
        sel_shape = (cfg.n_clusters, int(max(sizes)) if cap is None else cap)
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
        exchange=exchange_draws(k_ex, n, ae_cfg, sel_shape))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _round_indices(kr, sizes, tau_a: int, b: int):
    """Round ``kr``'s (tau_a, N, B) minibatch indices, as ``fl_train``
    draws them."""
    def it(kt):
        return jax.vmap(lambda kk, s: jax.random.randint(kk, (b,), 0, s))(
            jax.random.split(kt, sizes.shape[0]), sizes)
    return jax.vmap(it)(jax.random.split(kr, tau_a))


def _round_keys(key, cfg):
    return jax.random.split(jax.random.fold_in(key, 1),
                            cfg.total_iters // cfg.tau_a)


def batch_indices(key, sizes, cfg) -> torch.Tensor:
    """(n_rounds, tau_a, N, B) minibatch indices of ``fl_train(key, ...)``."""
    sizes = jnp.asarray(_host_ints(sizes), jnp.int32)
    return t(jax.vmap(lambda kr: _round_indices(
        kr, sizes, cfg.tau_a, cfg.batch_size))(_round_keys(key, cfg)),
        torch.int64)


@functools.partial(jax.jit, static_argnums=1)
def _env_normals(key, n: int):
    kp, kf, ka = jax.random.split(key, 3)
    return (jax.random.normal(kp, (n, 2)), jax.random.normal(kf, (n, n)),
            jax.random.uniform(ka, (n,)))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _event_uniforms(key, start, salt: int, shape: tuple):
    return jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, salt), start), shape)


class JaxReplayDraws:
    """The orchestrator's draw source, replaying ``run_orchestrator(key,
    ...)``'s key chain: ``k_pipe, k_env, k_fl = split(key, 3)``; env
    ``split(fold_in(k_env, s), 3)``; fault events
    ``fold_in(fold_in(fold_in(k_env, 0xFA), salt), start)`` (salt 0x0FA1
    crash, 0x0FA2 burst); re-discovery ``split(fold_in(k_pipe, 100 + s))``;
    exchange ``fold_in(k_pipe, 200 + s)``, retry ``fold_in(k_pipe,
    300 + s)``; the initial uniform graph ``fold_in(k_pipe, 7)``; FL
    ``init_ae(k_fl)`` and round keys from ``fold_in(k_fl, 1)``. Draws are
    CPU tensors; size-dependent draws take the port's current sizes (given
    an int n instead, they return a callable of the sizes)."""

    def __init__(self, key):
        self.key = key
        self.k_pipe, self.k_env, self.k_fl = jax.random.split(key, 3)
        self.k_fault = jax.random.fold_in(self.k_env, 0xFA)

    @property
    def identity(self) -> np.ndarray:
        return np.asarray(self.key)

    def _redisc(self, s):
        return jax.random.split(jax.random.fold_in(self.k_pipe, 100 + s))

    def pipeline(self, sizes, sizes_after, cfg, ae_cfg,
                 cap=None) -> tpl.PipelineDraws:
        sizes = _host_ints(sizes)
        d = pipeline_draws(self.k_pipe, cfg, _jax_ae_cfg(ae_cfg), sizes,
                           sizes if sizes_after is None
                           else _host_ints(sizes_after), cap)
        if sizes_after is None:
            k_cl = jax.random.split(self.k_pipe, 5)[0]
            d.cluster_after = functools.partial(kmeans_draws, k_cl,
                                                k=cfg.n_clusters)
        return d

    def env(self, s, n):
        return EnvDraws(*(t(a) for a in _env_normals(
            jax.random.fold_in(self.k_env, s), n)))

    def crash(self, start, n):
        return t(_event_uniforms(self.k_fault, start, 0x0FA1, (n,)))

    def burst(self, start, n):
        return t(_event_uniforms(self.k_fault, start, 0x0FA2, (n, n)))

    def cluster(self, s, sizes, k):
        f = functools.partial(kmeans_draws, self._redisc(s)[0], k=k)
        return f if isinstance(sizes, int) else f(sizes)

    def rl(self, s, n, n_ep):
        return rl_draws(self._redisc(s)[1], n, n_ep)

    def uniform_edge(self, s, n):
        key = jax.random.fold_in(self.k_pipe, 7) if s == 0 \
            else self._redisc(s)[1]
        return t(jql.uniform_graph(key, n), torch.int64)

    def exchange(self, s, n, ae_cfg, sel_shape=None):
        return exchange_draws(jax.random.fold_in(self.k_pipe, 200 + s), n,
                              ae_cfg, sel_shape)

    def retry(self, s, n, ae_cfg, sel_shape=None):
        return exchange_draws(jax.random.fold_in(self.k_pipe, 300 + s), n,
                              ae_cfg, sel_shape)

    def fl_init(self, ae_cfg):
        return convert.ae_params(jax.device_get(jax.jit(
            jae.init_ae, static_argnums=1)(self.k_fl, _jax_ae_cfg(ae_cfg))))

    def fl_batch(self, r, sizes, cfg):
        kr = _round_keys(self.k_fl, cfg)[r]

        def f(sz):
            return t(_round_indices(kr, jnp.asarray(_host_ints(sz), jnp.int32),
                                    cfg.tau_a, cfg.batch_size), torch.int64)
        return f if isinstance(sizes, int) else f(sizes)


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


def test_replay_round_by_round_equals_the_horizon():
    """``JaxReplayDraws.fl_batch`` (one round, the sizes of that round)
    gives the rounds of ``batch_indices`` (the whole horizon at once)."""
    from repro.fl.trainer import FLConfig
    cfg = FLConfig(total_iters=30, tau_a=10, batch_size=5)
    draws = JaxReplayDraws(jax.random.PRNGKey(4))
    whole = batch_indices(draws.k_fl, [4, 7, 9], cfg)
    for r in range(3):
        assert torch.equal(draws.fl_batch(r, torch.tensor([4, 7, 9]), cfg),
                           whole[r])
    edge = draws.uniform_edge(0, 6)
    assert edge.dtype == torch.int64 and (edge != torch.arange(6)).all()
