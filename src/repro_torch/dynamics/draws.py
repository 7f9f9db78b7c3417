"""The orchestrator's draw source: every random input of an online run,
one method per stochastic site.

The reference derives each site's draws from one ``jax.random`` key with
``split``/``fold_in``. Several sites depend on sizes that change between
segments (the k-means++ first pick and the FL minibatches are uniform in
``[0, size_i)``), so the draws cannot be made up front: the orchestrator
asks its source for each site's draws when the site runs.

:class:`SeededDraws` is the port's own source. It seeds a fresh
``torch.Generator`` per (site, index) from ``(seed, site, index)``, the
port's ``fold_in``: a resumed run needs no generator state and continues
bit-identically. Any object with the same methods can stand in for it
(the tests replay the reference's key chain through one).

Methods (``s`` a segment, ``r`` an FL round, ``n`` the client count):

============================  ===============================================
``pipeline(sizes, sizes_after, cfg, ae_cfg, cap=None)``  segment 0's
                              ``PipelineDraws`` (``sizes_after=None``:
                              ``cluster_after`` is a callable of the
                              post-exchange sizes; ``cap``, default
                              ``max(sizes)``, shapes the device selector's
                              uniforms); its positions and fading also seed
                              the environment
``env(s, n)``                 the environment's ``EnvDraws`` of segment s
``crash(start, n)``           (N,) uniforms of the crash pulse starting at
                              ``start``
``burst(start, n)``           (N, N) uniforms of the link burst starting at
                              ``start``
``cluster(s, sizes, k)``      re-discovery k-means++ draws
``rl(s, n, n_ep)``            the burst's ``RLDraws`` (mixed policy only)
``uniform_edge(s, n)``        a uniform random graph (s = 0: the initial one)
``exchange(s, n, ae_cfg, sel_shape=None)``  the re-exchange's
                              ``ExchangeDraws`` (``sel_shape`` (k_max, cap):
                              with the device selector's uniforms)
``retry(s, n, ae_cfg, sel_shape=None)``  the retry exchange's
``fl_init(ae_cfg)``           the FL model's initial parameters
``fl_batch(r, sizes, cfg)``   round r's (tau_a, N, B) minibatch indices
``identity``                  an array stored as the checkpoint's ``key``
                              and checked on resume
============================  ===============================================

The two size-dependent sites, ``cluster`` and ``fl_batch``, also take an
int ``n`` as ``sizes``: they then return a callable of the (N,) sizes
tensor. The scan engine takes every draw of a chunk before the chunk runs,
when the sizes its segments will have are not known yet; :class:`SeededDraws`'
callables map uniforms it has already put on the run's device, so calling
them reads nothing back from the device.
"""
from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from repro_torch.core import channel as ch
from repro_torch.core import exchange as ex
from repro_torch.core import kmeans as km
from repro_torch.core import qlearning as ql
from repro_torch.core import trust as tr
from repro_torch.core.pipeline import PipelineDraws, move_draws
from repro_torch.dynamics.environment import EnvDraws
from repro_torch.fl.trainer import batch_indices_from
from repro_torch.models import autoencoder as ae


class SeededDraws:
    """Draws from ``torch.Generator``s seeded per (site, index) from one
    integer ``seed``. They are made on ``generator_device`` (default: the
    run's ``device``) and moved to ``device``; a card run that draws on the
    CPU takes the same numbers as a host run with the same seed (a CUDA
    generator draws other numbers from the same seed)."""

    def __init__(self, seed: int, device="cuda", generator_device=None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator_device = torch.device(
            generator_device if generator_device is not None else device)

    @property
    def identity(self) -> np.ndarray:
        return np.asarray([self.seed], np.int64)

    def _seed(self, site: str, index: int) -> int:
        h = hashlib.sha256(f"{self.seed}/{site}/{index}".encode()).digest()
        return int.from_bytes(h[:8], "little") & (2**63 - 1)

    def _gen(self, site: str, index: int) -> torch.Generator:
        g = torch.Generator(device=self.generator_device)
        return g.manual_seed(self._seed(site, index))

    def _here(self, draws):
        return move_draws(draws, self.device)

    def _rand(self, site: str, index: int, shape):
        return self._here(torch.rand(shape, generator=self._gen(site, index),
                                     device=self.generator_device))

    def _lazy(self, sizes, make):
        """``make(sizes)``, or ``make`` itself when ``sizes`` is an int."""
        if isinstance(sizes, int):
            return make
        return make(torch.as_tensor(sizes, device=self.device))

    def _kmeans(self, site: str, index: int, sizes, k: int):
        n = sizes if isinstance(sizes, int) else len(sizes)
        u = self._here(km.kmeans_uniforms(self._gen(site, index), n, k))
        return self._lazy(sizes, lambda sz: km.kmeans_draws_from(*u, sz))

    def _exchange(self, site: str, s: int, n: int, ae_cfg,
                  sel_shape=None) -> ex.ExchangeDraws:
        g = self._gen(site, s)
        dev = self.generator_device
        init = ae.init_ae(g, ae_cfg, n_clients=n)
        fail_u = torch.rand(n, generator=g, device=dev)
        sel_u = None if sel_shape is None else \
            torch.rand((n,) + tuple(sel_shape), generator=g, device=dev)
        return self._here(ex.ExchangeDraws(
            init, self._seed(site + "/reserve", s) % (2**31 - 1), fail_u,
            sel_u))

    def pipeline(self, sizes, sizes_after, cfg, ae_cfg,
                 cap=None) -> PipelineDraws:
        n, k = len(sizes), cfg.n_clusters
        sel_shape = None
        if cfg.exchange.reserve_selector == "device":
            sel_shape = (k, int(max(sizes)) if cap is None else cap)
        g = self._gen("pipeline", 0)
        after = functools.partial(self._kmeans, "cluster_after", 0, k=k)
        rl = None if cfg.rl.policy == "ucb" else \
            ql.draw_rl(g, n, cfg.rl.n_episodes)
        return PipelineDraws(
            cluster=km.draw_kmeans(g, sizes, k),
            cluster_after=after if sizes_after is None else after(sizes_after),
            trust_u=tr.draw_trust_uniforms(g, n, k),
            positions=ch.make_positions(g, n, cfg.channel),
            fading=ch.init_fading(g, n), rl=rl,
            exchange=self._exchange("pipeline/exchange", 0, n, ae_cfg,
                                    sel_shape),
        ).to(self.device)

    def env(self, s: int, n: int) -> EnvDraws:
        g = self._gen("env", s)
        dev = self.generator_device
        return self._here(EnvDraws(
            torch.randn((n, 2), generator=g, device=dev),
            torch.randn((n, n), generator=g, device=dev),
            torch.rand(n, generator=g, device=dev)))

    def crash(self, start: int, n: int) -> torch.Tensor:
        return self._rand("crash", start, (n,))

    def burst(self, start: int, n: int) -> torch.Tensor:
        return self._rand("burst", start, (n, n))

    def cluster(self, s: int, sizes, k: int) -> km.KMeansDraws:
        return self._kmeans("cluster", s, sizes, k)

    def rl(self, s: int, n: int, n_ep: int) -> ql.RLDraws:
        return self._here(ql.draw_rl(self._gen("rl", s), n, n_ep))

    def uniform_edge(self, s: int, n: int) -> torch.Tensor:
        return self._here(ql.uniform_graph(self._gen("uniform_edge", s), n))

    def exchange(self, s: int, n: int, ae_cfg,
                 sel_shape=None) -> ex.ExchangeDraws:
        return self._exchange("exchange", s, n, ae_cfg, sel_shape)

    def retry(self, s: int, n: int, ae_cfg,
              sel_shape=None) -> ex.ExchangeDraws:
        return self._exchange("retry", s, n, ae_cfg, sel_shape)

    def fl_init(self, ae_cfg) -> dict:
        return self._here(ae.init_ae(self._gen("fl_init", 0), ae_cfg))

    def fl_batch(self, r: int, sizes, cfg):
        n = sizes if isinstance(sizes, int) else len(sizes)
        u = self._here(torch.rand((1, cfg.tau_a, n, cfg.batch_size),
                                  generator=self._gen("fl_batch", r),
                                  device=self.generator_device)[0])
        return self._lazy(sizes, lambda sz: batch_indices_from(u, sz))
