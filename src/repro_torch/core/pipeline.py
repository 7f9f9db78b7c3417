"""End-to-end smart-exchange pipeline (paper Algorithms 1 + 2; mirrors
``repro.core.pipeline``).

    PCA (federated basis) -> K-means++ per client -> trust + channel ->
    lambda matrix -> rewards -> RL graph discovery -> AE-gated exchange.

The reference derives five sub-keys from one ``jax.random`` key; here every
draw is an explicit input gathered in :class:`PipelineDraws`, and any draw
left as ``None`` comes from one ``torch.Generator`` on the run's device.

``rules`` shards the client axis through clustering, discovery and the
exchange (``repro_torch.sharding`` lists each stage's collectives); the
draws are made whole, the centroids are gathered for beta and the lambda
matrix, and K-means stays shard-local: each rank's ``kmeans_assign``
launch covers its own clients.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch import obs, resolve_device
from repro_torch import sharding as sh
from repro_torch.core import channel as ch
from repro_torch.core import dissimilarity as ds
from repro_torch.core import exchange as ex
from repro_torch.core import kmeans as km
from repro_torch.core import pca as pca_lib
from repro_torch.core import qlearning as ql
from repro_torch.core import rewards as rw
from repro_torch.core import trust as tr
from repro_torch.core.batching import ClientData, as_client_data, \
    shard_client_data


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_pca: int = 32
    n_clusters: int = 3            # k_i (paper: 3 classes per device)
    kmeans_iters: int = 25
    beta: Optional[float] = None   # None -> median heuristic
    beta_scale: float = 0.8
    p_trust: float = 0.9
    reward: rw.RewardConfig = dataclasses.field(default_factory=rw.RewardConfig)
    rl: ql.RLConfig = dataclasses.field(default_factory=ql.RLConfig)
    channel: ch.ChannelConfig = dataclasses.field(
        default_factory=ch.ChannelConfig)
    exchange: ex.ExchangeConfig = dataclasses.field(
        default_factory=ex.ExchangeConfig)


@dataclasses.dataclass
class PipelineDraws:
    """Every random input of :func:`run_pipeline`; ``None`` fields are drawn
    from the generator when the stage runs."""
    cluster: Optional[km.KMeansDraws] = None        # pre-exchange k-means++
    # post-exchange k-means++; a callable takes the post-exchange sizes
    cluster_after: Optional[km.KMeansDraws] = None
    trust_u: Optional[torch.Tensor] = None          # (N_tx, N_rx, k)
    positions: Optional[torch.Tensor] = None        # (N, 2)
    fading: Optional[torch.Tensor] = None           # (N, N)
    rl: Optional[ql.RLDraws] = None                 # mixed policy only
    exchange: Optional[ex.ExchangeDraws] = None

    def to(self, device) -> "PipelineDraws":
        return PipelineDraws(**{f.name: move_draws(getattr(self, f.name),
                                                   device)
                                for f in dataclasses.fields(self)})


def move_draws(obj, device):
    """Tensors inside (named) tuples and dicts moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: move_draws(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple):
        vals = [move_draws(v, device) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


@dataclasses.dataclass
class PipelineResult:
    """One-shot pipeline output; ``client_data`` is the post-exchange
    stack."""
    client_data: ClientData
    in_edge: torch.Tensor
    lam_before: torch.Tensor
    lam_after: torch.Tensor
    p_fail: torch.Tensor
    graph: ql.GraphResult
    centroids: torch.Tensor          # (N, k, d) pre-exchange centroids
    trust: Optional[torch.Tensor] = None   # (N_tx, N_rx, k)
    exchange: Optional[ex.ExchangeResult] = None
    centroids_after: Optional[torch.Tensor] = None
    draws: Optional[PipelineDraws] = None   # every draw the run used
    # host seconds per stage, each ended by a device synchronise
    stage_seconds: dict = dataclasses.field(default_factory=dict)

    @property
    def datasets(self) -> list:
        return self.client_data.data_list()

    @property
    def labels(self) -> Optional[list]:
        return self.client_data.label_list()

    @property
    def moved_counts(self):
        return self.exchange.moved_counts


@contextmanager
def _stage(times: dict, name: str, device: torch.device):
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[name] = time.perf_counter() - t0


def _cluster_impl(data, sizes, n_pca, n_clusters, kmeans_iters, draws,
                  rules=None):
    """The clustering program on a client stack (placed or whole) with
    whole sizes and draws; the centroids and assignments come out placed."""
    n, cap = data.shape[:2]
    part = sh.ClientSlice(rules, n)
    data, sizes, draws = part.rows((data, sizes, draws))
    flats = data.reshape(part.n_local, cap, -1)
    mask = (torch.arange(cap, device=data.device)[None, :]
            < sizes[:, None]).to(flats.dtype)
    pca = pca_lib.fit_pca_federated_stacked(flats, mask, n_pca, part)
    res = km.kmeans_batched(pca.transform(flats), sizes, n_clusters, draws,
                            kmeans_iters)
    return pca, part.place(res.centroids), part.place(res.assignments)


def cluster_clients(datasets, cfg: PipelineConfig,
                    draws: Optional[km.KMeansDraws] = None,
                    generator: Optional[torch.Generator] = None,
                    device="cuda", rules=None):
    """Shared-basis federated PCA + per-client K-means++ over the stacked
    client plane. Returns ``(pca, centroids (N, k, d), assignments
    (N, cap))``; assignments at index >= sizes[i] are padding. With
    ``rules`` the PCA basis is whole on every rank (the moments' one
    all-reduce) and the centroids and assignments are placed."""
    with obs.span("cluster"):
        cd = as_client_data(datasets, device=resolve_device(device),
                            rules=rules)
        if draws is None:
            if generator is None:
                raise ValueError(
                    "cluster_clients needs draws or a generator")
            draws = km.draw_kmeans(generator, cd.sizes, cfg.n_clusters)
        return _cluster_impl(cd.data, cd.sizes, cfg.n_pca, cfg.n_clusters,
                             cfg.kmeans_iters, draws, rules)


def cluster_clients_loop(datasets, cfg: PipelineConfig,
                         draws: km.KMeansDraws, device="cuda"):
    """The host loop of :func:`cluster_clients`: the same masked math one
    client at a time (its parity reference). The PCA moments are summed per
    client; the basis projection is one batched call in both forms, as in
    the reference (a per-client projection would round differently and
    smear that difference over everything downstream). Each client's fit
    takes row i of the batched ``draws`` and launches ``kmeans_assign``
    with 2-D inputs."""
    cd = as_client_data(datasets, device=resolve_device(device))
    n, cap = cd.n_clients, cd.cap
    flats = cd.data.reshape(n, cap, -1)
    mask = cd.mask(flats.dtype)
    moments = [pca_lib.client_moments(flats[i], mask[i]) for i in range(n)]
    s1 = torch.sum(torch.stack([m[0] for m in moments]), dim=0)
    s2 = torch.sum(torch.stack([m[1] for m in moments]), dim=0)
    pca = pca_lib._pca_from_moments(s1, s2, torch.sum(mask), cfg.n_pca)
    z = pca.transform(flats)
    fits = [km.kmeans_masked(z[i], cd.sizes[i], cfg.n_clusters,
                             km.KMeansDraws(draws.first[i], draws.u[i]),
                             cfg.kmeans_iters) for i in range(n)]
    return (pca, torch.stack([f.centroids for f in fits]),
            torch.stack([f.assignments for f in fits]))


def link_rewards(cents, trust, p_fail, cfg: PipelineConfig):
    """beta + lambda matrix + Eq. 2 local rewards from the whole stacked
    centroids (a sharded caller gathers them first). Returns
    ``(beta, lam, local_r)``."""
    beta = cfg.beta if cfg.beta is not None else \
        ds.median_heuristic_beta(cents, cfg.beta_scale)
    lam = ds.lambda_matrix(cents, trust, beta)
    return beta, lam, rw.local_reward_matrix(lam, p_fail, cfg.reward)


def run_pipeline(datasets, labels=None, ae_cfg=None,
                 cfg: PipelineConfig = PipelineConfig(), *, in_edge=None,
                 rss=None, ae_params=None,
                 draws: Optional[PipelineDraws] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", rules=None) -> PipelineResult:
    """The full smart exchange. ``in_edge`` skips RL; ``rss`` supplies the
    channel snapshot; ``ae_params`` skips AE pretraining. Draws not given
    come from ``generator`` (default: seed 0 on the run's device); the
    result's ``draws`` holds every draw the run used. ``rules`` shards the
    client axis (module docstring): the result's client stack and gate
    stacks are placed, the graph, lambdas and centroids whole."""
    with obs.span("pipeline"):
        dev = resolve_device(device)
        draws = draws.to(dev) if draws else PipelineDraws()
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        times = {}
        cd = as_client_data(datasets, labels, device=dev)
        n = cd.n_clients

        with _stage(times, "cluster", dev):
            if draws.cluster is None:
                draws.cluster = km.draw_kmeans(generator, cd.sizes,
                                               cfg.n_clusters)
            cd = shard_client_data(cd, rules)
            pca, cents, assigns = cluster_clients(cd, cfg, draws.cluster,
                                                  device=dev, rules=rules)
            cents = sh.gather_clients(cents, rules)
        with _stage(times, "trust_channel", dev), \
                obs.span("trust-channel"):
            if draws.trust_u is None:
                draws.trust_u = tr.draw_trust_uniforms(generator, n,
                                                       cfg.n_clusters)
            trust = tr.make_trust(draws.trust_u, cfg.p_trust)
            if rss is None:
                if draws.positions is None:
                    draws.positions = ch.make_positions(generator, n,
                                                        cfg.channel)
                if draws.fading is None:
                    draws.fading = ch.init_fading(generator, n)
                rss = ch.rss_from_state(draws.positions, draws.fading,
                                        cfg.channel)
            p_fail = ch.failure_prob(torch.as_tensor(rss, device=dev),
                                     cfg.channel)
            beta, lam_before, local_r = link_rewards(cents, trust, p_fail,
                                                     cfg)

        with _stage(times, "discover", dev):
            if in_edge is None:
                if draws.rl is None and cfg.rl.policy != "ucb":
                    draws.rl = ql.draw_rl(generator, n, cfg.rl.n_episodes)
                graph = ql.discover_graph(local_r, p_fail, cfg.rl,
                                          draws=draws.rl, rules=rules)
                in_edge = graph.in_edge
            else:
                in_edge = torch.as_tensor(in_edge, device=dev).long()
                empty = torch.zeros((0,), device=dev)
                graph = ql.GraphResult(in_edge,
                                       torch.zeros((n, n), device=dev),
                                       empty, empty)

        with _stage(times, "exchange", dev):
            if draws.exchange is None:
                draws.exchange = ex.draw_exchange(
                    generator, n, ae_cfg,
                    (cfg.n_clusters, cd.cap)
                    if cfg.exchange.reserve_selector == "device" else None)
            res = ex.run_exchange(cd, None, assigns, trust, in_edge, p_fail,
                                  ae_cfg, cfg.exchange, ae_params=ae_params,
                                  draws=draws.exchange, device=dev,
                                  rules=rules)

        # dissimilarity on the post-exchange datasets (Fig. 3)
        with _stage(times, "cluster_after", dev):
            if draws.cluster_after is None:
                draws.cluster_after = km.draw_kmeans(
                    generator, res.client_data.sizes, cfg.n_clusters)
            elif callable(draws.cluster_after):
                draws.cluster_after = draws.cluster_after(
                    res.client_data.sizes)
            _, cents_after, _ = cluster_clients(res.client_data, cfg,
                                                draws.cluster_after,
                                                device=dev, rules=rules)
            cents_after = sh.gather_clients(cents_after, rules)
            lam_after = ds.lambda_matrix(cents_after, trust, beta)
        return PipelineResult(res.client_data, in_edge, lam_before,
                              lam_after, p_fail, graph, cents, trust, res,
                              cents_after, draws, times)
