"""End-to-end smart-exchange pipeline (paper Algorithms 1 + 2; mirrors
``repro.core.pipeline``).

    PCA (federated basis) -> K-means++ per client -> trust + channel ->
    lambda matrix -> rewards -> RL graph discovery -> AE-gated exchange.

The reference derives five sub-keys from one ``jax.random`` key; here every
draw is an explicit input gathered in :class:`PipelineDraws`, and any draw
left as ``None`` comes from one ``torch.Generator`` on the run's device.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import channel as ch
from repro_torch.core import dissimilarity as ds
from repro_torch.core import exchange as ex
from repro_torch.core import kmeans as km
from repro_torch.core import pca as pca_lib
from repro_torch.core import qlearning as ql
from repro_torch.core import rewards as rw
from repro_torch.core import trust as tr
from repro_torch.core.batching import ClientData, as_client_data


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
    cluster_after: Optional[km.KMeansDraws] = None  # post-exchange k-means++
    trust_u: Optional[torch.Tensor] = None          # (N_tx, N_rx, k)
    positions: Optional[torch.Tensor] = None        # (N, 2)
    fading: Optional[torch.Tensor] = None           # (N, N)
    rl: Optional[ql.RLDraws] = None                 # mixed policy only
    exchange: Optional[ex.ExchangeDraws] = None

    def to(self, device) -> "PipelineDraws":
        return PipelineDraws(**{f.name: _to(getattr(self, f.name), device)
                                for f in dataclasses.fields(self)})


def _to(obj, device):
    """Tensors inside (named) tuples and dicts moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple):
        vals = [_to(v, device) for v in obj]
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


def _cluster_impl(data, sizes, n_pca, n_clusters, kmeans_iters, draws):
    n, cap = data.shape[:2]
    flats = data.reshape(n, cap, -1)
    mask = (torch.arange(cap, device=data.device)[None, :]
            < sizes[:, None]).to(flats.dtype)
    pca = pca_lib.fit_pca_federated_stacked(flats, mask, n_pca)
    res = km.kmeans_batched(pca.transform(flats), sizes, n_clusters, draws,
                            kmeans_iters)
    return pca, res.centroids, res.assignments


def cluster_clients(datasets, cfg: PipelineConfig,
                    draws: Optional[km.KMeansDraws] = None,
                    generator: Optional[torch.Generator] = None,
                    device="cuda"):
    """Shared-basis federated PCA + per-client K-means++ over the stacked
    client plane. Returns ``(pca, centroids (N, k, d), assignments
    (N, cap))``; assignments at index >= sizes[i] are padding."""
    cd = as_client_data(datasets, device=resolve_device(device))
    if draws is None:
        if generator is None:
            raise ValueError("cluster_clients needs draws or a generator")
        draws = km.draw_kmeans(generator, cd.sizes, cfg.n_clusters)
    return _cluster_impl(cd.data, cd.sizes, cfg.n_pca, cfg.n_clusters,
                         cfg.kmeans_iters, draws)


def link_rewards(cents, trust, p_fail, cfg: PipelineConfig):
    """beta + lambda matrix + Eq. 2 local rewards from stacked centroids.
    Returns ``(beta, lam, local_r)``."""
    beta = cfg.beta if cfg.beta is not None else \
        ds.median_heuristic_beta(cents, cfg.beta_scale)
    lam = ds.lambda_matrix(cents, trust, beta)
    return beta, lam, rw.local_reward_matrix(lam, p_fail, cfg.reward)


def run_pipeline(datasets, labels=None, ae_cfg=None,
                 cfg: PipelineConfig = PipelineConfig(), *, in_edge=None,
                 rss=None, ae_params=None,
                 draws: Optional[PipelineDraws] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> PipelineResult:
    """The full smart exchange. ``in_edge`` skips RL; ``rss`` supplies the
    channel snapshot; ``ae_params`` skips AE pretraining. Draws not given
    come from ``generator`` (default: seed 0 on the run's device); the
    result's ``draws`` holds every draw the run used."""
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
        pca, cents, assigns = cluster_clients(cd, cfg, draws.cluster,
                                              device=dev)
    with _stage(times, "trust_channel", dev):
        if draws.trust_u is None:
            draws.trust_u = tr.draw_trust_uniforms(generator, n,
                                                   cfg.n_clusters)
        trust = tr.make_trust(draws.trust_u, cfg.p_trust)
        if rss is None:
            if draws.positions is None:
                draws.positions = ch.make_positions(generator, n, cfg.channel)
            if draws.fading is None:
                draws.fading = ch.init_fading(generator, n)
            rss = ch.rss_from_state(draws.positions, draws.fading,
                                    cfg.channel)
        p_fail = ch.failure_prob(torch.as_tensor(rss, device=dev),
                                 cfg.channel)
        beta, lam_before, local_r = link_rewards(cents, trust, p_fail, cfg)

    with _stage(times, "discover", dev):
        if in_edge is None:
            if draws.rl is None and cfg.rl.policy != "ucb":
                draws.rl = ql.draw_rl(generator, n, cfg.rl.n_episodes)
            graph = ql.discover_graph(local_r, p_fail, cfg.rl, draws=draws.rl)
            in_edge = graph.in_edge
        else:
            in_edge = torch.as_tensor(in_edge, device=dev).long()
            empty = torch.zeros((0,), device=dev)
            graph = ql.GraphResult(in_edge, torch.zeros((n, n), device=dev),
                                   empty, empty)

    with _stage(times, "exchange", dev):
        if draws.exchange is None:
            draws.exchange = ex.draw_exchange(generator, n, ae_cfg)
        res = ex.run_exchange(cd, None, assigns, trust, in_edge, p_fail,
                              ae_cfg, cfg.exchange, ae_params=ae_params,
                              draws=draws.exchange, device=dev)

    # dissimilarity on the post-exchange datasets (Fig. 3)
    with _stage(times, "cluster_after", dev):
        if draws.cluster_after is None:
            draws.cluster_after = km.draw_kmeans(
                generator, res.client_data.sizes, cfg.n_clusters)
        _, cents_after, _ = cluster_clients(res.client_data, cfg,
                                            draws.cluster_after, device=dev)
        lam_after = ds.lambda_matrix(cents_after, trust, beta)
    return PipelineResult(res.client_data, in_edge, lam_before, lam_after,
                          p_fail, graph, cents, trust, res, cents_after,
                          draws, times)
