"""Mesh lab: a deterministic client world and the client-stacked hot paths
(clustering, AE pretraining, the exchange gate, FL rounds, RL discovery),
runnable with or without :class:`~repro_torch.sharding.ShardingRules`
(mirrors ``repro.meshlab``).

Shared by the mesh parity tests (``tests/test_torch_mesh.py``) and
``chip_smoke.py``. The reference spawns one child per mesh size with a
forced XLA device count; here :func:`spawn` starts ``world`` ranks of
``torch.distributed`` (gloo on the host, a ``file://`` store in a temporary
directory: no port, no network), every rank runs the same function on the
same world, and rank 0's value comes back. On the card a one-rank NCCL
group does the same in process (``launch.mesh.make_client_mesh(1)``).

The world comes from ``torch.Generator``s on the host seeded per site from
``LabConfig.seed`` (the port cannot replay threefry), so every rank and
every device draws the same numbers. Client sizes are ragged, so every
stacked program runs the mask-padded plane.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import math
import os
import pickle
import tempfile
import time
from collections import Counter

import torch

from repro_torch import resolve_device
from repro_torch import sharding as sh
from repro_torch.core import channel as ch
from repro_torch.core import exchange as ex
from repro_torch.core import kmeans as km
from repro_torch.core import qlearning as ql
from repro_torch.core import rewards as rw
from repro_torch.core import trust as tr
from repro_torch.core.batching import as_client_data, stack_clients
from repro_torch.core.pipeline import (PipelineConfig, cluster_clients,
                                       cluster_clients_loop)
from repro_torch.fl.trainer import FLConfig, batch_indices_from, fl_train
from repro_torch.models import autoencoder as ae

# the torch.distributed calls a stage may make (the test counts them all)
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
               "all_gather", "broadcast", "barrier", "reduce_scatter_tensor",
               "all_to_all_single", "scatter", "gather", "reduce")


@dataclasses.dataclass(frozen=True)
class LabConfig:
    n_clients: int = 8
    n_per_client: int = 40
    n_clusters: int = 3
    reserve: int = 8
    hw: int = 16                   # image height == width
    widths: tuple = (4, 8)
    latent: int = 8
    tau_a: int = 5
    n_rounds: int = 2
    batch_size: int = 16
    rl_episodes: int = 120         # discovery program length (one burst)
    rl_buffer: int = 30
    seed: int = 0

    @property
    def ae_cfg(self) -> ae.AEConfig:
        return ae.AEConfig(self.hw, self.hw, 1, widths=self.widths,
                           latent_dim=self.latent)


def make_rules(mesh_size, device="cuda"):
    """``ShardingRules`` over a ``mesh_size``-rank "data" axis; ``None`` is
    unsharded. ``mesh_size`` is the process group's size, or 1 inside a
    larger group: every rank then holds its own one-rank "data" axis under
    a "replica" axis (the reference's mesh of one device). A pair (pod,
    data) of the group's size gives a (pod, data) mesh, whose client axis
    is the product ("pod", "data")."""
    if mesh_size is None:
        return None
    from repro_torch.launch.mesh import make_client_mesh
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    if isinstance(mesh_size, tuple):
        from torch.distributed.device_mesh import init_device_mesh
        if math.prod(mesh_size) != world:
            raise ValueError(f"a {mesh_size} mesh in a {world}-rank group")
        return sh.ShardingRules.default(init_device_mesh(
            resolve_device(device).type, mesh_size,
            mesh_dim_names=("pod", "data")))
    if mesh_size == world:
        return sh.ShardingRules.default(make_client_mesh(mesh_size, device))
    if mesh_size != 1:
        raise ValueError(f"a {mesh_size}-rank mesh in a {world}-rank group")
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    return sh.ShardingRules.default(init_device_mesh(
        dev.type, (world, 1), mesh_dim_names=("replica", "data")))


def _gen(cfg: LabConfig, site: int) -> torch.Generator:
    return torch.Generator().manual_seed(cfg.seed * 1000 + site)


def build_world(cfg: LabConfig, device="cuda") -> dict:
    """Datasets, cluster ids, trust, P_D, a graph, local rewards and every
    draw the paths take, for N clients, on ``device`` (the card unless the
    caller asks for the CPU).

    Client sizes are ragged, ``max(n_per_client - 3 * (i % 4), 4)``, as in
    the reference."""
    device = resolve_device(device)
    n, k, hw = cfg.n_clients, cfg.n_clusters, cfg.hw
    sizes = [max(cfg.n_per_client - 3 * (i % 4), 4) for i in range(n)]
    g = _gen(cfg, 0)
    datasets = [torch.rand((s, hw, hw, 1), generator=g) for s in sizes]
    assignments = [torch.randint(0, k, (s,), generator=g) for s in sizes]
    g = _gen(cfg, 1)
    trust = tr.make_trust(tr.draw_trust_uniforms(g, n, k), 0.9)
    p_fail = ch.failure_prob(ch.make_rss(g, n))
    in_edge = ql.uniform_graph(g, n)
    eval_data = torch.rand((32, hw, hw, 1), generator=g)
    lam = torch.rand((n, n), generator=g)
    g = _gen(cfg, 2)
    pre_init = ae.init_ae(g, cfg.ae_cfg, n_clients=n)
    ex_seed = int(torch.randint(0, 2**31 - 1, (1,), generator=g))
    fail_u = torch.rand(n, generator=g)
    g = _gen(cfg, 3)
    fl_init = ae.init_ae(g, cfg.ae_cfg)
    fl_u = torch.rand((cfg.n_rounds, cfg.tau_a, n, cfg.batch_size),
                      generator=g)
    half = cfg.rl_episodes // 2
    rl = ql.draw_rl(_gen(cfg, 4), n, cfg.rl_episodes)
    rl_warm = (ql.draw_rl(_gen(cfg, 5), n, half),
               ql.draw_rl(_gen(cfg, 6), n, cfg.rl_episodes - half))
    sizes_t = torch.as_tensor(sizes)
    world = {
        "datasets": datasets, "assignments": assignments, "trust": trust,
        "p_fail": p_fail, "in_edge": in_edge, "eval_data": eval_data,
        "local_r": rw.local_reward_matrix(lam, p_fail),
        "pre_init": pre_init, "ex_seed": ex_seed, "fail_u": fail_u,
        "fl_init": fl_init, "fl_batch": batch_indices_from(fl_u, sizes_t),
        "rl": rl, "rl_warm": rl_warm,
        "cl_draws": km.draw_kmeans(_gen(cfg, 7), sizes_t, k),
        "cluster_data": _cluster_world(_gen(cfg, 8), cfg, sizes)}
    world = sh._map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else x, world)
    world["cfg"], world["device"] = cfg, torch.device(device)
    return world


def _cluster_world(g: torch.Generator, cfg: LabConfig, sizes) -> list:
    """Blobby ragged datasets for the clustering program: six shared
    prototypes plus small noise, at about unit flattened norm, so the
    covariance has separated eigenvalues and the retained basis (and the
    centroids) stay put under the moment all-reduce's reassociation, as in
    the reference."""
    scale = 1.0 / cfg.hw
    protos = torch.randn((6, cfg.hw, cfg.hw, 1), generator=g) * scale
    out = []
    for s in sizes:
        ids = torch.randint(0, 6, (s,), generator=g)
        noise = torch.randn((s, cfg.hw, cfg.hw, 1), generator=g)
        out.append(protos[ids] + 0.05 * scale * noise)
    return out


# ---------------------------------------------------------------------------
# the hot paths
# ---------------------------------------------------------------------------

def _excfg(cfg: LabConfig) -> ex.ExchangeConfig:
    return ex.ExchangeConfig(reserve_per_cluster=cfg.reserve)


def run_pretrain(world, rules):
    """One full-batch AE step over the (sharded) client stack."""
    cfg: LabConfig = world["cfg"]
    cd = as_client_data(world["datasets"], device=world["device"],
                        rules=rules)
    return ex.pretrain_autoencoders_batched(world["pre_init"], cd,
                                            cfg.ae_cfg, _excfg(cfg), rules)


def gate_operands(world, rules):
    """The exchange program's operands: host-selected reserve indices (the
    whole cluster ids are host lists here, so no gather), the stacked
    trust, the channel uniforms and the placed client stack."""
    cfg: LabConfig = world["cfg"]
    n, dev = cfg.n_clients, world["device"]
    trust_np = ex._trust_list(world["trust"])
    k_max = max(t.shape[1] for t in trust_np)
    assigns, sizes = stack_clients(world["assignments"])
    sel = ex._select_reserves(world["ex_seed"], assigns,
                              [t.shape[1] for t in trust_np], cfg.reserve,
                              sizes)
    sel_idx, sel_mask = ex._sel_tensors(sel, n, k_max, cfg.reserve)
    cd = as_client_data(world["datasets"], device=dev, rules=rules)
    out_cap = cd.cap + int(sel_mask.sum(axis=(1, 2)).max(initial=0))
    sel_idx, sel_mask = sh.shard_clients(
        (torch.as_tensor(sel_idx, device=dev),
         torch.as_tensor(sel_mask, device=dev)), rules)
    trust_s = torch.as_tensor(ex._stack_trust_padded(trust_np, n, k_max),
                              device=dev)
    return (cd, sel_idx, sel_mask, trust_s, world["fail_u"],
            world["in_edge"], out_cap)


def run_gate(world, params, operands, rules):
    """The exchange program (gather reserves, score the gate, scatter):
    (new ClientData, moved, base, scores, fail, accept, overflowed)."""
    cfg: LabConfig = world["cfg"]
    cd, sel_idx, sel_mask, trust_s, fail_u, in_edge, out_cap = operands
    return ex._exchange_device(params, cd.data, cd.sizes, cd.labels,
                               sel_idx, sel_mask, trust_s, fail_u,
                               world["p_fail"], in_edge, cfg.ae_cfg, False,
                               out_cap, rules)


def run_fl_segment(world, rules):
    """A short FL segment (``n_rounds`` aggregation rounds) from scratch:
    (global params, client params)."""
    cfg: LabConfig = world["cfg"]
    flcfg = FLConfig(total_iters=cfg.tau_a * cfg.n_rounds, tau_a=cfg.tau_a,
                     eval_every=cfg.tau_a * cfg.n_rounds,
                     batch_size=cfg.batch_size)
    res = fl_train(world["datasets"], cfg.ae_cfg, flcfg, world["eval_data"],
                   init_params=world["fl_init"], batch_idx=world["fl_batch"],
                   device=world["device"], rules=rules)
    return res.global_params, res.client_params


def _pipe_cfg(cfg: LabConfig) -> PipelineConfig:
    # n_pca=4 < the cluster world's rank-5 prototype scatter
    return PipelineConfig(n_pca=4, n_clusters=cfg.n_clusters,
                          kmeans_iters=10)


def run_cluster(world, rules):
    """The stacked clustering program (masked federated PCA + batched
    K-means++) on the blobby world: (components, centroids,
    assignments)."""
    cfg: LabConfig = world["cfg"]
    pca, cents, assigns = cluster_clients(
        world["cluster_data"], _pipe_cfg(cfg), world["cl_draws"],
        device=world["device"], rules=rules)
    return pca.components, cents, assigns


def run_cluster_loop(world):
    """The per-client host loop of the same masked math."""
    cfg: LabConfig = world["cfg"]
    pca, cents, assigns = cluster_clients_loop(
        world["cluster_data"], _pipe_cfg(cfg), world["cl_draws"],
        device=world["device"])
    return pca.components, cents, assigns


def _rl_cfg(cfg: LabConfig, policy: str) -> ql.RLConfig:
    return ql.RLConfig(n_episodes=cfg.rl_episodes, buffer_size=cfg.rl_buffer,
                       policy=policy)


def run_discovery(world, rules, policy: str = "mixed") -> ql.GraphResult:
    """One cold-start RL burst (Algorithm 1) with the agents placed per
    ``rules``."""
    cfg: LabConfig = world["cfg"]
    return ql.discover_graph(world["local_r"], world["p_fail"],
                             _rl_cfg(cfg, policy),
                             draws=None if policy == "ucb" else world["rl"],
                             rules=rules)


def run_discovery_warm(world, rules, policy: str = "mixed") -> ql.GraphResult:
    """Two chained bursts, the second warm-started from the first's placed
    state (the orchestrator's re-discovery)."""
    cfg: LabConfig = world["cfg"]
    half = cfg.rl_episodes // 2
    first = ql.discover_graph(world["local_r"], world["p_fail"],
                              _rl_cfg(cfg, policy), n_episodes=half,
                              draws=world["rl_warm"][0], rules=rules)
    return ql.discover_graph(world["local_r"], world["p_fail"],
                             _rl_cfg(cfg, policy), init_state=first.state,
                             n_episodes=cfg.rl_episodes - half,
                             draws=world["rl_warm"][1], rules=rules)


# ---------------------------------------------------------------------------
# parity and timing (each rank runs them)
# ---------------------------------------------------------------------------

def digest(tree) -> str:
    """sha256 over the bytes of every tensor leaf (gather placed ones
    first: :func:`whole`)."""
    h = hashlib.sha256()
    for leaf in sh._leaves(tree):
        h.update(leaf.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def max_abs_diff(a, b) -> float:
    return max(float(torch.max(torch.abs(x.double() - y.double())))
               for x, y in zip(sh._leaves(a), sh._leaves(b)))


def whole(tree, rules):
    """``tree`` with every placed stack gathered (one all-gather)."""
    return sh.gather_clients(tree, rules)


@contextlib.contextmanager
def count_collectives(into: Counter):
    """Count every ``torch.distributed`` collective called inside, by name
    (DTensor's own collectives go through ``_functional_collectives``,
    counted as ``funcol.<name>``)."""
    dist = torch.distributed
    from torch.distributed import _functional_collectives as funcol
    saved = []
    for mod, prefix, names in (
            (dist, "", COLLECTIVES),
            (funcol, "funcol.", [n for n in dir(funcol) if n.startswith(
                ("all_", "reduce_", "broadcast", "permute"))])):
        for name in names:
            fn = getattr(mod, name, None)
            if not callable(fn):
                continue

            def wrapped(*a, _fn=fn, _key=prefix + name, **kw):
                into[_key] += 1
                return _fn(*a, **kw)
            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
    try:
        yield into
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _stage(counts: dict, name: str, fn, count: bool):
    if not count:
        return fn()
    c = Counter()
    with count_collectives(c):
        out = fn()
    counts[name] = dict(c)
    return out


def parity_report(cfg: LabConfig, mesh_size: int, device="cuda",
                  count: bool = False) -> dict:
    """Run every path unsharded, at mesh 1 and at ``mesh_size``; report
    digests (bit parity) and max float deltas. With ``count``, each stage's
    ``torch.distributed`` calls by name under ``collectives_<tag>``.

    Discovery: ``disc`` (Eq. 4's mixed policy), ``disc_ucb`` and
    ``disc_warm``; their collectives reassociate float sums at mesh > 1,
    so parity there is a Q delta and agreement of the final links, as for
    the FL round's all-reduce. Clustering's moment all-reduce reassociates
    too: a centroid delta and agreement of every assignment."""
    device = resolve_device(device)
    world = build_world(cfg, device)
    out = {"world_size": torch.distributed.get_world_size()
           if torch.distributed.is_initialized() else 1,
           "mesh_size": mesh_size, "n_clients": cfg.n_clients}
    discoveries = (("disc", lambda r: run_discovery(world, r, "mixed")),
                   ("disc_ucb", lambda r: run_discovery(world, r, "ucb")),
                   ("disc_warm", lambda r: run_discovery_warm(world, r)))
    tags = [("base", None), ("mesh1", make_rules(1, device))]
    if mesh_size != 1:
        tags.append((mesh_tag(mesh_size), make_rules(mesh_size, device)))
    ref = {}
    for tag, rules in tags:
        counts = {}
        params = _stage(counts, "pretrain",
                        lambda: run_pretrain(world, rules), count)
        operands = _stage(counts, "gate_operands",
                          lambda: gate_operands(world, rules), count)
        gate = _stage(counts, "gate",
                      lambda: run_gate(world, params, operands, rules), count)
        gp, cp = _stage(counts, "fl", lambda: run_fl_segment(world, rules),
                        count)
        cluster = _stage(counts, "cluster", lambda: run_cluster(world, rules),
                         count)
        graphs = {name: _stage(counts, name, lambda fn=fn: fn(rules), count)
                  for name, fn in discoveries}
        if count:
            out[f"collectives_{tag}"] = counts
        params, gate, cp, cluster, graphs = whole(
            (params, gate, cp, cluster, graphs), rules)
        out[f"pretrain_digest_{tag}"] = digest(params)
        out[f"gate_digest_{tag}"] = digest(gate)
        out[f"fl_digest_{tag}"] = digest((gp, cp))
        out[f"cluster_digest_{tag}"] = digest(cluster)
        for name, g in graphs.items():
            out[f"{name}_digest_{tag}"] = digest((g.in_edge, g.state))
        if tag == "base":
            ref = {"params": params, "gate": gate, "gp": gp,
                   "cluster": cluster, "graphs": graphs}
            continue
        out[f"pretrain_maxdiff_{tag}"] = max_abs_diff(ref["params"], params)
        out[f"gate_maxdiff_{tag}"] = max_abs_diff(ref["gate"][2:4], gate[2:4])
        out[f"fl_maxdiff_{tag}"] = max_abs_diff(ref["gp"], gp)
        out[f"cluster_cents_maxdiff_{tag}"] = max_abs_diff(
            ref["cluster"][1], cluster[1])
        out[f"cluster_assign_agree_{tag}"] = int(
            (ref["cluster"][2] == cluster[2]).sum())
        out[f"cluster_assign_total_{tag}"] = int(cluster[2].numel())
        for name, g in graphs.items():
            rg = ref["graphs"][name]
            out[f"{name}_q_maxdiff_{tag}"] = max_abs_diff(rg.q, g.q)
            out[f"{name}_edge_agree_{tag}"] = int(
                (rg.in_edge == g.in_edge).sum())
    return out


def mesh_tag(mesh_size) -> str:
    """"mesh4", or "mesh2x2" for a (pod, data) pair."""
    if isinstance(mesh_size, tuple):
        return "mesh" + "x".join(map(str, mesh_size))
    return f"mesh{mesh_size}"


def time_path(fn, *, iters: int = 5) -> float:
    """Mean wall-clock us per call after one warm-up call (a card run is
    synchronised before each clock read)."""
    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters * 1e6


def timing_report(cfg: LabConfig, mesh_size, iters: int = 5,
                  device="cuda") -> dict:
    """Wall time of the gate program, an FL segment, a discovery burst and
    the clustering program at the given mesh size (None: unsharded)."""
    device = resolve_device(device)
    world = build_world(cfg, device)
    rules = make_rules(mesh_size, device)
    params = run_pretrain(world, rules)
    operands = gate_operands(world, rules)
    gate_us = time_path(lambda: run_gate(world, params, operands, rules),
                        iters=iters)
    fl_us = time_path(lambda: run_fl_segment(world, rules),
                      iters=max(iters // 2, 2))
    disc_us = time_path(lambda: run_discovery(world, rules),
                        iters=max(iters // 2, 2))
    cluster_us = time_path(lambda: run_cluster(world, rules), iters=iters)
    n = cfg.n_clients
    return {"mesh_size": 0 if mesh_size is None else mesh_size,
            "n_clients": n, "gate_us": gate_us, "fl_segment_us": fl_us,
            "disc_us": disc_us, "rl_episodes": cfg.rl_episodes,
            "cluster_us": cluster_us, "gate_us_per_client": gate_us / n,
            "fl_us_per_client": fl_us / n,
            "cluster_us_per_client": cluster_us / n,
            "disc_us_per_agent_episode": disc_us / (n * cfg.rl_episodes)}


# ---------------------------------------------------------------------------
# the one-shot pipeline and the online orchestrator, sharded and not
# ---------------------------------------------------------------------------

ONLINE_AE = ae.AEConfig(8, 8, 1, widths=(4, 8), latent_dim=8)


def online_world(n_clients: int = 6, cut: int = 3, seed: int = 0):
    """A small labelled world: 8x8 synthetic images of 10 classes over
    ``n_clients`` clients with three circular classes each, client i cut
    by ``cut * i`` rows (unequal sizes leave ``overflow="drop"`` room to
    move data). Returns (datasets, labels, eval images)."""
    from repro_torch.data import make_split_dataset, partition_by_classes
    g = torch.Generator().manual_seed(seed)
    train, ev = make_split_dataset(g, n_train_per_class=30,
                                   n_eval_per_class=6, height=8, width=8,
                                   channels=1)
    xs, ys, _ = partition_by_classes(seed, train.images.numpy(),
                                     train.labels.numpy(),
                                     n_clients=n_clients,
                                     classes_per_client=3, circular=True)
    return ([x[:len(x) - cut * i] for i, x in enumerate(xs)],
            [y[:len(y) - cut * i] for i, y in enumerate(ys)], ev.images)


def online_config(segment_impl: str = "eager", **kw):
    """The orchestrator tests' small config: UCB bursts of 20 episodes, a
    re-exchange with channel failures and retries every segment, 4 segments
    of one FL round; the scan engine's exchange drops overflow and selects
    reserves on the device."""
    from repro_torch.dynamics import OrchestratorConfig
    from repro_torch.faults import RetryPolicy
    scan = segment_impl == "scan"
    pcfg = PipelineConfig(
        n_pca=4, kmeans_iters=5,
        rl=ql.RLConfig(n_episodes=30, buffer_size=10, policy="ucb"),
        exchange=ex.ExchangeConfig(
            reserve_per_cluster=8, apply_channel_failure=True,
            overflow="drop" if scan else "grow",
            reserve_selector="device" if scan else "host"))
    return OrchestratorConfig(
        n_segments=4, iters_per_segment=10, mode="online",
        rediscover_every=1, burst_episodes=20, pipeline=pcfg,
        fl=FLConfig(tau_a=10, batch_size=8, eval_every=10),
        retry=RetryPolicy(enabled=True), segment_impl=segment_impl, **kw)


def _flat(tree) -> torch.Tensor:
    return torch.cat([x.detach().reshape(-1).cpu().to(torch.float64)
                      for x in sh._leaves(tree)])


def _gate_margin(res) -> float:
    """Smallest relative gate margin |score - base| / |base| over the pairs
    the gate decided on its scores (trusted, with reserves, live, channel
    held); exact decisions are comparable across meshes above ~1e-5."""
    ctx = res.exchange._ctx
    trust_s, in_edge = ctx[0], ctx[2].cpu()
    base = sh.full_tensor(res.exchange.base).cpu()
    scores = sh.full_tensor(res.exchange.scores).cpu()
    n = in_edge.shape[0]
    allowed = torch.stack([torch.as_tensor(trust_s[int(in_edge[i])][i]) != 0
                           for i in range(n)])
    allowed &= (in_edge != torch.arange(n))[:, None]
    allowed &= ~res.exchange.fail.cpu()[:, None]
    rel = (scores - base[:, None]).abs() / base[:, None].abs()
    return float(rel[allowed].min()) if bool(allowed.any()) else float("inf")


def pipeline_report(mesh_size: int, device="cuda") -> dict:
    """``run_pipeline`` + ``fl_train`` on :func:`online_world` unsharded and
    at ``mesh_size``, each from a generator seeded 0: graph, moved counts,
    gate decisions, channel failures, lambdas, the exchanged data's digest
    and the FL global parameters, per tag ("base", "mesh<K>")."""
    from repro_torch.core.pipeline import run_pipeline
    device = resolve_device(device)
    xs, ys, ev = online_world()
    cfg = online_config().pipeline
    flcfg = FLConfig(total_iters=20, tau_a=10, batch_size=8, eval_every=10)
    out = {}
    for tag, rules in (("base", None),
                       (f"mesh{mesh_size}", make_rules(mesh_size, device))):
        gen = torch.Generator(device=device).manual_seed(0)
        res = run_pipeline(xs, ys, ONLINE_AE, cfg, generator=gen,
                           device=device, rules=rules)
        fl = fl_train(res.client_data, ONLINE_AE, flcfg, ev, generator=gen,
                      device=device, rules=rules)
        accept, cd = whole((res.exchange.accept, res.client_data), rules)
        out[tag] = {
            "in_edge": res.in_edge.cpu().numpy(),
            "moved": res.moved_counts, "fail": res.exchange.fail.cpu().numpy(),
            "accept": accept.cpu().numpy(),
            "lam_before": res.lam_before.cpu().numpy(),
            "lam_after": res.lam_after.cpu().numpy(),
            "data_digest": digest(cd), "gate_margin": _gate_margin(res),
            "fl_global": _flat(fl.global_params).numpy(),
            "eval_loss": fl.eval_loss}
    return out


def _run_summary(res) -> dict:
    return {"segments": [dataclasses.asdict(r) for r in res.trace.segments],
            "global": _flat(res.global_params).numpy(),
            "data_digest": digest((res.datasets, res.labels)),
            "in_edge": res.in_edge.cpu().numpy()}


def orchestrator_report(mesh_size: int, ckpt_dir: str,
                        device="cuda") -> dict:
    """``run_orchestrator`` on :func:`online_world` under ``burst-outage``
    from ``SeededDraws(5)``, per engine ("eager", "scan") unsharded and at
    ``mesh_size``; then at ``mesh_size`` a run killed at segment 2 (the
    scenario's preemption, checkpoints under ``ckpt_dir``) and resumed
    from its checkpoint, per engine. Returns each run's summary under
    ``<impl>_<tag>`` (tags "base", "mesh<K>", "resumed")."""
    from repro_torch.dynamics import (SeededDraws, get_scenario,
                                      run_orchestrator)
    from repro_torch.faults import Preempted
    device = resolve_device(device)
    xs, ys, ev = online_world()
    scn = get_scenario("burst-outage")
    killed = dataclasses.replace(scn, faults=dataclasses.replace(
        scn.faults, preempt_at=2))
    rules = make_rules(mesh_size, device)
    out = {}
    for impl in ("eager", "scan"):
        cfg = online_config(impl)
        for tag, r in (("base", None), (f"mesh{mesh_size}", rules)):
            res = run_orchestrator(xs, ys, ONLINE_AE, cfg, scn, ev,
                                   draws=SeededDraws(5, device),
                                   device=device, rules=r)
            out[f"{impl}_{tag}"] = _run_summary(res)
        ck = dataclasses.replace(cfg, checkpoint_dir=os.path.join(
            ckpt_dir, impl))
        try:
            run_orchestrator(xs, ys, ONLINE_AE, ck, killed, ev,
                             draws=SeededDraws(5, device), device=device,
                             rules=rules)
            raise AssertionError("the run was not preempted")
        except Preempted as e:
            if e.segment != 2:
                raise
        res = run_orchestrator(xs, ys, ONLINE_AE, ck, killed, ev,
                               draws=SeededDraws(5, device), device=device,
                               rules=rules, resume_from=ck.checkpoint_path)
        out[f"{impl}_resumed"] = _run_summary(res)
    return out


def online_reports(mesh_size: int, ckpt_dir: str, device="cuda") -> dict:
    """:func:`pipeline_report` and :func:`orchestrator_report` in one
    group."""
    return {"pipeline": pipeline_report(mesh_size, device),
            "orchestrator": orchestrator_report(mesh_size, ckpt_dir, device)}


def parity_reports(cfgs, mesh_size: int, device="cuda",
                   count: bool = False) -> list:
    """:func:`parity_report` for each config in turn."""
    return [parity_report(c, mesh_size, device, count) for c in cfgs]


# ---------------------------------------------------------------------------
# ranks on the host
# ---------------------------------------------------------------------------

def _child(rank: int, world: int, tmp: str, fn, args):
    torch.set_num_threads(1)
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(*args)
        if rank == 0:
            with open(os.path.join(tmp, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args):
    """Run ``fn(*args)`` on ``world`` spawned ranks of a gloo group (a
    ``file://`` store in a fresh temporary directory) and return rank 0's
    value, pickled through a file there. ``fn`` must be importable by the
    children (a module-level function)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_child, args=(world, d, fn, args), nprocs=world,
                           join=True, start_method="spawn")
        with open(os.path.join(d, "result.pkl"), "rb") as f:
            return pickle.load(f)


def spawn_parity_report(cfg, mesh_size: int, device="cpu",
                        count: bool = False):
    """:func:`parity_report` on ``mesh_size`` spawned host ranks (gloo);
    rank 0's report, or its list of reports when ``cfg`` is a sequence of
    configs (one spawn for all of them)."""
    if torch.device(device).type != "cpu":
        raise ValueError("spawned ranks run on the host (gloo); on the card "
                         "call parity_report in a one-rank group")
    if isinstance(cfg, LabConfig):
        return spawn(parity_report, mesh_size, cfg, mesh_size, device, count)
    return spawn(parity_reports, mesh_size, tuple(cfg), mesh_size, device,
                 count)


# ---------------------------------------------------------------------------
# the model plane on host ranks
# ---------------------------------------------------------------------------

# the smoke Llama's run: batch x prompt, decode steps, AdamW steps
PLANE_B, PLANE_S, PLANE_GEN, PLANE_STEPS = 4, 16, 4, 2
PLANE_WINDOW = 8      # the sliding config's window: a ring at prompt 16
# the recurrent configs' prompt: past recurrentgemma's 64-token local
# window (the ring wraps in the prefill and again while decoding), a
# ragged mLSTM chunk, and divisible by the model axis (act_seq_shard)
RECURRENT_S = 72
# the vision prompt: PLANE_IMG patches on Qwen2-VL's grid in rows of
# PLANE_GRID, then PLANE_S - PLANE_IMG text tokens (under act_seq_shard at
# model 4 the image rows span the first two ranks' parts of S)
PLANE_IMG, PLANE_GRID = 8, 4
RECORDED = {"all_gather_single": "all-gather",
            "all_gather_into_tensor": "all-gather",
            "reduce_scatter_single": "reduce-scatter",
            "reduce_scatter_tensor": "reduce-scatter",
            "all_reduce": "all-reduce"}


def make_model_rules(data: int, model: int, device="cuda"):
    """``ShardingRules`` over a (data, model) mesh of ``data * model``
    ranks: the process group's, or in a larger group one such mesh per
    ``data * model`` ranks under a leading "replica" axis (each replica
    computes the same step)."""
    from repro_torch.launch.mesh import make_host_mesh
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model == world:
        return sh.ShardingRules.default(make_host_mesh(model, device))
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    return sh.ShardingRules.default(init_device_mesh(
        dev.type, (world // (data * model), data, model),
        mesh_dim_names=("replica", "data", "model")))


@contextlib.contextmanager
def record_collectives(calls: Counter, nbytes: Counter):
    """Count every ``torch.distributed`` all-gather, reduce-scatter and
    all-reduce called inside, and the bytes of each one's result, by kind
    (the names of ``sharding.KINDS``)."""
    dist = torch.distributed
    saved = []
    for name, kind in RECORDED.items():
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _kind=kind, **kw):
            out = a[0] if a else kw.get("output", kw.get("tensor"))
            calls[_kind] += 1
            nbytes[_kind] += out.numel() * out.element_size()
            return _fn(*a, **kw)
        saved.append((name, fn))
        setattr(dist, name, wrapped)
    try:
        yield
    finally:
        for name, fn in saved:
            setattr(dist, name, fn)


# the dense, MoE, recurrent and frontend configs' names in ``plane_configs``
DENSE = ("base", "sliding", "seq")
MOE = ("moe_gather", "moe_einsum", "moe_grouped_seq")
RECURRENT = ("recurrentgemma", "xlstm", "recurrentgemma_seq", "xlstm_seq")
FRONTEND = ("vlm", "audio", "vlm_seq", "audio_seq")
# every family on a model axis that divides none of its widths
# (``UNEVEN_S``-position prompts: the cache of UNEVEN_S + PLANE_GEN slots)
UNEVEN = DENSE + MOE + RECURRENT + FRONTEND
UNEVEN_S = 61


def plane_configs():
    """The smoke Llama in float32, its sliding-window variant (window
    ``PLANE_WINDOW``: the prompt wraps the ring) and its ``act_seq_shard``
    variant; the smoke qwen2-moe in float32 (4 experts top-2, one shared
    expert of 256 columns) three ways:

      * ``moe_gather``: 3 experts (the d_ff layout above one rank: 3 does
        not divide the model axis), the gather dispatch with no group size
        (one group of every token of the batch, across the data ranks) and
        capacity factor 0.5, so choices drop;
      * ``moe_einsum``: the einsum dispatch (a group is a batch row) at
        capacity factor 0.5; expert-parallel above one rank;
      * ``moe_grouped_seq``: the gather dispatch in groups of 16 tokens
        (a train or prefill group inside a rank's 32 tokens at data 2, a
        decode step's 4 tokens one group across the data ranks) under
        ``act_seq_shard``: ``perf``'s ``moe_gather_grouped_seq`` shape;

    the recurrent families in float32, each also under ``act_seq_shard``
    (``<name>_seq``): the smoke recurrentgemma at 3 layers, one (rglru,
    rglru, local_attn) unit (2 query heads, 1 KV head, local window 64),
    and the smoke xlstm (one mLSTM and one sLSTM block), and
    ``recurrentgemma_250``, the 3-layer one with 250 RG-LRU channels; and
    the frontends
    in float32, each also under ``act_seq_shard``: the smoke qwen2-vl
    (``vlm``: 4 query heads, 2 KV heads, so model 4 takes the KV_SEQ
    cache; projector width 128; M-RoPE) and the smoke musicgen
    (``audio``: 2 codebooks of 512)."""
    import dataclasses as dc
    from repro_torch.configs import get_smoke_config
    base = dc.replace(get_smoke_config("llama3.2-1b"), dtype="float32")
    moe = dc.replace(get_smoke_config("qwen2-moe-a2.7b"), dtype="float32")
    rg = dc.replace(get_smoke_config("recurrentgemma-2b"), dtype="float32",
                    n_layers=3)
    xl = dc.replace(get_smoke_config("xlstm-125m"), dtype="float32")
    vlm = dc.replace(get_smoke_config("qwen2-vl-72b"), dtype="float32")
    audio = dc.replace(get_smoke_config("musicgen-medium"), dtype="float32")
    return {"base": base,
            "recurrentgemma": rg, "xlstm": xl,
            "recurrentgemma_seq": dc.replace(rg, act_seq_shard=True),
            "recurrentgemma_250": dc.replace(rg, rglru_d_rnn=250),
            "xlstm_seq": dc.replace(xl, act_seq_shard=True),
            "vlm": vlm, "audio": audio,
            "vlm_seq": dc.replace(vlm, act_seq_shard=True),
            "audio_seq": dc.replace(audio, act_seq_shard=True),
            "sliding": dc.replace(base, attention="sliding",
                                  window=PLANE_WINDOW),
            "seq": dc.replace(base, act_seq_shard=True),
            "moe_gather": dc.replace(moe, n_experts=3, moe_dispatch="gather",
                                     capacity_factor=0.5),
            "moe_einsum": dc.replace(moe, capacity_factor=0.5),
            "moe_grouped_seq": dc.replace(moe, moe_dispatch="gather",
                                          moe_group_size=16,
                                          act_seq_shard=True)}


def plane_prompt_len(cfg) -> int:
    """The lab's prompt length: ``RECURRENT_S`` for the recurrent
    families, else ``PLANE_S``."""
    return RECURRENT_S if cfg.family in ("ssm", "hybrid") else PLANE_S


def grid_positions(b: int, n_img: int, n_txt: int, grid_w: int):
    """Qwen2-VL's (t, h, w) positions (b, n_img + n_txt, 3) of one image of
    ``n_img`` patches in rows of ``grid_w`` (patch i at (0, i // grid_w,
    i % grid_w)) followed by ``n_txt`` text tokens, each at one past the
    grid's largest index plus j in all three streams."""
    i = torch.arange(n_img)
    img = torch.stack([torch.zeros_like(i), i // grid_w, i % grid_w], -1)
    txt = (int(img.max()) + 1 + torch.arange(n_txt))[:, None].expand(n_txt, 3)
    return torch.cat([img, txt])[None].expand(b, n_img + n_txt, 3)


def plane_inputs(cfg, seed: int = 0, s: int | None = None):
    """Whole parameters, prompt and Gumbel noise from seeded host
    generators (the same on every rank). The prompt is a (B, S) token
    tensor (S ``s``, by default ``plane_prompt_len``), or a frontend's
    batch: vision ``PLANE_IMG`` patch embeddings,
    the text tokens, ``grid_positions`` and (B, S) labels; audio (B, S,
    nq) codes (their own labels), whose noise is (gen, B, 1, nq, V)."""
    from repro_torch.launch.serve import gumbel_noise
    from repro_torch.models.registry import build_model
    g = torch.Generator().manual_seed(seed)
    params = build_model(cfg).init(g, device="cpu")
    b, v = PLANE_B, cfg.vocab_size
    s = s or plane_prompt_len(cfg)
    nq = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    if cfg.frontend == "audio_codec":
        prompt = {"codes": torch.randint(0, v, (b, s) + nq, generator=g)}
    elif cfg.frontend == "vision_stub":
        prompt = {
            "embeds": torch.randn((b, PLANE_IMG, cfg.frontend_dim),
                                  generator=g),
            "tokens": torch.randint(0, v, (b, s - PLANE_IMG), generator=g),
            "positions": grid_positions(b, PLANE_IMG, s - PLANE_IMG,
                                        PLANE_GRID),
            "labels": torch.randint(0, v, (b, s), generator=g)}
    else:
        prompt = torch.randint(0, v, (b, s), generator=g)
    noise = gumbel_noise(g, (PLANE_GEN, b, 1) + nq + (v,))
    return params, prompt, noise


def prefill_batch(prompt) -> dict:
    """A ``plane_inputs`` prompt as the prefill's batch."""
    if isinstance(prompt, torch.Tensor):
        return {"tokens": prompt}
    return {k: x for k, x in prompt.items() if k != "labels"}


def train_batch(prompt) -> dict:
    """A ``plane_inputs`` prompt as a train step's batch (tokens or codes
    their own labels)."""
    if isinstance(prompt, torch.Tensor):
        return {"tokens": prompt, "labels": prompt}
    return dict(prompt, labels=prompt.get("labels", prompt.get("codes")))


def _serve_run(model, params, prompt, noise, rules):
    """Prefill, then ``PLANE_GEN`` tokens sampled with ``noise`` (each
    rank's rows), one decode step after each; returns (the logits of every
    step, the tokens, per-step collectives {step: (calls, bytes)})."""
    from repro_torch.launch.serve import sample
    from repro_torch.models.transformer import batch_rows_len
    batch = prefill_batch(prompt)
    rows = _rows(batch, rules)
    noise = _rows(noise.transpose(0, 1), rules).transpose(0, 1)
    feed = "codes" if model.cfg.n_codebooks else "token"
    counts = {}
    with _recording(counts, "prefill", rules):
        logits, cache = model.prefill(
            params, rows, max_len=batch_rows_len(batch)[1] + PLANE_GEN,
            rules=rules, global_batch=PLANE_B)
    outs, tokens = [logits], []
    for i in range(PLANE_GEN):
        tok = sample(logits, 1.0, noise[i])
        tokens.append(tok)
        if i == PLANE_GEN - 1:
            break
        with _recording(counts, "decode", rules):
            logits, cache = model.decode(params, cache, {feed: tok},
                                         rules=rules, global_batch=PLANE_B)
        outs.append(logits)
    return torch.cat(outs, 1), torch.cat(tokens, 1), counts


def _train_run(model, params, prompt, rules):
    """``PLANE_STEPS`` donated AdamW steps on the whole batch's rows of this
    rank; returns (losses, the final parameters, per-step collectives)."""
    from repro_torch import optim
    from repro_torch.configs import TrainConfig
    from repro_torch.models.registry import make_train_step
    tc = TrainConfig(warmup_steps=1, total_steps=10)
    step = make_train_step(model, tc, donate=True, rules=rules)
    params = sh._map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                     else x, params)
    state = optim.init_opt_state(params, tc.optimizer)
    rows = _rows(train_batch(prompt), rules)
    losses, counts = [], {}
    for _ in range(PLANE_STEPS):
        with _recording(counts, "train", rules):
            params, state, m = step(params, state, rows,
                                    global_batch=PLANE_B)
        losses.append(m["loss"])
    return torch.stack(losses), params, counts


GRAD_FLOOR = 1e-6


def _grads(model, params, prompt, rules):
    """The first train step's gradients as the step uses them (summed over
    the axes ``transformer.grad_sum_axes`` names)."""
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.models.transformer import batch_rows_len
    batch = _rows(train_batch(prompt), rules)
    _, grads = cm.value_and_grad(
        lambda p: model.loss_fn(p, batch, remat=True, rules=rules,
                                global_batch=PLANE_B)[0],
        params)
    if rules is not None:
        grads, _ = registry._plane_grads(model, sh.ModelPlane(rules), grads,
                                         batch_rows_len(batch)[1])
    return grads


@contextlib.contextmanager
def _recording(counts: dict, step: str, rules):
    calls, nbytes = Counter(), Counter()
    if rules is None:
        yield
        return
    with record_collectives(calls, nbytes):
        yield
    counts[step] = (dict(calls), dict(nbytes))


def _rows(x, rules):
    """This rank's rows of a whole batch (dim 0 over the data axes), a
    tensor or a dict of them."""
    if rules is None:
        return x
    if isinstance(x, dict):
        return {k: _rows(v, rules) for k, v in x.items()}
    return sh.place_params(x, (sh.BATCH,) + (None,) * (x.dim() - 1), rules)


def _whole_rows(x, rules):
    if rules is None:
        return x
    full = torch.empty((PLANE_B,) + tuple(x.shape[1:]), device="meta")
    return sh.whole_params(x, (sh.BATCH,) + (None,) * (x.dim() - 1), full,
                           rules)


def _max_over_ranks(v: float) -> float:
    t = torch.tensor([v], dtype=torch.float64)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t)


def _gather_ints(v: int) -> list:
    """``v`` from every rank of the group, in rank order."""
    out = [torch.zeros(1, dtype=torch.int64)
           for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(out, torch.tensor([v]))
    return [int(t) for t in out]


def _sum_over_ranks(v: int) -> int:
    t = torch.tensor([v], dtype=torch.int64)
    torch.distributed.all_reduce(t)
    return int(t)


@contextlib.contextmanager
def router_margins(seen: list, k: int):
    """Records in ``seen`` the smallest gap between the k-th and the
    (k+1)-th router probability of each MoE layer run inside: a top-k set
    (and so every capacity rank) is fixed by probabilities that move less
    than it."""
    from repro_torch.models import moe
    probs_fn = moe.router_probs

    def recording(params, x2d):
        probs = probs_fn(params, x2d)
        top = torch.sort(probs.detach(), -1, descending=True)[0]
        seen.append(float(torch.min(top[:, k - 1] - top[:, k])))
        return probs
    moe.router_probs = recording
    try:
        yield
    finally:
        moe.router_probs = probs_fn


@contextlib.contextmanager
def dropped_across(tally: list):
    """Appends to ``tally``, per MoE layer run whose groups span data
    ranks, the choices this rank drops only for the lower ranks' choices
    in their groups: ranked below the capacity among its own, at or above
    it after the offset."""
    from repro_torch.models import moe
    decide, dispatch = moe.decide, moe._gather_dispatch

    def counted(offsets, cap):
        def fn(counts):
            off = offsets(counts)
            kept = torch.clamp_max(counts, cap)
            lost = torch.clamp_min(kept - torch.clamp_min(cap - off, 0), 0)
            tally.append(int(torch.sum(torch.where(off > 0, lost, 0))))
            return off
        return fn

    def decide_(probs, cfg, tokens=None, offsets=None):
        if offsets is not None:
            offsets = counted(offsets, moe.capacity(
                cfg.experts_per_token, tokens or probs.shape[1],
                cfg.capacity_factor, cfg.n_experts))
        return decide(probs, cfg, tokens, offsets)

    def dispatch_(params, xt, cfg, cap, part=None, xe=None):
        if part is not None and part.offsets is not None:
            part = part._replace(offsets=counted(part.offsets, cap))
        return dispatch(params, xt, cfg, cap, part, xe)
    moe.decide, moe._gather_dispatch = decide_, dispatch_
    try:
        yield
    finally:
        moe.decide, moe._gather_dispatch = decide, dispatch


def _diff(a, b) -> float:
    return max(float(torch.max(torch.abs(x.double() - y.double())))
               for x, y in zip(sh._leaves(a), sh._leaves(b)))


def cache_layout(cfg, m: int, cap: int) -> str:
    """Where a model axis of ``m`` ranks puts ``cfg``'s attention cache
    of capacity ``cap`` (its global attention's, else its local one's):
    "heads" (m divides the KV heads), "slots" (over its slots) or
    "whole" (on every rank); None for a config with no attention."""
    from repro_torch.models import transformer as tf
    kinds = [k for k in ("attn", "local_attn") if k in cfg.layer_kinds]
    if not kinds:
        return None
    if cfg.n_kv_heads % m == 0:
        return "heads"
    kind = kinds[0]
    return "whole" if tf.attn_cache_len(cfg, kind, cap) % m else "slots"


def plane_mesh_report(data: int, model: int, jax_params=None,
                      ref=None, names=DENSE, s: int | None = None) -> dict:
    """One (data, model) mesh on every rank of the group: for each config
    of ``names`` (``plane_configs``) its prefill, decode, sampling and
    donated AdamW steps with the rules and with ``rules=None`` (the
    sliding config serves only; the dense ``act_seq_shard`` config runs
    above one model rank only and is held to the plain config's runs, as
    the flag changes nothing without rules). Returns the largest
    differences over every rank, bit equality, the collectives of each
    step by kind (``record_collectives``), which paths the mesh took and,
    for the MoE configs, the smallest router margin of the ``rules=None``
    runs and the choices dropped only for a lower data rank's (summed over
    the ranks); with ``jax_params`` ({config name: a numpy tree of the
    reference's layout}) also each such config's prefill logits and first
    loss from those parameters (``convert.lm_params``), whole, keyed
    ``<name>_jax_...``. A config ``<name>_seq`` other than an MoE one is
    held to ``<name>``'s ``rules=None`` runs. ``ref`` keeps the
    ``rules=None`` runs for the next mesh. With ``s`` every prompt has
    ``s`` positions (under ``act_seq_shard`` the most at most ``s`` that
    the model axis divides, so the flag takes effect), the seq configs
    held to their own ``rules=None`` runs, and the report gives each
    config's ``<name>_paths``: the recurrent blocks that run whole on
    every model rank and its attention cache's layout
    (:func:`cache_layout`)."""
    from repro_torch import convert
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tf
    from repro_torch.models.registry import build_model
    cfgs = plane_configs()
    rules = make_model_rules(data, model, "cpu")
    plane = sh.ModelPlane(rules)
    out = {"mesh": (data, model)}
    ref = {} if ref is None else ref
    for name in names:
        cfg = cfgs[name]
        if cfg.act_seq_shard and plane.m == 1 and not cfg.is_moe:
            continue
        mdl = build_model(cfg)
        sl = s and (s - s % plane.m if cfg.act_seq_shard else s)
        params, prompt, noise = plane_inputs(cfg, s=sl)
        logical = mdl.param_logical()
        placed = sh.place_params(params, logical, rules)
        key = "base" if name == "seq" else name.removesuffix("_seq") \
            if not cfg.is_moe else name
        if s:
            key = name
            out[f"{name}_paths"] = {
                "whole": sorted(tf._Plan(cfg, plane, "train", sl).whole),
                "cache": cache_layout(cfg, plane.m, sl + PLANE_GEN)}
        margins, dropped = [], []
        with router_margins(margins, cfg.experts_per_token):
            if key not in ref:
                ref[key] = {"serve": _serve_run(mdl, params, prompt, noise,
                                                None)}
            if name != "sliding" and "train" not in ref[key]:
                ref[key]["train"] = _train_run(mdl, params, prompt, None)
                ref[key]["grads"] = _grads(mdl, params, prompt, None)
        if cfg.is_moe:
            out[f"{name}_margin"] = min(margins) if margins else \
                ref[key].get("margin")
            ref[key]["margin"] = out[f"{name}_margin"]
        base_logits, base_tok, _ = ref[key]["serve"]
        with dropped_across(dropped):
            logits, tok, counts = _serve_run(mdl, placed, prompt, noise, rules)
        logits, tok = _whole_rows(logits, rules), _whole_rows(tok, rules)
        out[f"{name}_logits"] = _max_over_ranks(_diff(logits, base_logits))
        out[f"{name}_tokens_equal"] = bool(torch.equal(tok, base_tok))
        out[f"{name}_logits_bitwise"] = bool(torch.equal(logits,
                                                         base_logits))
        out[f"{name}_serve_counts"] = counts
        if name == "sliding":
            continue
        with dropped_across(dropped):
            grads = sh.whole_params(_grads(mdl, placed, prompt, rules),
                                    logical, params, rules)
            losses, trained, counts = _train_run(mdl, placed, prompt, rules)
        if cfg.is_moe:
            out[f"{name}_dropped_across"] = _sum_over_ranks(sum(dropped))
        trained = sh.whole_params(trained, logical, params, rules)
        base_losses, base_params, _ = ref[key]["train"]
        base_grads = ref[key]["grads"]
        out[f"{name}_losses"] = losses.tolist()
        out[f"{name}_loss_diff"] = _max_over_ranks(_diff(losses, base_losses))
        out[f"{name}_grad_diff"] = _max_over_ranks(_diff(grads, base_grads))
        out[f"{name}_grad_diffs"] = {
            "/".join(map(str, path)): _max_over_ranks(_diff([a], [b]))
            for (path, _), a, b in zip(cm.spec_paths(mdl.specs),
                                       cm.tree_leaves(grads),
                                       cm.tree_leaves(base_grads))}
        out[f"{name}_param_diff"] = _max_over_ranks(_diff(trained,
                                                          base_params))
        # AdamW moves each entry by about lr * sign(g): where the gradient
        # is at float32 noise level its update is not determined by it
        floor = [g.abs() > GRAD_FLOOR for g in cm.tree_leaves(base_grads)]
        out[f"{name}_param_diff_above_floor"] = _max_over_ranks(max(
            float(torch.where(f, (a - b).abs(), 0).max()) for a, b, f in zip(
                cm.tree_leaves(trained), cm.tree_leaves(base_params), floor)))
        out[f"{name}_train_bitwise"] = bool(
            torch.equal(losses, base_losses) and all(
                torch.equal(a, b) for a, b in zip(cm.tree_leaves(trained),
                                                  cm.tree_leaves(base_params))))
        out[f"{name}_train_counts"] = counts
    if not s:
        out["paths"] = _lab_paths(cfgs, plane, names)
        if "base" in names:
            out["positions"] = positions_report(rules, ref)
    for name, jp in (jax_params or {}).items():
        cfg = cfgs[name]
        mdl = build_model(cfg)
        local = convert.lm_params(jp, rules=rules,
                                  logical=mdl.param_logical())
        _, prompt, _ = plane_inputs(cfg, s=s)
        margins = []
        with router_margins(margins, cfg.experts_per_token):
            logits, _ = mdl.prefill(local, _rows(prefill_batch(prompt), rules),
                                    rules=rules, global_batch=PLANE_B)
            loss, _ = mdl.loss_fn(local, _rows(train_batch(prompt), rules),
                                  rules=rules, global_batch=PLANE_B)
        out[f"{name}_jax_prefill_logits"] = _whole_rows(logits, rules).numpy()
        out[f"{name}_jax_loss"] = float(loss)
        if cfg.is_moe:
            out[f"{name}_jax_margin"] = -_max_over_ranks(-min(margins))
    return out


def _lab_paths(cfgs, plane, names) -> dict:
    """Which paths the lab's configs ``names`` take on ``plane``'s mesh."""
    from repro_torch.models import transformer as tf
    m = plane.m
    if "base" in names:
        base = cfgs["base"]
        hd = base.head_dim
        return {
            "half_head": (base.n_kv_heads * hd // m) % hd != 0,
            "kv_seq": base.n_kv_heads % m != 0,
            "ring": cfgs["sliding"].window < PLANE_S + PLANE_GEN}
    if "recurrentgemma" in names:
        rg = cfgs["recurrentgemma"]
        h0, h1 = tf._Plan(rg, plane, "train", RECURRENT_S).heads
        return {
            "kv_seq": rg.n_kv_heads % m != 0,
            "ring": rg.local_window < RECURRENT_S,
            "heads": sorted(_gather_ints(h1 - h0)),
            "slstm_heads_split": cfgs["xlstm"].n_heads % m == 0}
    if "vlm" in names:
        plan = tf._Plan(cfgs["audio"], plane, "train", PLANE_S)
        return {
            "kv_seq": cfgs["vlm"].n_kv_heads % m != 0,
            # the model ranks whose part of S holds image rows under seq
            "image_ranks": -(-PLANE_IMG * m // PLANE_S),
            "head_ranges": len(plan._need(None, ("head",), None)[1])}
    return {name: "experts" if tf._Plan(cfgs[name], plane, "train",
                                        PLANE_S).moe_ep else "d_ff"
            for name in names}


def positions_report(rules, ref=None) -> dict:
    """The smoke Llama's prefill logits and loss with the batch's positions
    3 t + 5 under ``rules`` against ``rules=None``'s with the same
    positions (the largest differences over the ranks, and bit equality),
    and how far those logits are from the token indices' (the positions
    reach the result). ``ref`` keeps the ``rules=None`` runs."""
    from repro_torch.models.registry import build_model
    cfg = plane_configs()["base"]
    mdl = build_model(cfg)
    params, toks, _ = plane_inputs(cfg)
    pos = (3 * torch.arange(toks.shape[1]) + 5)[None].expand(toks.shape)
    batch = {"tokens": toks, "positions": pos, "labels": toks}
    ref = {} if ref is None else ref

    def run(p, b, r):
        logits, _ = mdl.prefill(p, {k: b[k] for k in ("tokens", "positions")
                                    if k in b}, rules=r, global_batch=PLANE_B)
        loss, _ = mdl.loss_fn(p, b, rules=r, global_batch=PLANE_B)
        return logits, loss
    if "positions" not in ref:
        ref["positions"] = run(params, batch, None), run(
            params, {"tokens": toks, "labels": toks}, None)[0]
    (logits0, loss0), indices = ref["positions"]
    placed = sh.place_params(params, mdl.param_logical(), rules)
    logits, loss = run(placed, _rows(batch, rules), rules)
    logits = _whole_rows(logits, rules)
    return {"logits": _max_over_ranks(_diff(logits, logits0)),
            "loss": _max_over_ranks(abs(float(loss - loss0))),
            "bitwise": bool(torch.equal(logits, logits0)
                            and torch.equal(loss, loss0)),
            "from_indices": _diff(logits0, indices)}


def plane_reports(meshes, jax_params=None, names=DENSE,
                  s: int | None = None) -> list:
    """:func:`plane_mesh_report` for each (data, model) mesh in turn; the
    JAX parameters go to the (2, 2) mesh's, or to the only mesh's."""
    ref = {}
    return [plane_mesh_report(
        d, m, jax_params if (d, m) == (2, 2) or len(meshes) == 1 else None,
        ref, names, s) for d, m in meshes]


# the grouped MoE whose groups straddle data ranks: SEGMENTS_B rows of
# PLANE_S tokens over SEGMENTS_B data ranks in groups of SEGMENTS_GROUP
SEGMENTS_B, SEGMENTS_GROUP = 3, 24


def moe_segments_report() -> dict:
    """The smoke qwen2-moe (float32, capacity factor 0.5) with both
    dispatches in groups of ``SEGMENTS_GROUP`` tokens, ``SEGMENTS_B`` rows
    of ``PLANE_S`` tokens on a (``SEGMENTS_B``, 1) mesh: each rank's 16
    tokens neither tile nor are tiled by the 24-token groups, so a rank
    routes segments of 8, a group's across two ranks. The prefill's and a
    decode step's logits, the loss and every leaf's gradient against
    ``rules=None``'s (the largest differences over the ranks), the
    smallest router margin of the ``rules=None`` runs and the choices
    dropped only for a lower rank's (summed over the ranks)."""
    import dataclasses as dc
    from repro_torch.models import common as cm
    from repro_torch.models import registry
    from repro_torch.models.registry import build_model
    b, s = SEGMENTS_B, PLANE_S
    rules = make_model_rules(b, 1, "cpu")
    out = {}
    for dispatch in ("gather", "einsum"):
        cfg = dc.replace(plane_configs()["moe_einsum"], moe_dispatch=dispatch,
                         moe_group_size=SEGMENTS_GROUP)
        mdl = build_model(cfg)
        params, toks, _ = plane_inputs(cfg)
        toks = toks[:b]
        placed = sh.place_params(params, mdl.param_logical(), rules)
        batch = {"tokens": toks, "labels": toks}

        def run(p, r):
            rows = _rows(batch, r)
            logits, cache = mdl.prefill(p, {"tokens": rows["tokens"]},
                                        max_len=s + 1, rules=r,
                                        global_batch=b)
            step, _ = mdl.decode(p, cache, {"token": rows["tokens"][:, -1:]},
                                 rules=r, global_batch=b)
            loss, grads = cm.value_and_grad(
                lambda q: mdl.loss_fn(q, rows, rules=r, global_batch=b)[0],
                p)
            if r is not None:
                grads, _ = registry._plane_grads(mdl, sh.ModelPlane(r), grads,
                                                 s)
            return torch.cat([logits, step], 1), loss, grads
        margins, dropped = [], []
        with router_margins(margins, cfg.experts_per_token):
            logits0, loss0, grads0 = run(params, None)
        with dropped_across(dropped):
            logits, loss, grads = run(placed, rules)
        full = lambda x: sh.whole_params(
            x, (sh.BATCH,) + (None,) * (x.dim() - 1),
            torch.empty((b,) + tuple(x.shape[1:]), device="meta"), rules)
        grads = sh.whole_params(grads, mdl.param_logical(), params, rules)
        out[dispatch] = {
            "logits": _max_over_ranks(_diff(full(logits), logits0)),
            "loss": _max_over_ranks(abs(float(loss - loss0))),
            "grads": _max_over_ranks(_diff(grads, grads0)),
            "margin": min(margins),
            "dropped_across": _sum_over_ranks(sum(dropped))}
    return out


def replicated_batch_report(name: str, data: int = 2) -> dict:
    """One batch row of config ``name`` on a (``data``, 1) mesh, where the
    data axes do not divide the batch and every data rank holds it whole
    (``launch.specs.place_batch``): the prefill's and a decode step's
    logits and a plain train step's loss and aux loss against
    ``rules=None``'s, the largest differences over the ranks, with the
    batch's rows (``global_batch=1``) and, to show what they fix, the
    logits with the rows taken as split (``global_batch=data``)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.specs import place_batch
    from repro_torch.models.registry import build_model, make_train_step
    from repro_torch import optim
    cfg = plane_configs()[name]
    mdl = build_model(cfg)
    params, toks, _ = plane_inputs(cfg)
    row = toks[:1]
    rules = make_model_rules(data, 1, "cpu")
    placed = sh.place_params(params, mdl.param_logical(), rules)
    batch = place_batch({"tokens": row}, rules)

    def serve(p, r, **kw):
        logits, cache = mdl.prefill(p, batch if r else {"tokens": row},
                                    max_len=row.shape[1] + 1, rules=r, **kw)
        step, _ = mdl.decode(p, cache, {"token": row[:, -1:]}, rules=r,
                             **kw)
        return torch.cat([logits, step], 1)

    def train(p, r, **kw):
        tc = TrainConfig(warmup_steps=1, total_steps=10)
        step = make_train_step(mdl, tc, rules=r)
        state = optim.init_opt_state(p, tc.optimizer)
        _, _, m = step(p, state, {"tokens": row, "labels": row}, **kw)
        return m["loss"], m["aux"]

    base = serve(params, None)
    loss, aux = train(params, None)
    got = serve(placed, rules, global_batch=1)
    loss_r, aux_r = train(placed, rules, global_batch=1)
    return {"replicated": rules.spec((sh.BATCH,), (1,))[0] is None,
            "logits": _max_over_ranks(_diff(got, base)),
            "loss": _max_over_ranks(abs(float(loss_r - loss))),
            "aux": _max_over_ranks(abs(float(aux_r - aux))),
            "aux_value": float(aux),
            "logits_as_split": _max_over_ranks(
                _diff(serve(placed, rules, global_batch=data), base))}


def plane_world(meshes, jax_params=None, pod_lab=None,
                names=DENSE, replicated=None, s=None, uneven=None,
                segments=False) -> dict:
    """Every rank of one spawned group: :func:`plane_reports` of the
    configs ``names`` over ``meshes`` (prompts of ``s`` positions when
    given); with ``pod_lab`` (a :class:`LabConfig`), the client plane's
    :func:`parity_report` on a (pod 2, data 2) mesh, counted; with
    ``replicated`` (a config name), its :func:`replicated_batch_report`;
    with ``uneven`` ((data, model), names, s), :func:`plane_mesh_report`
    of those configs there with ``s``-position prompts; with
    ``segments``, :func:`moe_segments_report`."""
    out = {"plane": plane_reports(meshes, jax_params, names, s)}
    if uneven is not None:
        (data, model), u_names, u_s = uneven
        out["uneven"] = plane_mesh_report(data, model, names=u_names, s=u_s)
    if segments:
        out["segments"] = moe_segments_report()
    if pod_lab is not None:
        out["pod"] = parity_report(pod_lab, (2, 2), "cpu", count=True)
    if replicated is not None:
        out["replicated"] = replicated_batch_report(replicated)
    return out
