"""Online orchestrator: interleave FL training with graph re-discovery
(mirrors the eager engine of ``repro.dynamics.orchestrator``).

    segment 0:  initial discovery + exchange (the one-shot pipeline, fed
                the environment's RSS), then ``iters_per_segment`` FL iters
    segment s:  advance the environment (fading / mobility / churn, then
                the scenario's faults) -> optionally re-discover the graph
                with a short warm-started RL burst and re-exchange over the
                new links -> resume FL from the previous segment's carry

Three modes: ``"oneshot"`` never re-discovers (the paper's protocol in a
moving world); ``"online"`` runs a warm-started RL burst every
``rediscover_every`` segments and re-exchanges over the new graph;
``"uniform"`` re-draws a uniform random graph on the same cadence.

Every draw comes from one draw source (``draws``, default
:class:`~repro_torch.dynamics.draws.SeededDraws`), site by site as the run
reaches it (see that module). Under the ``static`` scenario in mode
``"oneshot"`` the run is exactly ``run_pipeline`` + ``fl_train`` on the
source's pipeline, FL-init and minibatch draws.

Two segment engines (``OrchestratorConfig.segment_impl``):

``"eager"``  one Python iteration per segment, any exchange configuration;
    the scan engine's oracle. The host reads inside a segment are the host
    reserve selector's cluster ids and, with retries on, the (N,) fail mask
    of ``ExchangeResult.failed_links``; each segment ends with one device
    sync that times it.
``"scan"``   segment 0 runs eagerly; segments [1, n) run in chunks
    (:func:`_chunk_bounds`: a chunk ends where host work is due, a
    checkpoint, a retry offer and drain, a simulated preemption, or the
    run's end). A chunk is a static-shape loop over its segments that never
    reads the device from the host: its draws are all taken before it
    starts, reserves are selected on the device, the exchange keeps the cap
    (``overflow="drop"``), and the reference's ``lax.cond`` on the
    rediscovery and eval flags, which the config fixes, are Python ``if``s.
    One device sync ends each chunk. Its results differ from the eager
    engine's by design in one place: a retry drains at the chunk boundary,
    one segment later than in the eager engine.

Device residency: the client data stack, channel state, FL carry, graph and
availability stay on the run's device; each segment's metrics are device
tensors until one host read after the last segment.

Observability (``repro_torch.obs``): the eager engine carries the
reference's spans (``orchestrator``, ``segment``, ``env-step``,
``fault-inject``, ``re-cluster``, ``re-discover``, ``re-exchange``,
``retry-exchange``, ``fl-segment``, ``checkpoint-save``/``-load``,
``metrics-materialize``) and ``retry-outcome`` marks; the scan engine
records one ``scan-chunk`` span per chunk, whose helpers are the span-free
impls, so no named span sits inside a chunk, as in the reference. The one
counted transfer is :func:`_read_all`'s.

Fault tolerance (``repro_torch.faults``): a scenario's ``FaultPlan`` is
overlaid onto the environment from segment 1 on. With
``cfg.checkpoint_dir`` set, the run state is written atomically at segment
boundaries and a killed run resumes bit-identically through
``run_orchestrator(..., resume_from=path)``. With ``cfg.retry.enabled``,
failed live links re-offer through a bounded backoff queue; retries ride
the re-discovery cadence (they need fresh cluster assignments).

Sharding (``rules``, both engines): the client stack, the RL state's agent
rows and the FL carry's client trees are placed over the mesh, and each
stage runs its own collectives (``repro_torch.sharding``); the
environment, trust, P_D, the graph and every segment metric are whole on
every rank, so ``_read_all`` still reads one transfer. A checkpoint is
written by rank 0 from the gathered state, and a resume places it again.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch import sharding as sh
from repro_torch.core import exchange as ex
from repro_torch.core import qlearning as ql
from repro_torch.core.batching import ClientData, as_client_data, \
    shard_client_data
from repro_torch.core.channel import failure_prob
from repro_torch.core.pipeline import (PipelineConfig, _cluster_impl,
                                       cluster_clients, link_rewards,
                                       run_pipeline)
from repro_torch.dynamics.draws import SeededDraws
from repro_torch.dynamics.environment import EnvState, env_init, env_step
from repro_torch.dynamics.metrics import (PendingSegment, SegmentRecord,
                                          Trace, delivery_stats_dev,
                                          link_churn_dev, realized_delivery,
                                          realized_delivery_dev)
from repro_torch.dynamics.runstate import (RunState, load_run_state,
                                           save_run_state)
from repro_torch.dynamics.scenarios import get_scenario
from repro_torch.faults import (Preempted, RetryPolicy, apply_availability,
                                apply_pfail)
from repro_torch.faults.retry import RetryQueue
from repro_torch.fl.trainer import (FLConfig, _fl_rounds, eval_global_loss,
                                    fl_train)
from repro_torch.obs.counters import device_get

MODES = ("oneshot", "online", "uniform")
SEGMENT_IMPLS = ("eager", "scan")

CHECKPOINT_NAME = "ckpt_latest.npz"


@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    n_segments: int = 5
    iters_per_segment: int = 100       # FL iterations per segment
    mode: str = "online"               # see MODES
    rediscover_every: int = 1          # segments between re-discoveries
    burst_episodes: int = 150          # RL episodes per warm-started burst
    exchange_on_rediscover: bool = True
    pipeline: PipelineConfig = dataclasses.field(
        default_factory=PipelineConfig)
    fl: FLConfig = dataclasses.field(default_factory=FLConfig)
    # fl.total_iters is derived (n_segments * iters_per_segment); the field
    # in `fl` is ignored so presets can share one FLConfig.
    # fault-tolerance plane (all off by default):
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    checkpoint_dir: Optional[str] = None   # None = no checkpointing
    checkpoint_every: int = 1              # segments between checkpoints
    # "eager" (one Python iteration per segment, the oracle) or "scan"
    # (segments [1, n) in chunks that never read the device; needs, with
    # re-exchange on, method "batched", overflow "drop" and
    # reserve_selector "device")
    segment_impl: str = "eager"

    @property
    def total_iters(self) -> int:
        return self.n_segments * self.iters_per_segment

    @property
    def checkpoint_path(self) -> Optional[str]:
        if self.checkpoint_dir is None:
            return None
        return os.path.join(self.checkpoint_dir, CHECKPOINT_NAME)


class OrchestratorResult(NamedTuple):
    trace: Trace
    global_params: dict
    carry: object                  # final FLCarry
    in_edge: torch.Tensor          # graph in force at the end
    env: EnvState                  # final environment
    datasets: list                 # post-all-exchanges client data
    labels: Optional[list]
    eval_iters: np.ndarray         # concatenated fl_train eval schedule
    eval_loss: np.ndarray
    client_data: Optional[ClientData] = None   # the final client stack
    # seconds of each segment run by this call, each ended by a device sync
    # (the first one's include the pipeline, or the checkpoint load)
    segment_seconds: tuple = ()
    # per segment, seconds per stage: on the card the stream's time between
    # CUDA events recorded at the stage boundaries, on the host the host
    # clock (they sum to the segment's seconds less the host's lead)
    stage_seconds: tuple = ()
    # scan engine: (first segment, end segment, seconds) of each chunk, each
    # ended by one device sync
    chunk_seconds: tuple = ()


class _Clock:
    """Stage boundaries of one segment, with no sync until :meth:`end`."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.dev = dev
        self.t0 = time.perf_counter()
        self.marks = [("", self._now())]

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def mark(self, stage: str):
        self.marks.append((stage, self._now()))

    def end(self):
        """Syncs the device; returns (segment seconds, {stage: seconds})."""
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        total = time.perf_counter() - self.t0
        return total, {
            name: a.elapsed_time(b) / 1e3 if self.cuda else b - a
            for (_, a), (name, b) in zip(self.marks, self.marks[1:])}


class _SegmentDraws(NamedTuple):
    """Every draw of one segment after the first, taken from the draw
    source when the segment (eager) or its chunk (scan) starts. The
    size-dependent sites are callables of the client sizes."""
    env: object                    # EnvDraws
    crash: list                    # (N,) uniforms per crash pulse
    burst: list                    # (N, N) uniforms per link burst
    cluster: object                # sizes -> KMeansDraws (rediscovery)
    rl: Optional[ql.RLDraws]       # mixed-policy burst
    uniform_edge: Optional[torch.Tensor]
    exchange: Optional[ex.ExchangeDraws]
    fl_batch: list                 # per round: sizes -> (tau_a, N, B)


def _sel_shape(cfg: OrchestratorConfig, trust, cap: int):
    """The device selector's uniform shape (k_max, cap), or None."""
    if cfg.pipeline.exchange.reserve_selector != "device":
        return None
    return (int(trust.shape[-1]), cap)


def _fl_batch_draws(draws, s: int, cfg: OrchestratorConfig, n: int) -> list:
    """Segment s's per-round minibatch draws, each a callable of the
    sizes."""
    flcfg = dataclasses.replace(cfg.fl, total_iters=cfg.total_iters)
    rps = cfg.iters_per_segment // cfg.fl.tau_a
    return [draws.fl_batch(r, n, flcfg)
            for r in range(s * rps, (s + 1) * rps)]


def _take_draws(draws, s: int, rediscover: bool, cfg: OrchestratorConfig,
                scn, n: int, sel_shape, ae_cfg) -> _SegmentDraws:
    plan, pcfg = scn.faults, cfg.pipeline
    uniform = cfg.mode == "uniform"
    re_rl = rediscover and not uniform and pcfg.rl.policy != "ucb"
    return _SegmentDraws(
        env=draws.env(s, n),
        crash=[draws.crash(c.start, n) for c in plan.crashes] if plan
        else [],
        burst=[draws.burst(b.start, n) for b in plan.link_bursts] if plan
        else [],
        cluster=draws.cluster(s, n, pcfg.n_clusters) if rediscover else None,
        rl=draws.rl(s, n, cfg.burst_episodes) if re_rl else None,
        uniform_edge=draws.uniform_edge(s, n) if rediscover and uniform
        else None,
        exchange=draws.exchange(s, n, ae_cfg, sel_shape)
        if rediscover and cfg.exchange_on_rediscover else None,
        fl_batch=_fl_batch_draws(draws, s, cfg, n))


def _env_step(env, d: _SegmentDraws, scn, pcfg):
    """The environment's step: (env, p_fail)."""
    env = env_step(env, d.env, scn, pcfg.channel)
    return env, failure_prob(env.rss, pcfg.channel)


def _inject_faults(s: int, env, p_fail, d: _SegmentDraws, plan):
    """The scenario's fault overlay on segment ``s``: (env, p_fail)."""
    env = env._replace(available=apply_availability(
        plan, s, env.positions, env.available, d.crash))
    return env, apply_pfail(plan, s, p_fail, d.burst)


def _advance_env(s: int, env, d: _SegmentDraws, scn, pcfg):
    """The environment's step, then the scenario's faults (no spans: the
    eager loop times the two parts apart)."""
    env, p_fail = _env_step(env, d, scn, pcfg)
    if scn.faults is not None:
        env, p_fail = _inject_faults(s, env, p_fail, d, scn.faults)
    return env, p_fail


def _rediscover(cd: ClientData, trust, p_fail, cfg: OrchestratorConfig,
                rl_state: Optional[ql.RLState], d: _SegmentDraws, dev,
                rules=None):
    """Re-cluster the *current* client stack and run a warm-started RL
    burst (or a uniform re-draw). Returns (in_edge, rl_state, assigns)."""
    pcfg = cfg.pipeline
    with obs.span("re-cluster"):
        _, cents, assigns = cluster_clients(cd, pcfg, d.cluster(cd.sizes),
                                            device=dev, rules=rules)
    with obs.span("re-discover", mode=cfg.mode):
        if cfg.mode == "uniform":
            return d.uniform_edge, rl_state, assigns
        _beta, _lam, local_r = link_rewards(sh.gather_clients(cents, rules),
                                            trust, p_fail, pcfg)
        graph = ql.discover_graph(local_r, p_fail, pcfg.rl,
                                  init_state=rl_state,
                                  n_episodes=cfg.burst_episodes, draws=d.rl,
                                  rules=rules)
    return graph.in_edge, graph.state, assigns


def _rediscover_impl(cd: ClientData, trust, p_fail, cfg: OrchestratorConfig,
                     rl_state: Optional[ql.RLState], d: _SegmentDraws,
                     rules=None):
    """:func:`_rediscover` through the span-free impls, for the scan
    chunk."""
    pcfg = cfg.pipeline
    _, cents, assigns = _cluster_impl(cd.data, cd.sizes, pcfg.n_pca,
                                      pcfg.n_clusters, pcfg.kmeans_iters,
                                      d.cluster(cd.sizes), rules)
    if cfg.mode == "uniform":
        return d.uniform_edge, rl_state, assigns
    _beta, _lam, local_r = link_rewards(sh.gather_clients(cents, rules),
                                        trust, p_fail, pcfg)
    graph = ql._discover_impl(local_r, p_fail, pcfg.rl, rl_state,
                              cfg.burst_episodes, d.rl, rules)
    return graph.in_edge, graph.state, assigns


def _segment_batches(s: int, cd: ClientData, fl_batch: list,
                     cfg: OrchestratorConfig) -> dict:
    """Segment s's minibatch indices by global round, at the current
    sizes."""
    first = s * cfg.iters_per_segment // cfg.fl.tau_a
    return {first + i: f(cd.sizes) for i, f in enumerate(fl_batch)}


def _fl_segment(s: int, cd: ClientData, avail, carry, fl_batch: list,
                cfg: OrchestratorConfig, ae_cfg, eval_data, draws, dev,
                rules=None):
    """The segment's FL rounds, from the previous segment's carry."""
    flcfg = dataclasses.replace(cfg.fl, total_iters=cfg.total_iters)
    return fl_train(cd, ae_cfg, flcfg, eval_data, avail_mask=avail,
                    init_params=draws.fl_init(ae_cfg) if carry is None
                    else None, init_carry=carry,
                    start_iter=s * cfg.iters_per_segment,
                    stop_iter=(s + 1) * cfg.iters_per_segment,
                    batch_idx=_segment_batches(s, cd, fl_batch, cfg),
                    defer_metrics=True, device=dev, rules=rules)


def _fl_segment_impl(s: int, cd: ClientData, avail, carry, fl_batch: list,
                     cfg: OrchestratorConfig, ae_cfg, eval_data, rules=None):
    """:func:`_fl_segment` through the span-free rounds, for the scan
    chunk (the carry exists there: segment 0 ran eagerly)."""
    flcfg = dataclasses.replace(cfg.fl, total_iters=cfg.total_iters)
    first = s * cfg.iters_per_segment // flcfg.tau_a
    return _fl_rounds(cd, ae_cfg, flcfg, eval_data, carry,
                      avail.to(torch.float32), first, first + len(fl_batch),
                      _segment_batches(s, cd, fl_batch, cfg), rules)


def _segment_dev(s: int, fl, ae_cfg, eval_data, env, p_fail, in_edge,
                 prev_edge, rediscovered: bool, sampled: bool, fail, moved,
                 dev) -> dict:
    """One segment's deferred metrics, as device tensors."""
    n = int(in_edge.shape[0])
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    realized = torch.full((), float("nan"), device=dev)
    n_live = n_failed = zero
    if sampled:
        realized = realized_delivery_dev(in_edge, fail)
        live = in_edge != torch.arange(n, device=dev)
        n_live = torch.sum(live)
        n_failed = torch.sum(fail & live)
    pf, expected = delivery_stats_dev(in_edge, p_fail)
    seg_loss = (fl.eval_loss[-1] if fl.eval_loss.numel() else
                eval_global_loss(fl.carry.global_params, eval_data, ae_cfg))
    return {
        "eval_loss": seg_loss,
        "in_edge": in_edge,
        "link_churn": link_churn_dev(
            prev_edge if rediscovered and s > 0 else None, in_edge),
        "mean_pfail": pf,
        "expected_delivery": expected,
        "n_available": torch.sum(env.available),
        "moved": moved,
        "realized": realized,
        "eval_curve": fl.eval_loss,
        "n_live": n_live,
        "n_failed": n_failed,
    }


def run_orchestrator(datasets, labels, ae_cfg,
                     cfg: OrchestratorConfig = OrchestratorConfig(),
                     scenario="static", eval_data=None, *, draws=None,
                     resume_from=None, device="cuda",
                     rules=None) -> OrchestratorResult:
    """Simulate a deployment: ``cfg.n_segments`` FL segments over an
    evolving environment (see the module docstring).

    ``datasets``/``labels`` may be ragged per-client lists or one
    :class:`ClientData` (as ``datasets``, with ``labels=None``).
    ``draws``: the draw source (default ``SeededDraws(0, device)``).

    ``resume_from``: the path of a run-state checkpoint written by an
    earlier (killed) call with ``cfg.checkpoint_dir`` set, or a loaded
    :class:`RunState` (``convert.run_state`` reads the JAX package's). The
    call must
    pass the same draw source, configs, scenario and eval data; the run
    skips the completed segments and continues bit-identically. A resumed
    run ignores the scenario's ``preempt_at``.

    ``rules`` shards the client axis (module docstring); every rank of the
    mesh makes the same call. The result's ``client_data`` is placed, its
    ``datasets`` and ``labels`` whole."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; expected one of {MODES}")
    if cfg.segment_impl not in SEGMENT_IMPLS:
        raise ValueError(f"unknown segment_impl {cfg.segment_impl!r}; "
                         f"expected one of {SEGMENT_IMPLS}")
    if (cfg.segment_impl == "scan" and cfg.mode != "oneshot"
            and cfg.exchange_on_rediscover):
        exc = cfg.pipeline.exchange
        if exc.method != "batched":
            raise ValueError(
                "segment_impl='scan' runs the re-exchange inside its chunks; "
                f"exchange method {exc.method!r} is host-side: use "
                "method='batched'")
        if exc.overflow != "drop":
            raise ValueError(
                "segment_impl='scan' needs static shapes across segments; "
                f"overflow={exc.overflow!r} grows the ClientData cap per "
                "round: use overflow='drop'")
        if exc.reserve_selector != "device":
            raise ValueError(
                "segment_impl='scan' needs reserve selection on the device "
                "(the host selector reads the cluster ids back); set "
                "ExchangeConfig(reserve_selector='device')")
    if eval_data is None:
        raise ValueError("eval_data is required: the per-segment trace is "
                         "built around the global eval reconstruction loss")
    if cfg.iters_per_segment % cfg.fl.tau_a != 0:
        raise ValueError(
            f"iters_per_segment={cfg.iters_per_segment} must be a multiple "
            f"of the aggregation interval tau_a={cfg.fl.tau_a}: segment "
            "boundaries fall between rounds otherwise")
    dev = resolve_device(device)
    if draws is None:
        draws = SeededDraws(0, dev)
    scn = get_scenario(scenario)
    with obs.span("orchestrator", mode=cfg.mode, scenario=scn.name,
                  n_segments=cfg.n_segments,
                  resumed=resume_from is not None):
        return _orchestrate(datasets, labels, ae_cfg, cfg, scn,
                            torch.as_tensor(eval_data, device=dev), draws,
                            resume_from, dev, rules)


def _save(path: str, rs: RunState, cfg: OrchestratorConfig, rules) -> None:
    """Write the run state: gathered whole (one all-gather), written by
    rank 0, and every rank waits for the write."""
    rs = dataclasses.replace(rs, **dict(zip(
        ("cd", "rl_state", "carry"),
        sh.gather_clients((rs.cd, rs.rl_state, rs.carry), rules))))
    if rules is None or not torch.distributed.is_initialized() or \
            torch.distributed.get_rank() == 0:
        save_run_state(path, rs, cfg.n_segments, cfg.iters_per_segment)
    sh.barrier(rules)


def _orchestrate(datasets, labels, ae_cfg, cfg: OrchestratorConfig, scn,
                 eval_data, draws, resume_from, dev,
                 rules=None) -> OrchestratorResult:
    plan = scn.faults
    pcfg = cfg.pipeline
    ckpt_path = cfg.checkpoint_path

    retry_q = RetryQueue()
    # the first segment's clock also covers the pipeline (or the load)
    clock = _Clock(dev)
    if resume_from is not None:
        with obs.span("checkpoint-load"):
            rs = resume_from if isinstance(resume_from, RunState) else \
                load_run_state(resume_from, ae_cfg, cfg.n_segments,
                               cfg.iters_per_segment, device=dev)
        if not np.array_equal(np.asarray(rs.key),
                              np.asarray(draws.identity)):
            raise ValueError(
                "resume key mismatch: the checkpoint was written by a run "
                "with another draw source; resuming would silently diverge "
                "from the original run")
        env, cd, trust = rs.env, shard_client_data(rs.cd, rules), rs.trust
        in_edge, prev_edge, p_fail = rs.in_edge, rs.prev_edge, rs.p_fail
        rl_state, retry_q = sh.shard_clients(rs.rl_state, rules), rs.retry
        carry = rs.carry._replace(**{
            f: sh.shard_clients(getattr(rs.carry, f), rules)
            for f in ("client_params", "mu", "nu")})
        pending = list(rs.pending)
        exch = None
        start_segment = rs.segment + 1
        clock.mark("checkpoint-load")
    else:
        cd = as_client_data(datasets, labels, device=dev)
        n = cd.n_clients
        pipe_draws = draws.pipeline(cd.sizes, None, pcfg, ae_cfg, cap=cd.cap)
        # the environment owns the channel: its initial state is the
        # pipeline's channel draw, so segment 0's RSS is the one-shot one
        env = env_init(pipe_draws.positions, pipe_draws.fading, pcfg.channel,
                       scn)
        init_edge = draws.uniform_edge(0, n) if cfg.mode == "uniform" \
            else None
        pipe = run_pipeline(cd, None, ae_cfg, pcfg, in_edge=init_edge,
                            rss=env.rss, draws=pipe_draws, device=dev,
                            rules=rules)
        cd, trust, in_edge = pipe.client_data, pipe.trust, pipe.in_edge
        rl_state, p_fail, exch = pipe.graph.state, pipe.p_fail, pipe.exchange
        pending = []
        carry = None
        prev_edge = None
        start_segment = 0
        clock.mark("pipeline")

    n = int(env.available.shape[0])
    # under the scan engine only segment 0 (the one-shot pipeline's
    # segment) runs here; the loop is the eager engine itself, the scan's
    # oracle
    eager_end = cfg.n_segments if cfg.segment_impl == "eager" else \
        max(start_segment, 1)
    seg_seconds, stage_seconds = [], []
    for s in range(start_segment, eager_end):
        if (plan is not None and plan.preempt_at == s
                and resume_from is None):
            # simulated host preemption at the segment boundary: the
            # previous segment's checkpoint (if enabled) is already on disk
            raise Preempted(s, ckpt_path)
        with obs.span("segment", segment=s):
            if s > start_segment:
                clock = _Clock(dev)
            rediscovered = s == 0
            assigns = None
            d = None
            if s > 0:
                rediscover = (cfg.mode != "oneshot"
                              and s % cfg.rediscover_every == 0)
                d = _take_draws(draws, s, rediscover, cfg, scn, n,
                                _sel_shape(cfg, trust, cd.cap), ae_cfg)
                with obs.span("env-step", segment=s):
                    env, p_fail = _env_step(env, d, scn, pcfg)
                if plan is not None:
                    with obs.span("fault-inject", segment=s,
                                  events=",".join(plan.active(s)) or "none"):
                        env, p_fail = _inject_faults(s, env, p_fail, d, plan)
                clock.mark("env")
                exch = None
                if rediscover:
                    new_edge, rl_state, assigns = _rediscover(
                        cd, trust, p_fail, cfg, rl_state, d, dev, rules)
                    clock.mark("rediscover")
                    if cfg.exchange_on_rediscover:
                        with obs.span("re-exchange", segment=s):
                            exch = ex.run_exchange(
                                cd, None, assigns, trust, new_edge, p_fail,
                                ae_cfg, pcfg.exchange, draws=d.exchange,
                                device=dev, rules=rules)
                            cd = exch.client_data
                        clock.mark("exchange")
                    prev_edge, in_edge = in_edge, new_edge
                    rediscovered = True

            retried = retry_delivered = 0
            retry_moved = torch.zeros((), dtype=torch.int64, device=dev)
            if cfg.retry.enabled:
                if exch is not None:
                    retry_q.offer(s, exch.failed_links(), cfg.retry)
                if assigns is not None and len(retry_q):
                    cd, retry_moved, retried, retry_delivered = \
                        _retry_exchange(s, cd, assigns, trust, p_fail,
                                        ae_cfg, cfg, retry_q, draws, dev,
                                        rules)
                clock.mark("retry")

            with obs.span("fl-segment", segment=s):
                fl = _fl_segment(s, cd, env.available, carry,
                                 _fl_batch_draws(draws, s, cfg, n)
                                 if d is None else d.fl_batch, cfg, ae_cfg,
                                 eval_data, draws, dev, rules)
                carry = fl.carry
            clock.mark("fl")

            sampled = (pcfg.exchange.apply_channel_failure and rediscovered
                       and exch is not None)
            # the loop plane decides on the host: its realized delivery too
            host_realized = \
                realized_delivery(in_edge, exch.gate_decisions) \
                if sampled and exch.fail is None else None
            moved = (torch.sum(exch.moved_dev) if exch is not None else
                     torch.zeros((), dtype=torch.int64, device=dev)) \
                + retry_moved
            pending.append(PendingSegment(
                segment=s, rediscovered=rediscovered, sampled=sampled,
                host_realized=host_realized,
                eval_iters=np.asarray(fl.eval_iters), retried=retried,
                retry_delivered=retry_delivered,
                dev=_segment_dev(s, fl, ae_cfg, eval_data, env, p_fail,
                                 in_edge, prev_edge, rediscovered,
                                 sampled and host_realized is None,
                                 exch.fail if sampled else None, moved,
                                 dev)))

            clock.mark("metrics")
            if ckpt_path is not None and (
                    (s + 1) % cfg.checkpoint_every == 0
                    or s == cfg.n_segments - 1):
                with obs.span("checkpoint-save", segment=s):
                    _save(ckpt_path, RunState(
                        segment=s, key=np.asarray(draws.identity), env=env,
                        cd=cd, trust=trust, in_edge=in_edge,
                        prev_edge=prev_edge, p_fail=p_fail,
                        rl_state=rl_state, carry=carry, retry=retry_q,
                        pending=pending), cfg, rules)
                clock.mark("checkpoint")
            total, stages = clock.end()
            seg_seconds.append(total)
            stage_seconds.append(stages)

    chunk_seconds = ()
    if eager_end < cfg.n_segments:
        sc, chunk_seconds = _scan_segments(
            cfg, scn, ae_cfg, eval_data, draws, resume_from, trust, retry_q,
            pending, _ScanCarry(env, p_fail, cd, None, in_edge, prev_edge,
                                rl_state, carry), eager_end, ckpt_path, dev,
            rules)
        env, cd, in_edge, carry = sc.env, sc.cd, sc.in_edge, sc.fc

    with obs.span("metrics-materialize"):
        host = _read_all([p.dev for p in pending])
    trace = Trace()
    for p, h in zip(pending, host):
        realized = p.host_realized
        if realized is None and p.sampled and np.isfinite(h["realized"]):
            realized = float(h["realized"])
        trace.add(SegmentRecord(
            segment=p.segment, eval_loss=float(h["eval_loss"]),
            in_edge=np.asarray(h["in_edge"]),
            link_churn=float(h["link_churn"]),
            mean_pfail=float(h["mean_pfail"]),
            expected_delivery=float(h["expected_delivery"]),
            realized_delivery=realized,
            n_available=int(h["n_available"]),
            moved=int(h["moved"]), rediscovered=p.rediscovered,
            eval_iters=p.eval_iters,
            eval_curve=np.asarray(h["eval_curve"]),
            n_live=int(h["n_live"]), n_failed=int(h["n_failed"]),
            retried=p.retried, retry_delivered=p.retry_delivered))

    whole = cd.whole(rules)
    return OrchestratorResult(trace, carry.global_params, carry, in_edge,
                              env, whole.data_list(), whole.label_list(),
                              trace.eval_curve_iters, trace.eval_curve, cd,
                              tuple(seg_seconds), tuple(stage_seconds),
                              chunk_seconds)


def _read_all(devs: list) -> list:
    """Every segment's metrics to the host in one transfer: the tensors are
    packed into one float64 vector (exact for their f32 and integer
    values), copied once through the counted ``counters.device_get`` (one
    call per run, an empty one when every segment was restored) and
    unpacked into their own dtypes. Host values (restored segments') pass
    through."""
    tensors = [v for d in devs for v in d.values()
               if isinstance(v, torch.Tensor)]
    flat = device_get(
        torch.cat([v.reshape(-1).to(torch.float64) for v in tensors])
        if tensors else torch.zeros((0,), dtype=torch.float64))
    out, off = [], 0
    for d in devs:
        h = {}
        for k, v in d.items():
            if isinstance(v, torch.Tensor):
                dtype = torch.empty((), dtype=v.dtype).numpy().dtype
                h[k] = flat[off:off + v.numel()].reshape(tuple(v.shape)) \
                    .astype(dtype)
                off += v.numel()
            else:
                h[k] = np.asarray(v)
        out.append(h)
    return out


def _retry_exchange(s: int, cd: ClientData, assigns, trust, p_fail, ae_cfg,
                    cfg: OrchestratorConfig, retry_q: RetryQueue, draws, dev,
                    rules=None):
    """Re-offer the due failed links through the standard exchange.

    The retry edge maps each due receiver to its original transmitter and
    everyone else to itself (a self-link moves nothing). A retried transfer
    faces the *current* channel and the receiver's current gate; delivered
    means the channel held (the gate may still decline the payload)."""
    due = retry_q.take_due(s)
    if not due:
        return cd, torch.zeros((), dtype=torch.int64, device=dev), 0, 0
    with obs.span("retry-exchange", segment=s, n_links=len(due)):
        n = cd.n_clients
        retry_edge = np.arange(n)
        for e in due:
            retry_edge[e.rx] = e.tx
        r_exch = ex.run_exchange(cd, None, assigns, trust,
                                 torch.as_tensor(retry_edge, device=dev),
                                 p_fail, ae_cfg, cfg.pipeline.exchange,
                                 draws=draws.retry(s, n, ae_cfg, _sel_shape(
                                     cfg, trust, cd.cap)), device=dev,
                                 rules=rules)
        failed = set(r_exch.failed_links())
        delivered = 0
        for e in due:
            ok = (e.rx, e.tx) not in failed
            retry_q.resolve(s, e, ok, cfg.retry)
            delivered += int(ok)
        obs.mark("retry-outcome", segment=s, offered=len(due),
                 delivered=delivered, still_queued=len(retry_q))
        return (r_exch.client_data, torch.sum(r_exch.moved_dev), len(due),
                delivered)


# ---------------------------------------------------------------------------
# the scan engine (segment_impl="scan"): segments [1, n) in chunks. Host
# work (checkpoint writes, retry offers and drains, simulated preemption)
# happens between chunks only; inside a chunk nothing reads the device.
# ---------------------------------------------------------------------------


class _ScanCarry(NamedTuple):
    """The state threaded from segment to segment, as the eager loop keeps
    it in locals. ``assigns`` holds the last rediscovery's cluster ids
    (None until the first), which a boundary drain reads."""
    env: EnvState
    p_fail: torch.Tensor
    cd: ClientData
    assigns: Optional[torch.Tensor]
    in_edge: torch.Tensor
    prev_edge: Optional[torch.Tensor]
    rl_state: Optional[ql.RLState]
    fc: object                     # FLCarry


def _eval_rounds(cfg: OrchestratorConfig, s: int) -> list:
    """Local round indices of segment ``s`` that ``fl_train`` evaluates at:
    a pure function of the config, as in the reference."""
    rps = cfg.iters_per_segment // cfg.fl.tau_a
    n_rounds = cfg.total_iters // cfg.fl.tau_a
    out = []
    for rl in range(rps):
        r = s * rps + rl
        it = (r + 1) * cfg.fl.tau_a
        if it % cfg.fl.eval_every == 0 or r == n_rounds - 1:
            out.append(rl)
    return out


def _chunk_bounds(cfg: OrchestratorConfig, plan, start: int,
                  ckpt_path) -> list:
    """Split segments [start, n_segments) into chunks. A chunk ends after
    segment ``s`` iff host work is due there: a checkpoint write, a retry
    offer and drain (retries ride the rediscovery cadence), a simulated
    preemption at ``s + 1``, or the run's end. The bounds depend on (cfg,
    plan) alone, not on ``start``, so a resumed run cuts where the
    uninterrupted run did."""
    bounds, c0 = [], start
    for s in range(start, cfg.n_segments):
        cut = s == cfg.n_segments - 1
        if ckpt_path is not None and (s + 1) % cfg.checkpoint_every == 0:
            cut = True
        if (cfg.retry.enabled and cfg.mode != "oneshot"
                and s % cfg.rediscover_every == 0):
            cut = True
        if plan is not None and plan.preempt_at == s + 1:
            cut = True
        if cut:
            bounds.append((c0, s + 1))
            c0 = s + 1
    return bounds


def _chunk(cfg: OrchestratorConfig, scn, ae_cfg, eval_data, trust,
           sc: _ScanCarry, segs: list, re_flags: list, seg_draws: list,
           dev, rules=None):
    """Run one chunk's segments from ``sc``. Returns the carry after them
    and, per segment, (deferred metrics, the channel-failure row, the FL
    segment's eval iterations).

    Nothing here reads the device from the host: every draw is in
    ``seg_draws``; the size-dependent ones are mapped on the device; the
    reserves are selected on the device; the exchange keeps the cap. The
    stages go through their span-free impls, so the chunk records no
    named span inside its ``scan-chunk``."""
    pcfg = cfg.pipeline
    excfg = pcfg.exchange
    do_exchange = cfg.mode != "oneshot" and cfg.exchange_on_rediscover
    sampled_possible = do_exchange and excfg.apply_channel_failure
    env, p_fail, cd, assigns, in_edge, prev_edge, rl_state, fc = sc
    n = in_edge.shape[0]
    part = sh.ClientSlice(rules, n)
    out = []
    for s, re, d in zip(segs, re_flags, seg_draws):
        env, p_fail = _advance_env(s, env, d, scn, pcfg)
        moved = torch.zeros((n,), dtype=torch.int64, device=dev)
        fail = torch.zeros((n,), dtype=torch.bool, device=dev)
        if re:
            new_edge, rl_state, assigns = _rediscover_impl(
                cd, trust, p_fail, cfg, rl_state, d, rules)
            if do_exchange:
                xd = d.exchange
                params = ex.pretrain_autoencoders_batched(
                    xd.init_params, cd, ae_cfg, excfg, rules)
                sel_idx, sel_mask = part.place(ex.select_reserves_device(
                    part.rows(xd.sel_u), part.rows(assigns),
                    part.rows(cd.sizes), int(trust.shape[-1]),
                    excfg.reserve_per_cluster))
                cd, moved, _b, _sc, fail, _acc, _ovf = ex._exchange_device(
                    params, cd.data, cd.sizes, cd.labels, sel_idx, sel_mask,
                    trust, xd.fail_u, p_fail, new_edge, ae_cfg,
                    excfg.apply_channel_failure, cd.cap, rules)
            prev_edge, in_edge = in_edge, new_edge
        fl = _fl_segment_impl(s, cd, env.available, fc, d.fl_batch, cfg,
                              ae_cfg, eval_data, rules)
        fc = fl.carry
        dev_metrics = _segment_dev(
            s, fl, ae_cfg, eval_data, env, p_fail, in_edge, prev_edge, re,
            sampled_possible and re, fail, torch.sum(moved), dev)
        out.append((dev_metrics, fail, fl.eval_iters))
    return _ScanCarry(env, p_fail, cd, assigns, in_edge, prev_edge, rl_state,
                      fc), out


def _scan_segments(cfg: OrchestratorConfig, scn, ae_cfg, eval_data, draws,
                   resume_from, trust, retry_q: RetryQueue, pending: list,
                   sc: _ScanCarry, start: int, ckpt_path, dev, rules=None):
    """Drive the scan engine over segments [start, n_segments): per chunk,
    take its draws, run it, sync once, then do the host work at its
    boundary (retry offers from its sampled failures and one drain,
    ``PendingSegment`` assembly, the checkpoint). Appends to ``pending``;
    returns the final carry and each chunk's (c0, c1, seconds)."""
    plan = scn.faults
    n = int(sc.in_edge.shape[0])
    sampled_possible = (cfg.mode != "oneshot" and cfg.exchange_on_rediscover
                        and cfg.pipeline.exchange.apply_channel_failure)
    sel_shape = _sel_shape(cfg, trust, sc.cd.cap)
    chunk_seconds = []
    for c0, c1 in _chunk_bounds(cfg, plan, start, ckpt_path):
        if (plan is not None and plan.preempt_at == c0
                and resume_from is None):
            raise Preempted(c0, ckpt_path)
        segs = list(range(c0, c1))
        re_flags = [cfg.mode != "oneshot" and s % cfg.rediscover_every == 0
                    for s in segs]
        seg_draws = [_take_draws(draws, s, re, cfg, scn, n, sel_shape, ae_cfg)
                     for s, re in zip(segs, re_flags)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with obs.span("scan-chunk", start=c0, n_segments=len(segs)):
            sc, out = _chunk(cfg, scn, ae_cfg, eval_data, trust, sc, segs,
                             re_flags, seg_draws, dev, rules)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        chunk_seconds.append((c0, c1, time.perf_counter() - t0))

        # -- boundary host work: retry offers from the chunk's sampled
        # failure rows, then one drain (reads of (N,) rows only; the
        # metrics stay deferred)
        b = c1 - 1
        retried = retry_delivered = 0
        retry_moved = None
        if cfg.retry.enabled and sampled_possible:
            for s, re, (dm, fail, _) in zip(segs, re_flags, out):
                if not re:
                    continue
                edge = dm["in_edge"].cpu().numpy()
                live = edge != np.arange(n)
                retry_q.offer(s, [(int(rx), int(edge[rx])) for rx in
                                  np.nonzero(fail.cpu().numpy() & live)[0]],
                              cfg.retry)
        if cfg.retry.enabled and any(re_flags) and len(retry_q):
            # the drain rides the chunk boundary, one segment later than
            # the eager engine's pre-FL drain (the boundary segment is the
            # chunk's rediscovery: _chunk_bounds cuts there)
            new_cd, retry_moved, retried, retry_delivered = _retry_exchange(
                b, sc.cd, sc.assigns, trust, sc.p_fail, ae_cfg, cfg, retry_q,
                draws, dev, rules)
            sc = sc._replace(cd=new_cd)

        for s, re, (dm, _, eval_iters) in zip(segs, re_flags, out):
            if s == b and retry_moved is not None:
                dm = dict(dm, moved=dm["moved"] + retry_moved)
            pending.append(PendingSegment(
                segment=s, rediscovered=re, sampled=sampled_possible and re,
                host_realized=None, eval_iters=np.asarray(eval_iters),
                retried=retried if s == b else 0,
                retry_delivered=retry_delivered if s == b else 0, dev=dm))

        if ckpt_path is not None and ((b + 1) % cfg.checkpoint_every == 0
                                      or b == cfg.n_segments - 1):
            with obs.span("checkpoint-save", segment=b):
                _save(ckpt_path, RunState(
                    segment=b, key=np.asarray(draws.identity), env=sc.env,
                    cd=sc.cd, trust=trust, in_edge=sc.in_edge,
                    prev_edge=sc.prev_edge, p_fail=sc.p_fail,
                    rl_state=sc.rl_state, carry=sc.fc, retry=retry_q,
                    pending=pending), cfg, rules)
    return sc, tuple(chunk_seconds)
