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

Device residency: the client data stack, channel state, FL carry, graph and
availability stay on the run's device; each segment's metrics are device
tensors until one host read after the last segment. The host reads inside
the loop are the reserve selector's cluster ids and, with retries on, the
(N,) fail mask of ``ExchangeResult.failed_links``; each segment ends with
one device sync that times it.

Fault tolerance (``repro_torch.faults``): a scenario's ``FaultPlan`` is
overlaid onto the environment from segment 1 on. With
``cfg.checkpoint_dir`` set, the run state is written atomically at segment
boundaries and a killed run resumes bit-identically through
``run_orchestrator(..., resume_from=path)``. With ``cfg.retry.enabled``,
failed live links re-offer through a bounded backoff queue; retries ride
the re-discovery cadence (they need fresh cluster assignments).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import exchange as ex
from repro_torch.core import qlearning as ql
from repro_torch.core.batching import ClientData, as_client_data
from repro_torch.core.channel import failure_prob
from repro_torch.core.pipeline import (PipelineConfig, cluster_clients,
                                       link_rewards, run_pipeline)
from repro_torch.dynamics.draws import SeededDraws
from repro_torch.dynamics.environment import EnvState, env_init, env_step
from repro_torch.dynamics.metrics import (PendingSegment, SegmentRecord,
                                          Trace, delivery_stats_dev,
                                          link_churn_dev,
                                          realized_delivery_dev)
from repro_torch.dynamics.runstate import (RunState, load_run_state,
                                           save_run_state)
from repro_torch.dynamics.scenarios import get_scenario
from repro_torch.faults import (Preempted, RetryPolicy, apply_availability,
                                apply_pfail)
from repro_torch.faults.retry import RetryQueue
from repro_torch.fl.trainer import FLConfig, eval_global_loss, fl_train

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
    # "eager" (one Python iteration per segment) is the engine ported so
    # far; "scan" raises NotImplementedError (ROADMAP Queue 1, item 7)
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


def _rediscover(s: int, cd: ClientData, trust, p_fail,
                cfg: OrchestratorConfig, rl_state: Optional[ql.RLState],
                draws, dev):
    """Re-cluster the *current* client stack and run a warm-started RL
    burst (or a uniform re-draw). Returns (in_edge, rl_state, assigns)."""
    pcfg = cfg.pipeline
    _, cents, assigns = cluster_clients(
        cd, pcfg, draws.cluster(s, cd.sizes, pcfg.n_clusters), device=dev)
    if cfg.mode == "uniform":
        return draws.uniform_edge(s, cd.n_clients), rl_state, assigns
    _beta, _lam, local_r = link_rewards(cents, trust, p_fail, pcfg)
    rl = None if pcfg.rl.policy == "ucb" else \
        draws.rl(s, cd.n_clients, cfg.burst_episodes)
    graph = ql.discover_graph(local_r, p_fail, pcfg.rl, init_state=rl_state,
                              n_episodes=cfg.burst_episodes, draws=rl)
    return graph.in_edge, graph.state, assigns


def run_orchestrator(datasets, labels, ae_cfg,
                     cfg: OrchestratorConfig = OrchestratorConfig(),
                     scenario="static", eval_data=None, *, draws=None,
                     resume_from=None, device="cuda") -> OrchestratorResult:
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
    run ignores the scenario's ``preempt_at``."""
    if cfg.mode not in MODES:
        raise ValueError(f"unknown mode {cfg.mode!r}; expected one of {MODES}")
    if cfg.segment_impl not in SEGMENT_IMPLS:
        raise ValueError(f"unknown segment_impl {cfg.segment_impl!r}; "
                         f"expected one of {SEGMENT_IMPLS}")
    if cfg.segment_impl == "scan":
        raise NotImplementedError(
            "segment_impl='scan' (the fused segment engine) is not ported "
            "yet: ROADMAP Queue 1, item 7")
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
    return _orchestrate(datasets, labels, ae_cfg, cfg,
                        get_scenario(scenario),
                        torch.as_tensor(eval_data, device=dev), draws,
                        resume_from, dev)


def _orchestrate(datasets, labels, ae_cfg, cfg: OrchestratorConfig, scn,
                 eval_data, draws, resume_from, dev) -> OrchestratorResult:
    plan = scn.faults
    pcfg = cfg.pipeline
    flcfg = dataclasses.replace(cfg.fl, total_iters=cfg.total_iters)
    ckpt_path = cfg.checkpoint_path
    rounds_per_seg = cfg.iters_per_segment // flcfg.tau_a

    retry_q = RetryQueue()
    # the first segment's clock also covers the pipeline (or the load)
    clock = _Clock(dev)
    if resume_from is not None:
        rs = resume_from if isinstance(resume_from, RunState) else \
            load_run_state(resume_from, ae_cfg, cfg.n_segments,
                           cfg.iters_per_segment, device=dev)
        if not np.array_equal(np.asarray(rs.key),
                              np.asarray(draws.identity)):
            raise ValueError(
                "resume key mismatch: the checkpoint was written by a run "
                "with another draw source; resuming would silently diverge "
                "from the original run")
        env, cd, trust = rs.env, rs.cd, rs.trust
        in_edge, prev_edge, p_fail = rs.in_edge, rs.prev_edge, rs.p_fail
        rl_state, carry, retry_q = rs.rl_state, rs.carry, rs.retry
        pending = list(rs.pending)
        exch = None
        start_segment = rs.segment + 1
        clock.mark("checkpoint-load")
    else:
        cd = as_client_data(datasets, labels, device=dev)
        n = cd.n_clients
        pipe_draws = draws.pipeline(cd.sizes, None, pcfg, ae_cfg)
        # the environment owns the channel: its initial state is the
        # pipeline's channel draw, so segment 0's RSS is the one-shot one
        env = env_init(pipe_draws.positions, pipe_draws.fading, pcfg.channel,
                       scn)
        init_edge = draws.uniform_edge(0, n) if cfg.mode == "uniform" \
            else None
        pipe = run_pipeline(cd, None, ae_cfg, pcfg, in_edge=init_edge,
                            rss=env.rss, draws=pipe_draws, device=dev)
        cd, trust, in_edge = pipe.client_data, pipe.trust, pipe.in_edge
        rl_state, p_fail, exch = pipe.graph.state, pipe.p_fail, pipe.exchange
        pending = []
        carry = None
        prev_edge = None
        start_segment = 0
        clock.mark("pipeline")

    n = int(env.available.shape[0])
    seg_seconds, stage_seconds = [], []
    for s in range(start_segment, cfg.n_segments):
        if (plan is not None and plan.preempt_at == s
                and resume_from is None):
            # simulated host preemption at the segment boundary: the
            # previous segment's checkpoint (if enabled) is already on disk
            raise Preempted(s, ckpt_path)
        if s > start_segment:
            clock = _Clock(dev)
        rediscovered = s == 0
        assigns = None
        if s > 0:
            env = env_step(env, draws.env(s, n), scn, pcfg.channel)
            p_fail = failure_prob(env.rss, pcfg.channel)
            if plan is not None:
                env = env._replace(available=apply_availability(
                    plan, s, env.positions, env.available,
                    [draws.crash(c.start, n) for c in plan.crashes]))
                p_fail = apply_pfail(
                    plan, s, p_fail,
                    [draws.burst(b.start, n) for b in plan.link_bursts])
            clock.mark("env")
            exch = None
            if cfg.mode != "oneshot" and s % cfg.rediscover_every == 0:
                new_edge, rl_state, assigns = _rediscover(
                    s, cd, trust, p_fail, cfg, rl_state, draws, dev)
                clock.mark("rediscover")
                if cfg.exchange_on_rediscover:
                    exch = ex.run_exchange(
                        cd, None, assigns, trust, new_edge, p_fail, ae_cfg,
                        pcfg.exchange, draws=draws.exchange(s, n, ae_cfg),
                        device=dev)
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
                cd, retry_moved, retried, retry_delivered = _retry_exchange(
                    s, cd, assigns, trust, p_fail, ae_cfg, cfg, retry_q,
                    draws, dev)
            clock.mark("retry")

        first = s * rounds_per_seg
        batch = {r: draws.fl_batch(r, cd.sizes, flcfg)
                 for r in range(first, first + rounds_per_seg)}
        fl = fl_train(cd, ae_cfg, flcfg, eval_data, avail_mask=env.available,
                      init_params=draws.fl_init(ae_cfg) if carry is None
                      else None, init_carry=carry,
                      start_iter=s * cfg.iters_per_segment,
                      stop_iter=(s + 1) * cfg.iters_per_segment,
                      batch_idx=batch, defer_metrics=True, device=dev)
        carry = fl.carry
        clock.mark("fl")

        sampled = (pcfg.exchange.apply_channel_failure and rediscovered
                   and exch is not None)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        realized = torch.full((), float("nan"), device=dev)
        n_live = n_failed = zero
        if sampled:
            realized = realized_delivery_dev(in_edge, exch.fail)
            live = in_edge != torch.arange(n, device=dev)
            n_live = torch.sum(live)
            n_failed = torch.sum(exch.fail & live)
        pf, expected = delivery_stats_dev(in_edge, p_fail)
        seg_loss = (fl.eval_loss[-1] if fl.eval_loss.numel() else
                    eval_global_loss(carry.global_params, eval_data, ae_cfg))
        pending.append(PendingSegment(
            segment=s, rediscovered=rediscovered, sampled=sampled,
            host_realized=None, eval_iters=np.asarray(fl.eval_iters),
            retried=retried, retry_delivered=retry_delivered,
            dev={
                "eval_loss": seg_loss,
                "in_edge": in_edge,
                "link_churn": link_churn_dev(
                    prev_edge if rediscovered and s > 0 else None, in_edge),
                "mean_pfail": pf,
                "expected_delivery": expected,
                "n_available": torch.sum(env.available),
                "moved": (torch.sum(exch.moved_dev) if exch is not None
                          else zero) + retry_moved,
                "realized": realized,
                "eval_curve": fl.eval_loss,
                "n_live": n_live,
                "n_failed": n_failed,
            }))

        clock.mark("metrics")
        if ckpt_path is not None and (
                (s + 1) % cfg.checkpoint_every == 0
                or s == cfg.n_segments - 1):
            save_run_state(ckpt_path, RunState(
                segment=s, key=np.asarray(draws.identity), env=env, cd=cd,
                trust=trust, in_edge=in_edge, prev_edge=prev_edge,
                p_fail=p_fail, rl_state=rl_state, carry=carry,
                retry=retry_q, pending=pending),
                cfg.n_segments, cfg.iters_per_segment)
            clock.mark("checkpoint")
        total, stages = clock.end()
        seg_seconds.append(total)
        stage_seconds.append(stages)

    trace = Trace()
    for p, h in zip(pending, _read_all([p.dev for p in pending])):
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

    return OrchestratorResult(trace, carry.global_params, carry, in_edge,
                              env, cd.data_list(), cd.label_list(),
                              trace.eval_curve_iters, trace.eval_curve, cd,
                              tuple(seg_seconds), tuple(stage_seconds))


def _read_all(devs: list) -> list:
    """Every segment's metrics to the host in one transfer: the tensors are
    packed into one float64 vector (exact for their f32 and integer
    values), copied once and unpacked into their own dtypes. Host values
    (restored segments') pass through."""
    tensors = [v for d in devs for v in d.values()
               if isinstance(v, torch.Tensor)]
    flat = (torch.cat([v.reshape(-1).to(torch.float64) for v in tensors])
            .cpu().numpy() if tensors else None)
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
                    cfg: OrchestratorConfig, retry_q: RetryQueue, draws, dev):
    """Re-offer the due failed links through the standard exchange.

    The retry edge maps each due receiver to its original transmitter and
    everyone else to itself (a self-link moves nothing). A retried transfer
    faces the *current* channel and the receiver's current gate; delivered
    means the channel held (the gate may still decline the payload)."""
    due = retry_q.take_due(s)
    if not due:
        return cd, torch.zeros((), dtype=torch.int64, device=dev), 0, 0
    n = cd.n_clients
    retry_edge = np.arange(n)
    for e in due:
        retry_edge[e.rx] = e.tx
    r_exch = ex.run_exchange(cd, None, assigns, trust,
                             torch.as_tensor(retry_edge, device=dev), p_fail,
                             ae_cfg, cfg.pipeline.exchange,
                             draws=draws.retry(s, n, ae_cfg), device=dev)
    failed = set(r_exch.failed_links())
    delivered = 0
    for e in due:
        ok = (e.rx, e.tx) not in failed
        retry_q.resolve(s, e, ok, cfg.retry)
        delivered += int(ok)
    return (r_exch.client_data, torch.sum(r_exch.moved_dev), len(due),
            delivered)
