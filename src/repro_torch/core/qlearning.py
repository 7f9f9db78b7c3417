"""Decentralised multi-agent Q-learning for D2D graph discovery (paper
Sec. III + Algorithm 1; mirrors ``repro.core.qlearning``).

Each client is an agent choosing its incoming edge. The reference's
``lax.scan`` over episodes is a Python loop over episodes with all N agents
vectorised; its ``lax.cond`` buffer flush is an ``if``.

The mixed policy's draws are inputs (:class:`RLDraws`): per episode one
(N, N) uniform for Eq. 4 and one (N, N) Gumbel field for the categorical
pick (``jax.random.categorical`` is ``argmax(logits + gumbel)``).
``policy="ucb"`` draws nothing.

Sharded over the agents (``rules``), each rank runs its agents' rows of the
Q-tables and buffers; the draws stay whole (N, ...) on every rank and each
takes its rows, so any mesh uses the draws of an unsharded run. Self links
are masked at each row's global column. Per episode one all-reduce carries
the mean local reward and the mean P_D of the chosen links, each buffer
flush one more carries r_net, and the burst ends with an all-gather of the
agents' links: ``in_edge`` is whole on every rank.

Deviation note (as in the reference): Eq. 4 normalises raw Q values, which is
ill-defined once Q can be negative; the shifted normalisation
Q~ = Q - min(Q) + eps per row equals the paper's expression when Q >= 0.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import obs
from repro_torch import sharding as sh
from repro_torch.core import rewards as rw


@dataclasses.dataclass(frozen=True)
class RLConfig:
    n_episodes: int = 600      # E (paper Sec. V)
    buffer_size: int = 90      # M (paper Sec. V)
    q_init: float = 0.1        # "small equal values"
    gamma0: float = 0.3        # exploration->exploitation anneal (gamma at t=0)
    gamma_step: float = 0.15   # increase per buffer flush
    gamma_max: float = 0.95
    policy: str = "mixed"      # "mixed" (Eq. 4) | "ucb" (UCB1, deterministic)
    ucb_c: float = 1.5


class RLState(NamedTuple):
    q: torch.Tensor            # (N, N)
    counts: torch.Tensor       # (N, N) per-action pick counts (UCB)
    buf_actions: torch.Tensor  # (N, M) int32
    buf_rewards: torch.Tensor  # (N, M) global rewards (Eq. 3)
    buf_local: torch.Tensor    # (N, M) local rewards (for Eq. 5)
    r_net_prev: torch.Tensor   # ()
    t: torch.Tensor            # () int32 number of buffer flushes so far


class GraphResult(NamedTuple):
    in_edge: torch.Tensor        # (N,) transmitter chosen by each receiver
    q: torch.Tensor              # (N, N) final Q-table
    ep_mean_local: torch.Tensor  # (E,) mean local reward per episode
    ep_mean_pfail: torch.Tensor  # (E,) mean P_D of chosen links per episode
    state: Optional[RLState] = None


class RLDraws(NamedTuple):
    u: torch.Tensor        # (E, N, N) uniforms of Eq. 4
    gumbel: torch.Tensor   # (E, N, N) Gumbel noise of the categorical pick


def draw_rl(generator: torch.Generator, n: int, n_episodes: int) -> RLDraws:
    dev = generator.device
    u = torch.rand((n_episodes, n, n), generator=generator, device=dev)
    v = torch.rand((n_episodes, n, n), generator=generator, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    return RLDraws(u, -torch.log(-torch.log(torch.clamp_min(v, tiny))))


def _gamma(t, cfg: RLConfig):
    return torch.clamp_max(cfg.gamma0 + cfg.gamma_step * t.to(torch.float32),
                           cfg.gamma_max)


def _row_lookup(mat, actions):
    """mat[i, actions[i]] for every agent i."""
    return torch.gather(mat, 1, actions[:, None])[:, 0]


def _mask_self(mat, fill, eye=None):
    """Self links set to ``fill``; ``eye`` (rows, N) marks each row's own
    column (default: the square identity, rows 0..N-1)."""
    if eye is None:
        eye = torch.eye(mat.shape[-1], dtype=torch.bool, device=mat.device)
    return torch.where(eye, torch.full_like(mat, fill), mat)


def policy_probs(q, gamma, u, eye=None):
    """Eq. 4 with shifted normalisation; self links masked.
    q: (N, N), u: (N, N) uniform noise (a shard's rows with its ``eye``)."""
    qs = _mask_self(q, float("inf"), eye)
    qmin = torch.amin(qs, dim=1, keepdim=True)
    q_shift = _mask_self(q - qmin + 1e-6, 0.0, eye)
    q_norm = q_shift / torch.sum(q_shift, dim=1, keepdim=True)
    mixed = _mask_self(gamma * q_norm + (1.0 - gamma) * u, 0.0, eye)
    return mixed / torch.sum(mixed, dim=1, keepdim=True)


def ucb_actions(q, counts, episode: int, c: float, eye=None):
    """UCB1 over incoming edges: running mean reward plus an exploration
    bonus; unexplored actions score +inf."""
    mean = q / torch.clamp_min(counts, 1.0)
    log_e = torch.log(torch.full((), episode + 2.0, dtype=torch.float32,
                                 device=q.device))
    bonus = c * torch.sqrt(log_e / torch.clamp_min(counts, 1e-9))
    score = torch.where(counts > 0, mean + bonus,
                        torch.full_like(mean, float("inf")))
    score = _mask_self(score, float("-inf"), eye)
    return torch.argmax(score, dim=1)


def _q_update(q, buf_actions, buf_rewards):
    """Eq. 6: Q_i(a) += mean of buffered global rewards with action a."""
    n = q.shape[1]
    onehot = torch.nn.functional.one_hot(buf_actions.long(), n).to(
        torch.float32)                                         # (N, M, A)
    sums = torch.einsum("nma,nm->na", onehot, buf_rewards)
    counts = torch.sum(onehot, dim=1)
    means = torch.where(counts > 0, sums / torch.clamp_min(counts, 1.0),
                        torch.zeros_like(sums))
    return q + means


def init_rl_state(n: int, cfg: RLConfig = RLConfig(),
                  device="cpu") -> RLState:
    """Cold-start agent state (paper: small equal Q values, empty buffers)."""
    m = cfg.buffer_size
    f32 = dict(dtype=torch.float32, device=device)
    return RLState(
        q=torch.full((n, n), cfg.q_init, **f32),
        counts=torch.zeros((n, n), **f32),
        buf_actions=torch.zeros((n, m), dtype=torch.int32, device=device),
        buf_rewards=torch.zeros((n, m), **f32),
        buf_local=torch.zeros((n, m), **f32),
        r_net_prev=torch.zeros((), **f32),
        t=torch.zeros((), dtype=torch.int32, device=device),
    )


def discover_graph(local_r, p_fail, cfg: RLConfig = RLConfig(),
                   init_state: Optional[RLState] = None,
                   n_episodes: Optional[int] = None,
                   draws: Optional[RLDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   rules=None) -> GraphResult:
    """Run Algorithm 1 on the device of ``local_r``.

    local_r: (N, N) r_ij (Eq. 2); p_fail: (N, N) P_D for diagnostics.
    ``init_state`` warm-starts from a previous :class:`RLState` (a sharded
    run's placed state rides back in). The mixed policy takes ``draws`` (or
    draws them from ``generator``). ``rules`` shards the agents (see the
    module docstring): the result's ``q`` and ``state`` are then placed,
    ``in_edge`` and the episode means whole."""
    n = local_r.shape[0]
    n_ep = cfg.n_episodes if n_episodes is None else n_episodes
    with obs.span("discover", episodes=int(n_ep), agents=int(n),
                  warm=init_state is not None, policy=cfg.policy):
        if cfg.policy != "ucb" and draws is None:
            if generator is None:
                raise ValueError("the mixed policy needs draws or a "
                                 "generator")
            draws = draw_rl(generator, n, n_ep)
        return _discover_impl(local_r, p_fail, cfg, init_state, n_ep, draws,
                              rules)


def _discover_impl(local_r, p_fail, cfg: RLConfig,
                   init_state: Optional[RLState], n_ep: int,
                   draws: Optional[RLDraws], rules=None) -> GraphResult:
    """The episode loop of :func:`discover_graph`, without its span (the
    orchestrator's scan chunk calls it directly)."""
    n = local_r.shape[0]
    part = sh.ClientSlice(rules, n)
    local_r, p_fail = part.rows((local_r, p_fail))        # (n_local, N)
    dev = local_r.device
    m = cfg.buffer_size
    use_ucb = cfg.policy == "ucb"
    eye = part.self_mask(dev) if part.sharded else None
    s = part.rows(init_state if init_state is not None
                  else init_rl_state(n, cfg, dev))
    q, counts = s.q.clone(), s.counts.clone()
    buf_a, buf_r, buf_l = (s.buf_actions.clone(), s.buf_rewards.clone(),
                           s.buf_local.clone())
    r_net_prev, t = s.r_net_prev.clone(), s.t.clone()
    ep_r, ep_p = [], []
    for e in range(n_ep):
        gamma = _gamma(t, cfg)
        if use_ucb:
            actions = ucb_actions(q, counts, e, cfg.ucb_c, eye)
        else:
            probs = policy_probs(q, gamma, part.rows(draws.u[e]), eye)
            actions = torch.argmax(torch.log(probs + 1e-12)
                                   + part.rows(draws.gumbel[e]), dim=1)
        r_loc = _row_lookup(local_r, actions)                    # (N,)
        # Eq. 3's episode mean and the P_D diagnostic: one all-reduce
        mean_r, mean_pf = part.mean((r_loc, _row_lookup(p_fail, actions)))
        r_glob = rw.global_rewards(r_loc, gamma, r_net_prev, mean_r)
        hot = torch.nn.functional.one_hot(actions, n).to(counts.dtype)
        counts = counts + hot
        slot = e % m
        buf_a[:, slot] = actions.to(torch.int32)
        buf_r[:, slot] = r_glob
        buf_l[:, slot] = r_loc
        if use_ucb:
            # UCB keeps running reward sums directly (no buffer flush)
            q = q + hot * r_glob[:, None]
        elif slot == m - 1:
            r_net_prev = part.mean(rw.frequent_local_reward(buf_a, buf_l, n))
            q = _q_update(q, buf_a, buf_r)
            t = t + 1
        ep_r.append(mean_r)
        ep_p.append(mean_pf)

    # Eq. 7: final links = argmax accumulated reward (self masked); UCB takes
    # the running mean over tried actions.
    if use_ucb:
        qf = q / torch.clamp_min(counts, 1.0)
        qf = torch.where(counts == 0, torch.full_like(qf, float("-inf")), qf)
    else:
        qf = q
    in_edge = part.gather(torch.argmax(_mask_self(qf, float("-inf"), eye),
                                       dim=1))
    state = part.place(RLState(q, counts, buf_a, buf_r, buf_l, r_net_prev, t))
    empty = local_r.new_zeros((0,))
    return GraphResult(in_edge, state.q,
                       torch.stack(ep_r) if ep_r else empty,
                       torch.stack(ep_p) if ep_p else empty, state)


def uniform_graph(generator: torch.Generator, n: int) -> torch.Tensor:
    """Baseline: each receiver picks a transmitter uniformly at random."""
    offs = torch.randint(1, n, (n,), generator=generator,
                         device=generator.device)
    return (torch.arange(n, device=offs.device) + offs) % n
