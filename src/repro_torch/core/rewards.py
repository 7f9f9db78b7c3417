"""Reward formulation (paper Eqs. 2, 3, 5; mirrors ``repro.core.rewards``)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    alpha1: float = 1.0    # weight on dataset dissimilarity lambda_ij
    alpha2: float = 2.0    # weight on failed-transmission probability
    # "paper" (Eq. 2) | "expected": a1*lam*(1-P_D) - a2*P_D
    kind: str = "paper"


def local_reward_matrix(lam, p_fail, cfg: RewardConfig = RewardConfig()):
    """Eq. 2 for all pairs: r[i, j] = a1 * lambda_ij - a2 * P_D(i, j);
    self links get -1e9 so they are never preferred."""
    lam = lam.to(torch.float32)
    if cfg.kind == "expected":
        r = cfg.alpha1 * lam * (1.0 - p_fail) - cfg.alpha2 * p_fail
    else:
        r = cfg.alpha1 * lam - cfg.alpha2 * p_fail
    r.fill_diagonal_(-1e9)
    return r


def global_rewards(local_r, gamma, r_net_prev, mean_r=None):
    """Eq. 3 over agents: R^e_i = r_i + gamma * (mean(r) - r_net_prev)."""
    if mean_r is None:
        mean_r = torch.mean(local_r)
    return local_r + gamma * (mean_r - r_net_prev)


def frequent_local_reward(buf_actions, buf_rewards_local, n_actions: int):
    """Per-agent mean local reward of its most frequent buffered action
    (Eq. 5's inner term). buf_*: (N, M) -> (N,)."""
    onehot = torch.nn.functional.one_hot(buf_actions.long(), n_actions).to(
        torch.float32)                                    # (N, M, A)
    counts = torch.sum(onehot, dim=1)                     # (N, A)
    freq_action = torch.argmax(counts, dim=-1)            # (N,)
    match = buf_actions == freq_action[:, None]           # (N, M)
    sums = torch.sum(buf_rewards_local * match, dim=1)
    cnt = torch.clamp_min(torch.sum(match, dim=1), 1)
    return sums / cnt
