"""Mixture-of-Experts layer: top-k router and GShard capacity dispatch
(mirrors ``repro.models.moe``).

Tokens are viewed as (G groups, T tokens a group). Each expert takes at most
C = max(1, round(k * T * capacity_factor / E)) choices of a group (Python's
``round``: halves go to even); a (token, expert) choice ranked C or later
among its expert's choices in the group, in token order, is dropped, and
only the other choices' outputs (and the shared experts') reach the
residual. The router runs in float32; the Switch load-balance loss is
returned beside the output.

Two dispatches (``cfg.moe_dispatch``), the same function where nothing
drops:
  * "einsum": the GShard one-hot (G, T, E, C) dispatch and combine tensors
    and four einsums. A group is a batch row, or ``cfg.moe_group_size``
    tokens.
  * "gather": the T*k (token, expert) choices stably sorted by expert, each
    ranked from its expert's first occurrence, scattered into an
    (E*C + 1, D) buffer whose last row takes the dropped choices, and the
    expert outputs gathered back. One group of all B*S tokens, or groups of
    ``cfg.moe_group_size`` tokens (the reference vmaps the group; here the
    groups are a leading batch axis).

Top-k is ``jax.lax.top_k``'s: the k largest probabilities in descending
order, ties to the lower expert index (a stable descending sort;
``torch.topk`` leaves the order of equal values unspecified).

Plain tensor functions over a parameter tree, on the caller's device; the
expert products are ``torch.einsum`` (the reference computes them outside
any kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


class MoEOutput(NamedTuple):
    y: torch.Tensor
    aux_loss: torch.Tensor
    router_probs_mean: torch.Tensor  # (E,) mean routing prob: load diagnostics


class Routing(NamedTuple):
    """The einsum dispatch's routing decisions, each (G, T, E)."""
    probs: torch.Tensor      # float32 router probabilities
    mask: torch.Tensor       # bool: the token's top-k experts
    gates: torch.Tensor      # float32: the chosen probabilities renormalised
    pos: torch.Tensor        # int64: the choice's rank among its expert's
    keep: torch.Tensor       # bool: chosen and ranked below the capacity
    cap: int                 # C, the capacity per expert and group


def moe_specs(cfg):
    """Parameter Spec tree for one MoE layer."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    p = {
        "router": cm.Spec((d, e), ("d_model", "experts")),
        "wi_gate": cm.Spec((e, d, f), ("experts", "d_model", "d_ff")),
        "wi_up": cm.Spec((e, d, f), ("experts", "d_model", "d_ff")),
        "wo": cm.Spec((e, f, d), ("experts", "d_ff", "d_model"), "scaled"),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff)
        p["shared"] = {
            "wi_gate": cm.Spec((d, fs), ("d_model", "d_ff")),
            "wi_up": cm.Spec((d, fs), ("d_model", "d_ff")),
            "wo": cm.Spec((fs, d), ("d_ff", "d_model"), "scaled"),
        }
    return p


def capacity(k: int, t: int, capacity_factor: float, e: int) -> int:
    """Choices each expert takes from a group of ``t`` tokens."""
    return int(max(1, round(k * t * capacity_factor / e)))


def router_probs(params, x2d):
    """(N, D) tokens -> (N, E) float32 router probabilities."""
    logits = x2d.to(torch.float32) @ params["router"].to(torch.float32)
    return torch.softmax(logits, dim=-1)


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order and their indices, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_mask(probs, k: int):
    """(..., E) probs -> (..., E) bool mask of the top-k experts per token."""
    _, idx = top_k(probs, k)
    return torch.zeros_like(probs, dtype=torch.bool).scatter_(-1, idx, True)


def routing(params, x, cfg) -> Routing:
    """The einsum dispatch's routing of x (B, S, D): groups of batch rows,
    or of ``cfg.moe_group_size`` tokens."""
    b, s, d = x.shape
    n_groups = max(1, (b * s) // cfg.moe_group_size) \
        if cfg.moe_group_size else b
    xt = x.reshape(n_groups, (b * s) // n_groups, d)
    g, t, _ = xt.shape
    probs = router_probs(params, xt.reshape(g * t, d))
    return decide(probs.reshape(g, t, cfg.n_experts), cfg)


def decide(probs, cfg) -> Routing:
    """The routing decisions of router probabilities (G, T, E): top-k,
    renormalised gates, ranks within each expert and capacity."""
    g, t, e = probs.shape
    k = cfg.experts_per_token
    mask = _top_k_mask(probs, k)
    gates = probs * mask
    gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
    cap = capacity(k, t, cfg.capacity_factor, e)
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keep = mask & (pos < cap)
    return Routing(probs, mask, gates, pos, keep, cap)


def moe_forward(params, x, cfg) -> MoEOutput:
    """x: (B, S, D) -> MoEOutput (y (B, S, D) in x's dtype, the float32 aux
    loss E * sum_e f_e * p_e / k, the (E,) mean router probabilities)."""
    if cfg.moe_dispatch == "gather":
        return _moe_forward_gather(params, x, cfg)
    if cfg.moe_dispatch != "einsum":
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    r = routing(params, x, cfg)
    g, t, _ = r.probs.shape
    xt = x.reshape(g, t, d)
    # (G,T,E,C) one-hot of each kept choice's slot, scattered straight into
    # x's dtype; a dropped choice writes its 0 to slot 0
    dispatch = torch.zeros((g, t, e, r.cap), dtype=x.dtype, device=x.device)
    dispatch.scatter_(-1, torch.where(r.keep, r.pos, 0)[..., None],
                      r.keep[..., None].to(x.dtype))
    combine = dispatch * r.gates.to(x.dtype)[..., None]

    xe = torch.einsum("gtd,gtec->gecd", xt, dispatch)        # (G,E,C,D)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe,
                            params["wi_gate"].to(x.dtype))) * \
        torch.einsum("gecd,edf->gecf", xe, params["wi_up"].to(x.dtype))
    ye = torch.einsum("gecf,efd->gecd", h, params["wo"].to(x.dtype))
    y = torch.einsum("gecd,gtec->gtd", ye, combine).reshape(b, s, d)

    if "shared" in params:
        y = y + _shared_branch(params, x)

    frac_tokens = torch.mean(r.mask.to(torch.float32), dim=(0, 1))  # (E,)
    mean_probs = torch.mean(r.probs, dim=(0, 1))                     # (E,)
    aux = e * torch.sum(frac_tokens * mean_probs) / k
    return MoEOutput(y, aux.to(torch.float32), mean_probs)


def _shared_branch(params, x):
    """The always-on shared experts: one SwiGLU MLP of width
    n_shared_experts * moe_d_ff."""
    sp = params["shared"]
    h = F.silu(cm.dense(x, sp["wi_gate"].to(x.dtype))) * \
        cm.dense(x, sp["wi_up"].to(x.dtype))
    return cm.dense(h, sp["wo"].to(x.dtype))


def _gather_dispatch(params, xt, cfg, cap: int):
    """Gather dispatch of each token group. xt: (G, T, D); returns y
    (G, T, D), probs (G, T, E) and the top-k experts (G, T, k)."""
    g, t, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    dev = xt.device
    probs = router_probs(params, xt.reshape(g * t, d)).reshape(g, t, e)
    top_p, top_e = top_k(probs, k)                           # (G,T,k)
    gates = top_p / torch.clamp_min(torch.sum(top_p, -1, keepdim=True), 1e-9)

    eid_s, order = torch.sort(top_e.reshape(g, t * k), dim=-1, stable=True)
    tid_s = order // k                  # choice i belongs to token i // k
    gat_s = torch.gather(gates.reshape(g, t * k), 1, order)
    first = torch.searchsorted(
        eid_s, torch.arange(e, device=dev).expand(g, e).contiguous())
    rank = torch.arange(t * k, device=dev) - torch.gather(first, 1, eid_s)
    keep = rank < cap
    slot = torch.where(keep, eid_s * cap + rank, e * cap)    # (G,T*k)

    # each group's (E*C + 1, D) buffer, flat; its row E*C is the sink of
    # the dropped choices and is cut off
    rows = e * cap + 1
    flat = (slot + rows * torch.arange(g, device=dev)[:, None]).reshape(-1)
    xs = torch.gather(xt, 1, tid_s[..., None].expand(g, t * k, d))
    xbuf = xt.new_zeros((g * rows, d)).index_put((flat,), xs.reshape(-1, d))
    xe = xbuf.reshape(g, rows, d)[:, :e * cap].reshape(g, e, cap, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe,
                            params["wi_gate"].to(xt.dtype))) * \
        torch.einsum("gecd,edf->gecf", xe, params["wi_up"].to(xt.dtype))
    ye = torch.einsum("gecf,efd->gecd", h, params["wo"].to(xt.dtype))
    ybuf = ye.reshape(g, e * cap, d)

    src = torch.clamp_max(slot, e * cap - 1)
    contrib = torch.gather(ybuf, 1, src[..., None].expand(g, t * k, d)) * \
        (gat_s * keep).to(xt.dtype)[..., None]
    # back to token order (a permutation: no two writes meet), then each
    # token's k contributions summed in float32 and rounded once
    back = torch.zeros_like(contrib).scatter(
        1, order[..., None].expand(g, t * k, d), contrib)
    y = back.reshape(g, t, k, d).to(torch.float32).sum(2).to(xt.dtype)
    return y, probs, top_e


def _moe_forward_gather(params, x, cfg):
    """Sort and index dispatch: O(T*k + E*C) memory instead of O(T*E*C).

    ``cfg.moe_group_size`` > 0 (and below B*S) dispatches each group of
    that many tokens on its own, so the sort stays group-local; otherwise
    all B*S tokens are one group."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    g = 1
    if cfg.moe_group_size and t > cfg.moe_group_size:
        g = max(1, t // cfg.moe_group_size)
    tg = t // g
    cap = capacity(k, tg, cfg.capacity_factor, e)
    y, probs, top_e = _gather_dispatch(params, x.reshape(g, tg, d), cfg, cap)
    y = y.reshape(b, s, d)

    if "shared" in params:
        y = y + _shared_branch(params, x)

    chosen = torch.zeros((t, e), dtype=torch.float32, device=x.device)
    chosen.scatter_(1, top_e.reshape(t, k), 1.0)
    frac_tokens = torch.mean(chosen, dim=0)                  # (E,)
    mean_probs = torch.mean(probs.reshape(t, e), dim=0)
    aux = e * torch.sum(frac_tokens * mean_probs) / k
    return MoEOutput(y, aux.to(torch.float32), mean_probs)
