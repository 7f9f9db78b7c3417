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

Under the model plane (``transformer._Plan.moe``) a rank runs the layer
with a :class:`Part`: the router on whole rows, as every rank of "model"
does alike; the dispatch and the expert products for its experts only
(expert-parallel) or for its d_ff columns of all of them (the weights it
is given); the output its partial sum over "model", the shared experts
left to the caller. A capacity group may span data ranks (a rank holds
consecutive batch rows of the token stream): each rank then ranks its
choices after the lower data ranks' choices in the group (their counts
from one small all-gather) and fills only its own tokens' slots, the
others staying zero (the expert MLP maps a zero row to zero), so no token
crosses ranks. Where a rank's tokens neither tile nor are tiled by the
groups, it routes them in segments of gcd(T, its tokens), each inside one
group, ranked after the group's earlier segments. The load-balance loss's
two (E,) sums and token count are summed over the data ranks before its
product.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

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


class Part(NamedTuple):
    """One rank's part of an MoE layer under the model plane."""
    experts: tuple      # (e0, e1): the experts whose slots this rank fills
    tokens: int         # T: the tokens of a whole group (sets the capacity)
    xe: torch.Tensor    # the expert branch's input (through "model"'s copy)
    gates: Any          # the router gates -> as the expert branch reads them
    offsets: Any        # None, or (G, E) counts -> the group's earlier ones
    total: Any          # None, or the aux sums -> their sums over data ranks


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


def group_size(cfg, b: int, s: int) -> int:
    """T, the tokens of one capacity group of a (b, s) batch: a batch row
    or ``cfg.moe_group_size`` tokens (einsum); all b*s tokens or groups of
    ``moe_group_size`` when b*s exceeds it (gather)."""
    t, gs = b * s, cfg.moe_group_size
    if cfg.moe_dispatch == "gather":
        return t // (max(1, t // gs) if gs and t > gs else 1)
    return t // (max(1, t // gs) if gs else b)


def _segment(t: int, n: int, part) -> int:
    """The tokens a routing row holds, of ``n`` tokens in groups of ``t``:
    a group, or all n where a group is larger; under ``part`` gcd(t, n),
    so a segment of a group that spans data ranks lies inside this
    rank's tokens and inside one group."""
    return min(t, n) if part is None else math.gcd(t, n)


def routing(params, x, cfg, part=None) -> Routing:
    """The einsum dispatch's routing of x (B, S, D): groups of batch rows,
    or of ``cfg.moe_group_size`` tokens; under ``part`` this rank's
    segments of groups of ``part.tokens``, ranked after the lower data
    ranks' choices."""
    b, s, d = x.shape
    t = group_size(cfg, b, s) if part is None else part.tokens
    tl = _segment(t, b * s, part)
    xt = x.reshape((b * s) // tl, tl, d)
    g, _, _ = xt.shape
    probs = router_probs(params, xt.reshape(g * tl, d))
    return decide(probs.reshape(g, tl, cfg.n_experts), cfg,
                  t, None if part is None else part.offsets)


def decide(probs, cfg, tokens=None, offsets=None) -> Routing:
    """The routing decisions of router probabilities (G, T, E): top-k,
    renormalised gates, ranks within each expert and capacity. ``tokens``:
    a whole group's (default T); ``offsets``: (G, E) choice counts ->
    the counts that precede these T tokens in their groups."""
    g, t, e = probs.shape
    k = cfg.experts_per_token
    mask = _top_k_mask(probs, k)
    gates = probs * mask
    gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
    cap = capacity(k, tokens or t, cfg.capacity_factor, e)
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    if offsets is not None:
        pos = pos + offsets(pos[:, -1] + 1)[:, None]
    keep = mask & (pos < cap)
    return Routing(probs, mask, gates, pos, keep, cap)


def _aux(chosen, probs, part, e: int, k: int):
    """The Switch loss E * sum_e f_e * p_e / k and the mean probabilities
    (E,) from the choices (N, E) and probabilities (N, E) of N tokens: two
    sums and the count, summed over the data ranks under ``part``."""
    n = torch.full((1,), chosen.shape[0], dtype=torch.float32,
                   device=chosen.device)
    sums = torch.cat([torch.sum(chosen, 0), torch.sum(probs, 0), n])
    if part is not None and part.total is not None:
        sums = part.total(sums)
    frac_tokens, mean_probs = sums[:e] / sums[-1], sums[e:2 * e] / sums[-1]
    aux = e * torch.sum(frac_tokens * mean_probs) / k
    return aux.to(torch.float32), mean_probs


def moe_forward(params, x, cfg, part=None) -> MoEOutput:
    """x: (B, S, D) -> MoEOutput (y (B, S, D) in x's dtype, the float32 aux
    loss E * sum_e f_e * p_e / k, the (E,) mean router probabilities).
    Under ``part`` y is this rank's partial sum of the routed experts alone
    (the gather dispatch's in float32)."""
    if cfg.moe_dispatch == "gather":
        return _moe_forward_gather(params, x, cfg, part)
    if cfg.moe_dispatch != "einsum":
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    r = routing(params, x, cfg, part)
    g, t, _ = r.probs.shape
    xt, gates, (e0, e1) = x.reshape(g, t, d), r.gates, (0, e)
    if part is not None:
        gates, (e0, e1) = part.gates(gates), part.experts
        if part.xe is not x:
            xt = part.xe.reshape(g, t, d)
    keep, pos = r.keep[..., e0:e1], r.pos[..., e0:e1]
    # (G,T,E,C) one-hot of each kept choice's slot (this rank's experts),
    # scattered straight into x's dtype; a dropped choice writes its 0 to
    # slot 0
    dispatch = torch.zeros((g, t, e1 - e0, r.cap), dtype=x.dtype,
                           device=x.device)
    dispatch.scatter_(-1, torch.where(keep, pos, 0)[..., None],
                      keep[..., None].to(x.dtype))
    combine = dispatch * gates[..., e0:e1].to(x.dtype)[..., None]

    xe = torch.einsum("gtd,gtec->gecd", xt, dispatch)        # (G,E,C,D)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe,
                            params["wi_gate"].to(x.dtype))) * \
        torch.einsum("gecd,edf->gecf", xe, params["wi_up"].to(x.dtype))
    ye = torch.einsum("gecf,efd->gecd", h, params["wo"].to(x.dtype))
    y = torch.einsum("gecd,gtec->gtd", ye, combine).reshape(b, s, d)

    if part is None and "shared" in params:
        y = y + shared_branch(params, x)

    aux, mean_probs = _aux(r.mask.reshape(g * t, e).to(torch.float32),
                           r.probs.reshape(g * t, e), part, e, k)
    return MoEOutput(y, aux, mean_probs)


def shared_branch(params, x):
    """The always-on shared experts: one SwiGLU MLP of width
    n_shared_experts * moe_d_ff."""
    sp = params["shared"]
    h = F.silu(cm.dense(x, sp["wi_gate"].to(x.dtype))) * \
        cm.dense(x, sp["wi_up"].to(x.dtype))
    return cm.dense(h, sp["wo"].to(x.dtype))


def _gather_dispatch(params, xt, cfg, cap: int, part=None, xe=None):
    """Gather dispatch of each token group. xt: (G, T, D); returns y
    (G, T, D) in float32, probs (G, T, E) and the top-k experts (G, T, k).
    Under ``part`` the experts read ``xe`` (G, T, D), the choices are
    ranked after the lower data ranks' and only this rank's experts' slots
    are filled."""
    g, t, d = xt.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    dev = xt.device
    probs = router_probs(params, xt.reshape(g * t, d)).reshape(g, t, e)
    top_p, top_e = top_k(probs, k)                           # (G,T,k)
    gates = top_p / torch.clamp_min(torch.sum(top_p, -1, keepdim=True), 1e-9)
    e0, e1 = 0, e
    if part is not None:
        gates, (e0, e1) = part.gates(gates), part.experts
        xt = xe
    el = e1 - e0

    eid_s, order = torch.sort(top_e.reshape(g, t * k), dim=-1, stable=True)
    tid_s = order // k                  # choice i belongs to token i // k
    gat_s = torch.gather(gates.reshape(g, t * k), 1, order)
    first = torch.searchsorted(
        eid_s, torch.arange(e, device=dev).expand(g, e).contiguous())
    rank = torch.arange(t * k, device=dev) - torch.gather(first, 1, eid_s)
    if part is not None and part.offsets is not None:
        counts = torch.diff(first, append=torch.full_like(first[:, :1],
                                                          t * k))
        rank = rank + torch.gather(part.offsets(counts), 1, eid_s)
    keep = rank < cap
    if el != e:
        keep = keep & (eid_s >= e0) & (eid_s < e1)
    slot = torch.where(keep, (eid_s - e0) * cap + rank, el * cap)  # (G,T*k)

    # each group's (E*C + 1, D) buffer, flat; its row E*C is the sink of
    # the dropped choices (and of the other ranks' experts) and is cut off
    rows = el * cap + 1
    flat = (slot + rows * torch.arange(g, device=dev)[:, None]).reshape(-1)
    xs = torch.gather(xt, 1, tid_s[..., None].expand(g, t * k, d))
    xbuf = xt.new_zeros((g * rows, d)).index_put((flat,), xs.reshape(-1, d))
    xe = xbuf.reshape(g, rows, d)[:, :el * cap].reshape(g, el, cap, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe,
                            params["wi_gate"].to(xt.dtype))) * \
        torch.einsum("gecd,edf->gecf", xe, params["wi_up"].to(xt.dtype))
    ye = torch.einsum("gecf,efd->gecd", h, params["wo"].to(xt.dtype))
    ybuf = ye.reshape(g, el * cap, d)

    src = torch.clamp_max(slot, el * cap - 1)
    contrib = torch.gather(ybuf, 1, src[..., None].expand(g, t * k, d)) * \
        (gat_s * keep).to(xt.dtype)[..., None]
    # back to token order (a permutation: no two writes meet), then each
    # token's k contributions summed in float32
    back = torch.zeros_like(contrib).scatter(
        1, order[..., None].expand(g, t * k, d), contrib)
    y = back.reshape(g, t, k, d).to(torch.float32).sum(2)
    return y, probs, top_e


def _moe_forward_gather(params, x, cfg, part=None):
    """Sort and index dispatch: O(T*k + E*C) memory instead of O(T*E*C).

    ``cfg.moe_group_size`` > 0 (and below B*S) dispatches each group of
    that many tokens on its own, so the sort stays group-local; otherwise
    all B*S tokens are one group. Each token's k contributions are summed
    in float32 and rounded once (under ``part`` left in float32)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    tg = group_size(cfg, b, s) if part is None else part.tokens
    tl = _segment(tg, b * s, part)
    g = (b * s) // tl
    cap = capacity(k, tg, cfg.capacity_factor, e)
    xt = x.reshape(g, tl, d)
    # where the branch reads the router's input itself (one rank), one
    # view of it: the gradients then meet as without a part
    xe = xt if part is None or part.xe is x else part.xe.reshape(g, tl, d)
    y, probs, top_e = _gather_dispatch(params, xt, cfg, cap, part, xe)
    y = y.reshape(b, s, d)
    if part is None:
        y = y.to(x.dtype)
        if "shared" in params:
            y = y + shared_branch(params, x)

    chosen = torch.zeros((b * s, e), dtype=torch.float32, device=x.device)
    chosen.scatter_(1, top_e.reshape(b * s, k), 1.0)
    aux, mean_probs = _aux(chosen, probs.reshape(b * s, e), part, e, k)
    return MoEOutput(y, aux, mean_probs)
