"""Minimal, tree-native optimizers (mirrors ``repro.optim.optimizers``).

Each update is a plain function over the port's parameter trees (nested
dicts and tuples, ``models.common.tree_map``) that returns new tensors and
never writes into its inputs: callers may hold one tree in several places
(the federated-LLM example starts every client from the same global tree), as
the reference's immutable arrays allow. With ``donate=True`` it writes each
new leaf into the leaf it replaces instead, as it is made, and returns the
given trees: the counterpart of the reference's ``donate_argnums``, for a
caller that holds the trees nowhere else (the training launchers). Both
modes compute the same expressions, so their results are bit for bit equal.
States mirror the parameter tree; ``OptState.step`` counts the updates made,
as an int32 tensor.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.sharding import SCALAR


class OptState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # first moment (or momentum); zeros like params
    nu: Any              # second moment; () for sgd/momentum


def _zeros_like(params):
    return tree_map(torch.zeros_like, params)


def init_opt_state(params, kind: str) -> OptState:
    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if kind == "sgd":
        return OptState(step, (), ())
    if kind == "momentum":
        return OptState(step, _zeros_like(params), ())
    if kind == "adamw":
        return OptState(step, _zeros_like(params), _zeros_like(params))
    raise ValueError(kind)


def _update(fn, tree, *rest, donate: bool):
    """The tree of ``fn(x, *ys, out=o)`` over the leaves of ``tree`` and
    ``rest``, ``fn`` writing its result into ``o``: a new tensor like ``x``,
    or with ``donate`` ``x`` itself, so that only one leaf's temporaries
    are alive at a time."""
    if donate:
        for x, *ys in zip(tree_leaves(tree), *map(tree_leaves, rest)):
            fn(x, *ys, out=x)
        return tree
    return tree_map(lambda x, *ys: fn(x, *ys, out=torch.empty_like(x)),
                    tree, *rest)


def global_norm(tree, *, counted=None, reduce=None):
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.

    For a tree of one rank's shards (the model plane): ``counted`` says,
    leaf by leaf, whether this rank's shard adds to the sum (a leaf stored
    whole on several ranks adds once), and ``reduce`` sums the ranks'
    totals (an all-reduce) before the square root."""
    leaves = tree_leaves(tree)
    if counted is not None:
        leaves = [x for x, c in zip(leaves, counted) if c]
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves]
    total = torch.sum(torch.stack(sq)) if sq else \
        torch.zeros((), device=tree_leaves(tree)[0].device)
    if reduce is not None:
        total = reduce(total)
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, *, donate: bool = False,
                        counted=None, reduce=None):
    """Returns (grads scaled so their global norm is at most ``max_norm``,
    the norm before scaling); ``counted`` and ``reduce`` as for
    :func:`global_norm`."""
    norm = global_norm(grads, counted=counted, reduce=reduce)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return _update(lambda g, out: torch.mul(g, scale, out=out), grads,
                   donate=donate), norm


@torch.no_grad()
def sgd(params, grads, state: OptState, lr, *, donate=False):
    new_params = _update(
        lambda p, g, out: torch.sub(p, lr * g.to(p.dtype), out=out), params,
        grads, donate=donate)
    return new_params, OptState(state.step + 1, (), ())


@torch.no_grad()
def sgd_momentum(params, grads, state: OptState, lr, beta: float = 0.9, *,
                 donate=False):
    mu = _update(lambda m, g, out: torch.add(beta * m, g.to(m.dtype), out=out),
                 state.mu, grads, donate=donate)
    new_params = _update(
        lambda p, m, out: torch.sub(p, lr * m.to(p.dtype), out=out), params,
        mu, donate=donate)
    return new_params, OptState(state.step + 1, mu, ())


@torch.no_grad()
def adamw(params, grads, state: OptState, lr, *, beta1=0.9, beta2=0.95,
          eps=1e-8, weight_decay=0.1, donate=False):
    """AdamW with bias correction from the float32 step count after this
    update (``1 - beta ** t`` in float32, as the reference computes it).
    Leaf by leaf, with at most two temporaries of the leaf's size alive."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(beta1, t)
    c2 = 1.0 - torch.pow(beta2, t)
    mu = _update(lambda m, g, out: torch.add(
        beta1 * m, (1 - beta1) * g.to(m.dtype), out=out),
        state.mu, grads, donate=donate)
    nu = _update(lambda v, g, out: torch.add(
        beta2 * v, torch.square(g.to(v.dtype)).mul_(1 - beta2), out=out),
        state.nu, grads, donate=donate)

    def upd(p, m, v, out):
        # p - lr * (m / c1 / (sqrt(v / c2) + eps) + weight_decay * p), the
        # same roundings, with the temporaries reused in place
        u = (m / c1).div_((v / c2).sqrt_().add_(eps))
        u.add_(weight_decay * p).mul_(lr)
        return torch.sub(p, u, out=out)
    new_params = _update(upd, params, mu, nu, donate=donate)
    return new_params, OptState(step, mu, nu)


def opt_update(kind: str, params, grads, state: OptState, lr, *,
               donate=False, **kw):
    if kind == "sgd":
        return sgd(params, grads, state, lr, donate=donate)
    if kind == "momentum":
        return sgd_momentum(params, grads, state, lr, donate=donate, **kw)
    if kind == "adamw":
        return adamw(params, grads, state, lr, donate=donate, **kw)
    raise ValueError(kind)


def opt_state_logical(params_logical, kind: str) -> OptState:
    """Logical-axis tree of :class:`OptState` mirroring the params tree."""
    if kind == "sgd":
        return OptState(SCALAR, (), ())
    if kind == "momentum":
        return OptState(SCALAR, params_logical, ())
    return OptState(SCALAR, params_logical, params_logical)
