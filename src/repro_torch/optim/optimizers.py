"""Minimal, tree-native optimizers (mirrors ``repro.optim.optimizers``).

Each update is a plain function over the port's parameter trees (nested
dicts and tuples, ``models.common.tree_map``) that returns new tensors and
never writes into its inputs: callers may hold one tree in several places
(the federated-LLM example starts every client from the same global tree), as
the reference's immutable arrays allow. States mirror the parameter tree;
``OptState.step`` counts the updates made, as an int32 tensor.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


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


def global_norm(tree):
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Returns (grads scaled so their global norm is at most ``max_norm``,
    the norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def sgd(params, grads, state: OptState, lr):
    new_params = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
    return new_params, OptState(state.step + 1, (), ())


@torch.no_grad()
def sgd_momentum(params, grads, state: OptState, lr, beta: float = 0.9):
    mu = tree_map(lambda m, g: beta * m + g.to(m.dtype), state.mu, grads)
    new_params = tree_map(lambda p, m: p - lr * m.to(p.dtype), params, mu)
    return new_params, OptState(state.step + 1, mu, ())


@torch.no_grad()
def adamw(params, grads, state: OptState, lr, *, beta1=0.9, beta2=0.95,
          eps=1e-8, weight_decay=0.1):
    """AdamW with bias correction from the float32 step count after this
    update (``1 - beta ** t`` in float32, as the reference computes it).
    Leaf by leaf, so the temporaries are one leaf's size."""
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - torch.pow(beta1, t)
    c2 = 1.0 - torch.pow(beta2, t)
    mu = tree_map(lambda m, g: beta1 * m + (1 - beta1) * g.to(m.dtype),
                  state.mu, grads)
    nu = tree_map(lambda v, g: beta2 * v + (1 - beta2)
                  * torch.square(g.to(v.dtype)), state.nu, grads)

    def upd(p, m, v):
        mh = m / c1
        vh = v / c2
        return (p - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * p)
                ).to(p.dtype)
    new_params = tree_map(upd, params, mu, nu)
    return new_params, OptState(step, mu, nu)


def opt_update(kind: str, params, grads, state: OptState, lr, **kw):
    if kind == "sgd":
        return sgd(params, grads, state, lr)
    if kind == "momentum":
        return sgd_momentum(params, grads, state, lr, **kw)
    if kind == "adamw":
        return adamw(params, grads, state, lr, **kw)
    raise ValueError(kind)
