"""Declarative parameter specs and their initialisers (mirrors the part of
``repro.models.common`` the autoencoder uses).

Parameters are nested dicts of tensors in the JAX package's layout. The
helpers :func:`tree_map` and :func:`tree_leaves` walk such dicts.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Spec(NamedTuple):
    shape: tuple
    logical: tuple          # logical axis name (or None) per dim
    init: str = "normal"    # normal | zeros | he


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (JAX's flatten order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A nested dict shaped like ``tree`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return next(it)
    return walk(tree)


def value_and_grad(fn, params, *args):
    """``fn(params, *args)`` -> scalar tensor; returns ``(value, grads)``
    with ``grads`` in the layout of ``params`` (all detached)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    value = fn(live, *args)
    grads = torch.autograd.grad(value, tree_leaves(live))
    return value.detach(), tree_unflatten(params, grads)


def _init_leaf(generator, spec: Spec, lead: tuple, dtype, device):
    shape = lead + tuple(spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "he":   # fan-in scaled (convs/denses trained by raw SGD)
        scale = math.sqrt(2.0 / (math.prod(spec.shape[:-1]) or 1))
    elif spec.init == "normal":
        scale = 0.02
    else:
        raise ValueError(f"unknown initialiser {spec.init!r}")
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=device) * scale


def init_params(generator: torch.Generator, spec_tree, dtype=torch.float32,
                n: Optional[int] = None, device=None):
    """Draw a parameter tree from ``generator``; with ``n``, every leaf gets
    a leading client axis of ``n`` independent draws."""
    device = generator.device if device is None else device
    lead = () if n is None else (n,)

    def walk(tree):
        if isinstance(tree, Spec):
            return _init_leaf(generator, tree, lead, dtype, device)
        return {k: walk(tree[k]) for k in sorted(tree)}
    return walk(spec_tree)
