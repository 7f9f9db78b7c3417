"""Declarative parameter specs, their initialisers and the shared layers
(mirrors ``repro.models.common``).

Parameters are nested dicts and tuples of tensors in the JAX package's
layout. The tree helpers walk both, in JAX's flatten order: sorted dict keys,
tuple items in index order; ``None`` is an empty subtree.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Spec(NamedTuple):
    shape: tuple
    logical: tuple          # logical axis name (or None) per dim
    init: str = "normal"    # normal | zeros | he | scaled


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts/tuples of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple) and not isinstance(tree, Spec):
        return tuple(tree_map(fn, t, *(r[i] for r in rest))
                     for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict/tuple in JAX's flatten order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, Spec):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in :func:`tree_leaves`
    order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and not isinstance(t, Spec):
            return tuple(walk(x) for x in t)
        if t is None:
            return None
        return next(it)
    return walk(tree)


def value_and_grad(fn, params, *args):
    """``fn(params, *args)`` -> scalar tensor; returns ``(value, grads)``
    with ``grads`` in the layout of ``params`` (all detached)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    value = fn(live, *args)
    grads = torch.autograd.grad(value, tree_leaves(live))
    return value.detach(), tree_unflatten(params, grads)


def stack_specs(spec_tree, n: int):
    """Add a leading scan axis of size ``n`` to every Spec in the tree."""
    return tree_map(lambda s: Spec((n,) + s.shape, ("stack",) + s.logical,
                                   s.init), spec_tree)


def _init_leaf(generator, spec: Spec, lead: tuple, dtype, n_layers: int):
    shape = lead + tuple(spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=generator.device)
    if spec.init == "he":   # fan-in scaled (convs/denses trained by raw SGD)
        scale = math.sqrt(2.0 / (math.prod(spec.shape[:-1]) or 1))
    elif spec.init == "normal":
        scale = 0.02
    elif spec.init == "scaled":   # residual-out projections
        scale = 0.02 / math.sqrt(2 * max(n_layers, 1))
    else:
        raise ValueError(f"unknown initialiser {spec.init!r}")
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device) * scale


def init_params(generator: torch.Generator, spec_tree, dtype=torch.float32,
                n: Optional[int] = None, device=None, n_layers: int = 1):
    """Draw a parameter tree from ``generator``, leaf by leaf in flatten
    order, on the generator's device, then move it to ``device``; with
    ``n``, every leaf gets a leading client axis of ``n`` independent
    draws."""
    lead = () if n is None else (n,)
    leaves = [_init_leaf(generator, s, lead, dtype, n_layers).to(device)
              for s in tree_leaves(spec_tree)]
    return tree_unflatten(spec_tree, leaves)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm with a (1 + scale) gain, computed in float32."""
    y = x.float()
    y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def dense(x, w, out_dtype=None):
    """x @ w with float32 accumulation, cast to ``out_dtype`` (x's dtype by
    default). In x's own dtype this is the framework's matmul, which
    accumulates bf16 products in float32 (on the card, with
    ``allow_bf16_reduced_precision_reduction`` off); into a wider dtype the
    operands are widened first, so a bf16 product is not rounded to bf16."""
    out_dtype = out_dtype or x.dtype
    if out_dtype == x.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))


def embed_lookup(tokens, table, dtype):
    return table[tokens].to(dtype)
