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
    init: str = "normal"    # normal | zeros | ones | he | scaled | lambda_init


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
    return _unflatten(tree, iter(leaves))


def _unflatten(t, it):
    # a module-level function, not a closure over ``it``: a nested walker
    # refers to itself, and that cycle would keep ``leaves`` (a train step's
    # unclipped gradients) alive until the cyclic garbage collector runs
    if isinstance(t, dict):
        return {k: _unflatten(t[k], it) for k in sorted(t)}
    if isinstance(t, tuple) and not isinstance(t, Spec):
        return tuple(_unflatten(x, it) for x in t)
    if t is None:
        return None
    return next(it)


def value_and_grad(fn, params, *args):
    """``fn(params, *args)`` -> scalar tensor; returns ``(value, grads)``
    with ``grads`` in the layout of ``params`` (all detached)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    value = fn(live, *args)
    grads = torch.autograd.grad(value, tree_leaves(live))
    return value.detach(), tree_unflatten(params, grads)


def local_shape(spec: Spec, rules) -> tuple:
    """The shape of one rank's shard of a ``spec`` leaf where
    ``rules.spec`` places it (the whole shape at ``rules=None``)."""
    if rules is None:
        return tuple(spec.shape)
    from repro_torch.sharding import ModelPlane
    return ModelPlane(rules).local_shape(spec.logical, spec.shape)


def param_shapes(spec_tree, dtype, rules=None):
    """The parameter tree as meta tensors (shape and dtype, no data): one
    rank's shards under ``rules``."""
    return tree_map(lambda s: torch.empty(local_shape(s, rules), dtype=dtype,
                                          device="meta"), spec_tree)


def spec_paths(tree, path=()):
    """(key path, Spec) of every leaf of a spec tree, in flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_paths(tree[k], path + (k,))
    elif isinstance(tree, tuple) and not isinstance(tree, Spec):
        for i, t in enumerate(tree):
            yield from spec_paths(t, path + (i,))
    elif tree is not None:
        yield path, tree


def param_logical(spec_tree):
    """The logical-axis tuple of every parameter, in the spec tree's
    layout (``sharding.ShardingRules.spec`` maps them onto a mesh)."""
    return tree_map(lambda s: s.logical, spec_tree)


def stack_specs(spec_tree, n: int):
    """Add a leading scan axis of size ``n`` to every Spec in the tree."""
    return tree_map(lambda s: Spec((n,) + s.shape, ("stack",) + s.logical,
                                   s.init), spec_tree)


def _init_leaf(generator, spec: Spec, lead: tuple, dtype, n_layers: int):
    shape = lead + tuple(spec.shape)
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=generator.device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=generator.device)
    if spec.init == "lambda_init":  # RG-LRU Λ: a uniform in [0.9, 0.999]
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device) * (0.999 - 0.9) + 0.9
        # Λ such that sigmoid(Λ)^8 = a  =>  Λ = logit(a^{1/8})
        a8 = u ** (1.0 / 8.0)
        return torch.log(a8 / (1 - a8))
    if spec.init == "he":   # fan-in scaled (convs/denses trained by raw SGD)
        scale = math.sqrt(2.0 / (math.prod(spec.shape[:-1]) or 1))
    elif spec.init == "normal":
        scale = 0.02
    elif spec.init == "scaled":   # residual-out projections
        scale = 0.02 / math.sqrt(2 * max(n_layers, 1))
    else:
        raise ValueError(f"unknown initialiser {spec.init!r}")
    # scaled in place: no second leaf-sized buffer while the draw is scaled
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).mul_(scale)


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


def group_norm_heads(x, scale, n_heads: int, eps: float = 1e-6):
    """Per-head group norm used by the xLSTM cells. x: (..., H, dh); the
    population variance, and a plain ``scale`` gain (not 1 + scale)."""
    y = x.float()
    mean = torch.mean(y, dim=-1, keepdim=True)
    var = torch.mean(torch.square(y - mean), dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


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


def cross_entropy(logits, labels, ignore_id: int = -1, *, plane=None,
                  vocab_start: int = 0):
    """Mean token-level CE in float32; labels == ignore_id are masked.

    With ``plane`` (``sharding.ModelPlane``) the logits are this rank's
    vocab columns from ``vocab_start`` and this rank's batch rows: the
    logsumexp takes an all-reduce (max) and one (sum) over "model", with
    the label's logit, taken where this rank holds it and zero elsewhere,
    in the sum's buffer; the token sum and count take one all-reduce over
    the data axes. One rank computes ``torch.logsumexp``'s expression and
    its gradient, so a one-rank mesh gives the unsharded loss and
    gradients bit for bit."""
    logits = logits.to(torch.float32)
    if plane is not None:
        nll = _VocabParallelNLL.apply(logits, labels, vocab_start, plane)
        mask = (labels != ignore_id).to(torch.float32)
        sums = plane.psum(torch.stack([torch.sum(nll * mask),
                                       torch.sum(mask)]), "dp")
        return sums[0] / torch.clamp_min(sums[1], 1.0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp_min(labels, 0)[..., None].long())[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


class _VocabParallelNLL(torch.autograd.Function):
    """logsumexp(logits) - logits[label] per token, the logits' last
    dimension split over the model axis. Forward: the max and then the
    sum of exponentials and the label's logit, each all-reduced over
    "model"; backward: ``torch.logsumexp``'s and ``torch.gather``'s
    gradients on this rank's columns, nothing communicated."""

    @staticmethod
    def forward(ctx, logits, labels, start, plane):
        width = logits.shape[-1]
        top = plane.all_reduce(torch.amax(logits, dim=-1, keepdim=True),
                               "model", "max")
        top_sq = top[..., 0]
        # torch.logsumexp's own steps: an infinite max counts as 0
        top_sq = top_sq.masked_fill(top_sq.abs() == math.inf, 0)
        top = top_sq[..., None]
        local = labels.clamp_min(0).long() - start
        mine = (local >= 0) & (local < width)
        idx = torch.where(mine, local, 0)[..., None]
        gold = torch.gather(logits, -1, idx)[..., 0] * mine.to(logits.dtype)
        sums = plane.all_reduce(torch.stack(
            [torch.sum(torch.exp(logits - top), dim=-1), gold]), "model")
        logz = torch.log(sums[0]) + top_sq
        ctx.save_for_backward(logits, logz, idx, mine)
        return logz - sums[1]

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, mine = ctx.saved_tensors
        grad = g[..., None] * torch.exp(logits - logz[..., None])
        pick = torch.zeros_like(logits).scatter_add_(
            -1, idx, (-g * mine.to(g.dtype))[..., None])
        return grad + pick, None, None, None
