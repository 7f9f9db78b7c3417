"""Unsupervised FL trainer (paper Sec. IV-C + Algorithm 2; mirrors
``repro.fl.trainer``).

All N clients train their own autoencoder replica with local steps on
reconstruction MSE; every ``tau_a`` iterations the server aggregates
(FedAvg parameter mean / FedSGD gradient mean / FedProx with a proximal pull)
and broadcasts back. Stragglers keep training locally but are left out of
the aggregate.

Client parameters are one stacked tree (leading client axis). Per-client
gradients come from one backward of the sum of the clients' losses: the
stacked AE runs client i's data only through client i's weights, so that
sum's gradient with respect to client i's parameters is client i's own.

The minibatch indices are inputs: ``batch_idx`` (n_rounds, tau_a, N, B)
over the whole horizon, drawn from ``generator`` when omitted.

Sharded over the clients (``rules``), each rank trains its own clients on
its rows of the whole draw. FedAvg/FedProx is a local weighted sum and one
all-reduce a round of the parameter tree flattened into one buffer (FedSGD:
one an iteration), weighted by the whole availability mask, so the global
model is whole on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch import sharding as sh
from repro_torch.core.batching import as_client_data
from repro_torch.models import autoencoder as ae
from repro_torch.models.common import tree_map, value_and_grad


@dataclasses.dataclass(frozen=True)
class FLConfig:
    scheme: str = "fedavg"        # fedavg | fedsgd | fedprox
    total_iters: int = 1500       # minibatch iterations (paper Sec. V)
    tau_a: int = 10               # aggregation interval
    batch_size: int = 64
    lr: float = 5e-2
    prox_mu: float = 0.1          # FedProx proximal coefficient
    eval_every: int = 50
    seed: int = 0
    local_opt: str = "adam"       # "sgd" (Eq. 8 faithful) | "adam"
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    adam_eps: float = 1e-8
    adam_lr: float = 1e-3
    # below ceil(min_participation * N) participants a round keeps the last
    # global model (0.0 disables the floor)
    min_participation: float = 0.0


class FLCarry(NamedTuple):
    """Training state threaded through ``fl_train`` segments."""
    client_params: dict          # stacked tree, leading client axis
    global_params: dict          # server model
    mu: dict                     # Adam first moments (stacked)
    nu: dict                     # Adam second moments (stacked)
    step: torch.Tensor           # () float32, local iteration counter


class FLResult(NamedTuple):
    global_params: dict
    eval_iters: np.ndarray       # (n_evals,)
    eval_loss: np.ndarray        # (n_evals,) global reconstruction loss
    client_params: dict
    carry: Optional[FLCarry] = None


def _broadcast(params, n):
    return tree_map(lambda p: p[None].expand((n,) + p.shape).clone(), params)


def _masked_mean(tree, mask, part: Optional[sh.ClientSlice] = None):
    """The mask-weighted mean over clients. ``mask`` is whole (N,); with a
    sharded ``part`` the tree holds this rank's rows, and the weighted
    partial sums travel in one all-reduce."""
    w = mask / torch.clamp_min(torch.sum(mask), 1.0)
    if part is None or not part.sharded:
        return tree_map(lambda p: torch.tensordot(w, p.to(torch.float32),
                                                  dims=1).to(p.dtype), tree)
    w = part.rows(w)
    sums = part.psum(tree_map(
        lambda p: torch.tensordot(w, p.to(torch.float32), dims=1), tree))
    return tree_map(lambda m, p: m.to(p.dtype), sums, tree)


def batch_indices_from(u, sizes) -> torch.Tensor:
    """Uniforms u (..., N, B) -> indices ``floor(u * sizes[i])``, computed
    on the sizes' device (the sizes never leave it)."""
    u = u.to(sizes.device)
    return torch.minimum(torch.floor(u * sizes[:, None]).long(),
                         (sizes - 1)[:, None])


def draw_batch_indices(generator: torch.Generator, sizes, cfg: FLConfig,
                       n_rounds: int) -> torch.Tensor:
    """(n_rounds, tau_a, N, B) indices, uniform in [0, sizes[i]) (a sizes
    tensor keeps its device; other sizes go to the generator's)."""
    if not isinstance(sizes, torch.Tensor):
        sizes = torch.as_tensor(sizes, device=generator.device)
    u = torch.rand((n_rounds, cfg.tau_a, sizes.shape[0], cfg.batch_size),
                   generator=generator, device=generator.device)
    return batch_indices_from(u, sizes)


def _round_body(cfg: FLConfig, ae_cfg, carry: FLCarry, data, agg_mask,
                batch_idx, part: Optional[sh.ClientSlice] = None) -> FLCarry:
    """One aggregation round: ``tau_a`` local iterations on the minibatch
    indices ``batch_idx`` (tau_a, N, B), then the masked mean and
    broadcast. With a sharded ``part``, the carry's client trees, ``data``
    and ``batch_idx`` hold this rank's rows; ``agg_mask`` is whole."""
    cp, gp, mu, nu, t = carry
    n = data.shape[0]
    n_all = n if part is None else part.n
    rows = torch.arange(n, device=data.device)[:, None]
    floor = (max(1, math.ceil(cfg.min_participation * n_all - 1e-9))
             if cfg.min_participation > 0.0 else 0)
    # below the floor a round keeps the last global model: a device select,
    # as the reference's traced ``ok`` is, so the round never reads the
    # device
    ok = torch.sum(agg_mask) >= floor if floor else None

    def keep_below_floor(new, old):
        if ok is None:
            return new
        return tree_map(lambda a, b: torch.where(ok, a, b), new, old)

    def loss(p, x):
        return ae.recon_loss_stacked(p, x, ae_cfg).sum()

    for it in range(cfg.tau_a):
        t = t + 1.0
        _, grads = value_and_grad(loss, cp, data[rows, batch_idx[it]])
        if cfg.scheme == "fedprox":   # prox pull toward the global model
            grads = tree_map(lambda g, p, q: g + cfg.prox_mu * (p - q[None]),
                             grads, cp, gp)
        if cfg.scheme == "fedsgd":
            # all clients step with the participants' mean gradient; below
            # the floor they keep their local gradients
            grads = keep_below_floor(
                _broadcast(_masked_mean(grads, agg_mask, part), n), grads)
        if cfg.local_opt == "sgd":    # Eq. 8, paper-faithful
            cp = tree_map(lambda p, g: p - cfg.lr * g, cp, grads)
        else:
            b1, b2 = cfg.adam_b1, cfg.adam_b2
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, mu, grads)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, nu, grads)
            c1 = 1 - torch.pow(b1, t)
            c2 = 1 - torch.pow(b2, t)
            cp = tree_map(lambda p, m, v: p - cfg.adam_lr * (m / c1)
                          / (torch.sqrt(v / c2) + cfg.adam_eps), cp, mu, nu)
    # FedAvg/FedProx param mean; below the floor keep the old model and the
    # clients' local parameters
    gp = keep_below_floor(_masked_mean(cp, agg_mask, part), gp)
    cp = keep_below_floor(_broadcast(gp, n), cp)
    return FLCarry(cp, gp, mu, nu, t)


def eval_global_loss(params, eval_data, ae_cfg):
    """Global reconstruction loss as a device scalar (no host sync)."""
    with torch.no_grad():
        return ae.recon_loss(params, eval_data, ae_cfg)


def fl_train(datasets, ae_cfg, cfg: FLConfig, eval_data,
             stragglers: Sequence[int] = (), init_params=None,
             init_carry: Optional[FLCarry] = None, start_iter: int = 0,
             stop_iter: Optional[int] = None, *, batch_idx=None,
             generator: Optional[torch.Generator] = None,
             avail_mask=None, defer_metrics: bool = False,
             device="cuda", rules=None) -> FLResult:
    """Run the FL task. datasets: per-client arrays or one ClientData;
    eval_data: (n_eval, H, W, C) held-out set for the global recon loss.

    ``init_carry`` plus ``start_iter``/``stop_iter`` run only the rounds in
    ``[start_iter, stop_iter)`` of the ``cfg.total_iters`` horizon.
    ``batch_idx[r]`` holds round r's (tau_a, N, B) minibatch indices (an
    array over the whole horizon, or a mapping from round to indices);
    without it each round's indices come from ``generator`` (default:
    seeded with ``cfg.seed`` on the run's device), as does ``init_params``.

    ``avail_mask``: an (N,) availability mask (truthy = aggregated) that
    overrides ``stragglers`` and stays on the device. ``defer_metrics``
    leaves ``eval_loss`` as a device tensor, so a caller looping over
    segments can read every metric in one transfer at the end.

    ``rules`` shards the clients (module docstring): the result's client
    trees are placed, the global model whole on every rank."""
    dev = resolve_device(device)
    cd = as_client_data(datasets, device=dev, rules=rules)
    n = cd.n_clients
    part = sh.ClientSlice(rules, n)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    if avail_mask is not None:
        agg_mask = torch.as_tensor(avail_mask, device=dev).to(torch.float32)
    else:
        lost = set(stragglers)
        agg_mask = torch.tensor([0.0 if i in lost else 1.0
                                 for i in range(n)], device=dev)
    eval_data = torch.as_tensor(eval_data, device=dev)

    if init_carry is not None:
        carry = FLCarry(*init_carry)
    else:
        if init_params is None:
            init_params = ae.init_ae(generator, ae_cfg)
        init_params = tree_map(lambda p: torch.as_tensor(p, device=dev),
                               init_params)
        client_params = _broadcast(init_params, part.n_local)
        carry = FLCarry(part.place(client_params),
                        tree_map(torch.clone, init_params),
                        part.place(tree_map(torch.zeros_like, client_params)),
                        part.place(tree_map(torch.zeros_like, client_params)),
                        torch.zeros((), device=dev))

    if start_iter % cfg.tau_a or (stop_iter is not None
                                  and stop_iter % cfg.tau_a):
        raise ValueError(
            f"segment bounds [{start_iter}, {stop_iter}) must align to the "
            f"aggregation interval tau_a={cfg.tau_a}")
    n_rounds = cfg.total_iters // cfg.tau_a
    start_round = start_iter // cfg.tau_a
    stop_round = n_rounds if stop_iter is None else \
        min(stop_iter // cfg.tau_a, n_rounds)
    with obs.span("fl", rounds=stop_round - start_round,
                  start_iter=start_iter):
        res = _fl_rounds(cd, ae_cfg, cfg, eval_data, carry, agg_mask,
                         start_round, stop_round,
                         batch_idx if batch_idx is not None else
                         (lambda r: draw_batch_indices(generator, cd.sizes,
                                                       cfg, 1)[0]), rules)
        if not defer_metrics:
            res = res._replace(eval_loss=res.eval_loss.cpu().numpy())
    return res


def _fl_rounds(cd, ae_cfg, cfg: FLConfig, eval_data, carry: FLCarry,
               agg_mask, start_round: int, stop_round: int,
               batch_idx, rules=None) -> FLResult:
    """Rounds ``[start_round, stop_round)`` of :func:`fl_train` from
    ``carry``, without its span (the orchestrator's scan chunk calls it
    directly). ``batch_idx[r]`` (an array or a mapping) or ``batch_idx(r)``
    gives round r's whole (tau_a, N, B) minibatch indices; the eval losses
    stay a device tensor."""
    dev = cd.sizes.device
    part = sh.ClientSlice(rules, cd.n_clients)
    data = part.rows(cd.data)
    carry = FLCarry(part.rows(carry.client_params), carry.global_params,
                    part.rows(carry.mu), part.rows(carry.nu), carry.step)
    n_rounds = cfg.total_iters // cfg.tau_a
    eval_iters, eval_vals = [], []
    for r in range(start_round, stop_round):
        idx = batch_idx(r) if callable(batch_idx) else batch_idx[r]
        idx = part.rows(torch.as_tensor(idx, device=dev).long(), dim=1)
        carry = _round_body(cfg, ae_cfg, carry, data, agg_mask, idx,
                            part if part.sharded else None)
        it = (r + 1) * cfg.tau_a
        if it % cfg.eval_every == 0 or r == n_rounds - 1:
            eval_iters.append(it)
            eval_vals.append(eval_global_loss(carry.global_params, eval_data,
                                              ae_cfg))
    eval_loss = (torch.stack(eval_vals) if eval_vals
                 else torch.zeros((0,), device=dev))
    carry = FLCarry(part.place(carry.client_params), carry.global_params,
                    part.place(carry.mu), part.place(carry.nu), carry.step)
    return FLResult(carry.global_params, np.asarray(eval_iters), eval_loss,
                    carry.client_params, carry)
