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
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
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


def _masked_mean(tree, mask):
    w = mask / torch.clamp_min(torch.sum(mask), 1.0)
    return tree_map(lambda p: torch.tensordot(w, p.to(torch.float32), dims=1)
                    .to(p.dtype), tree)


def draw_batch_indices(generator: torch.Generator, sizes, cfg: FLConfig,
                       n_rounds: int) -> torch.Tensor:
    """(n_rounds, tau_a, N, B) indices, uniform in [0, sizes[i])."""
    sizes = torch.as_tensor(sizes, device=generator.device)
    u = torch.rand((n_rounds, cfg.tau_a, sizes.shape[0], cfg.batch_size),
                   generator=generator, device=generator.device)
    return torch.minimum(torch.floor(u * sizes[:, None]).long(),
                         (sizes - 1)[:, None])


def _round_body(cfg: FLConfig, ae_cfg, carry: FLCarry, data, agg_mask,
                batch_idx) -> FLCarry:
    """One aggregation round: ``tau_a`` local iterations on the minibatch
    indices ``batch_idx`` (tau_a, N, B), then the masked mean and
    broadcast."""
    cp, gp, mu, nu, t = carry
    n = data.shape[0]
    rows = torch.arange(n, device=data.device)[:, None]
    floor = (max(1, math.ceil(cfg.min_participation * n - 1e-9))
             if cfg.min_participation > 0.0 else 0)
    ok = bool(torch.sum(agg_mask) >= floor) if floor else True

    def loss(p, x):
        return ae.recon_loss_stacked(p, x, ae_cfg).sum()

    for it in range(cfg.tau_a):
        t = t + 1.0
        _, grads = value_and_grad(loss, cp, data[rows, batch_idx[it]])
        if cfg.scheme == "fedprox":   # prox pull toward the global model
            grads = tree_map(lambda g, p, q: g + cfg.prox_mu * (p - q[None]),
                             grads, cp, gp)
        if cfg.scheme == "fedsgd" and ok:
            # all clients step with the participants' mean gradient; below
            # the floor they keep their local gradients
            grads = _broadcast(_masked_mean(grads, agg_mask), n)
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
    if ok:   # FedAvg/FedProx param mean; below the floor keep the old model
        gp = _masked_mean(cp, agg_mask)
        cp = _broadcast(gp, n)
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
             device="cuda") -> FLResult:
    """Run the FL task. datasets: per-client arrays or one ClientData;
    eval_data: (n_eval, H, W, C) held-out set for the global recon loss.

    ``init_carry`` plus ``start_iter``/``stop_iter`` run only the rounds in
    ``[start_iter, stop_iter)`` of the ``cfg.total_iters`` horizon.
    ``batch_idx`` holds the minibatch indices of the whole horizon; without
    it each round's indices come from ``generator`` (default: seeded with
    ``cfg.seed`` on the run's device), as does ``init_params``."""
    dev = resolve_device(device)
    cd = as_client_data(datasets, device=dev)
    n = cd.n_clients
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    lost = set(stragglers)
    agg_mask = torch.tensor([0.0 if i in lost else 1.0 for i in range(n)],
                            device=dev)
    eval_data = torch.as_tensor(eval_data, device=dev)

    if init_carry is not None:
        carry = FLCarry(*init_carry)
    else:
        if init_params is None:
            init_params = ae.init_ae(generator, ae_cfg)
        init_params = tree_map(lambda p: torch.as_tensor(p, device=dev),
                               init_params)
        client_params = _broadcast(init_params, n)
        carry = FLCarry(client_params, tree_map(torch.clone, init_params),
                        tree_map(torch.zeros_like, client_params),
                        tree_map(torch.zeros_like, client_params),
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
    eval_iters, eval_vals = [], []
    for r in range(start_round, stop_round):
        idx = (batch_idx[r] if batch_idx is not None else
               draw_batch_indices(generator, cd.sizes, cfg, 1)[0])
        carry = _round_body(cfg, ae_cfg, carry, cd.data, agg_mask,
                            torch.as_tensor(idx, device=dev).long())
        it = (r + 1) * cfg.tau_a
        if it % cfg.eval_every == 0 or r == n_rounds - 1:
            eval_iters.append(it)
            eval_vals.append(eval_global_loss(carry.global_params, eval_data,
                                              ae_cfg))
    eval_loss = (torch.stack(eval_vals).cpu().numpy() if eval_vals
                 else np.zeros((0,), np.float32))
    return FLResult(carry.global_params, np.asarray(eval_iters), eval_loss,
                    carry.client_params, carry)
