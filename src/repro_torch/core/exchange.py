"""Autoencoder-gated D2D data exchange, batched plane (paper Sec. III-B /
IV-B; mirrors the ``method="batched"`` plane of ``repro.core.exchange``).

After graph discovery each link (transmitter j -> receiver i) moves data:

  1. j offers, per cluster m that T_j[i, m] permits, a seeded random reserve
     subset of the cluster's members (``_select_reserves``, host numpy from
     one integer seed, so subsets equal the reference's for the same seed);
  2. i scores each subset with its own autoencoder (pretrained one GD step):
     if it reconstructs the subset worse than its own data
     (base < score), the subset carries information i lacks and moves;
  3. optionally the channel is sampled: with probability P_D(i, j) nothing
     moves.

Both gate scores go through ``ops.recon_gate_score`` (one kernel launch
each on the card). Accepted subsets are scattered into each receiver's
``ClientData`` slot by a cumsum compaction. The reference's
``.at[].set(mode="drop")`` has no torch twin: rows that must be dropped are
sent to an extra sink row at index ``out_cap``, which is sliced off.

Draws (:class:`ExchangeDraws`): the AE init parameters, the reserve seed and
the (N,) channel uniforms.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.batching import ClientData, as_client_data, \
    stack_pytrees
from repro_torch.kernels import ops
from repro_torch.models import autoencoder as ae
from repro_torch.models.common import tree_map, value_and_grad

OVERFLOW_POLICIES = ("grow", "drop", "error")


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    reserve_per_cluster: int = 40   # |K^{jk}_reserve|
    pretrain_steps: int = 1         # paper: one full-batch GD iteration
    pretrain_lr: float = 1e-2
    apply_channel_failure: bool = False
    # Receiver-capacity policy of the scatter:
    #   "grow"  — cap grows by the round's largest possible transfer;
    #   "drop"  — cap is fixed, rows past it are dropped from the tail;
    #   "error" — cap is fixed and any overflow raises (synchronises).
    overflow: str = "grow"


class ExchangeDraws(NamedTuple):
    init_params: Optional[dict]   # stacked AE init (None: ae_params given)
    seed: int                     # reserve selector's numpy seed
    fail_u: torch.Tensor          # (N,) channel uniforms


def draw_exchange(generator: torch.Generator, n: int, ae_cfg) -> ExchangeDraws:
    dev = generator.device
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=dev).item())
    return ExchangeDraws(ae.init_ae(generator, ae_cfg, n_clients=n), seed,
                         torch.rand(n, generator=generator, device=dev))


@dataclasses.dataclass
class ExchangeResult:
    """``client_data`` is the device-resident truth; the other views are
    lazy host views."""
    client_data: ClientData
    moved_dev: torch.Tensor                  # (N,) datapoints received
    fail: Optional[torch.Tensor] = None      # (N,) sampled channel failures
    accept: Optional[torch.Tensor] = None    # (N, K) gate decisions
    base: Optional[torch.Tensor] = None      # (N,) receivers' own scores
    scores: Optional[torch.Tensor] = None    # (N, K) reserve-subset scores
    _ctx: Optional[tuple] = None             # lazy-decision inputs
    _decisions: Optional[list] = None

    @property
    def datasets(self) -> list:
        return self.client_data.data_list()

    @property
    def labels(self) -> Optional[list]:
        return self.client_data.label_list()

    @property
    def moved_counts(self) -> np.ndarray:
        return self.moved_dev.cpu().numpy()

    @property
    def gate_decisions(self) -> list:
        """Per-link decisions ``(rx, tx, cluster, accepted)`` in the
        reference's loop order (``cluster == -1``: the channel failed)."""
        if self._decisions is None and self._ctx is not None:
            trust_np, sel, in_edge, apply_channel = self._ctx
            self._decisions = _build_decisions(
                trust_np, sel, in_edge.cpu().numpy(),
                self.fail.cpu().numpy(), self.accept.cpu().numpy(),
                apply_channel)
        return self._decisions


# ---------------------------------------------------------------------------
# AE pretraining (paper Sec. III-B: one full-batch GD iteration per client)
# ---------------------------------------------------------------------------

def pretrain_autoencoders_batched(init_params, cd: ClientData, ae_cfg,
                                  cfg: ExchangeConfig):
    """Full-batch GD on each client's masked reconstruction loss, all N
    clients at once. One backward of the summed per-client losses gives each
    client exactly its own gradient (the stacked AE never mixes clients)."""
    mask = cd.mask()

    def loss(p):
        return ae.masked_recon_loss_stacked(p, cd.data, mask, ae_cfg).sum()

    params = init_params
    for _ in range(cfg.pretrain_steps):
        _, grads = value_and_grad(loss, params)
        params = tree_map(lambda p, g: p - cfg.pretrain_lr * g, params, grads)
    return params


# ---------------------------------------------------------------------------
# reserve selection (host: indices only) and trust layout
# ---------------------------------------------------------------------------

def _select_reserves(seed: int, assignments, n_clusters_list, r: int, sizes):
    """Seeded random reserve subsets, per (transmitter j, cluster m).

    Clusters larger than ``r`` give a sorted uniform subset without
    replacement; smaller ones give all members. ``assignments`` is the
    stacked (N, cap) form with ``sizes`` marking each valid prefix."""
    rng = np.random.default_rng(int(seed))
    assignments = np.asarray(torch.as_tensor(assignments).cpu())
    sizes = np.asarray(torch.as_tensor(sizes).cpu())
    sel = []
    for j in range(assignments.shape[0]):
        a = assignments[j, :int(sizes[j])]
        row = []
        for m in range(n_clusters_list[j]):
            idx = np.nonzero(a == m)[0]
            if idx.size > r:
                idx = np.sort(rng.choice(idx, size=r, replace=False))
            row.append(idx)
        sel.append(row)
    return sel


def _sel_tensors(sel, n: int, k_max: int, r: int):
    """Ragged reserve indices -> ((N, K, R) int64 rows, (N, K, R) mask)."""
    sel_idx = np.zeros((n, k_max, r), np.int64)
    sel_mask = np.zeros((n, k_max, r), np.float32)
    for j, row in enumerate(sel):
        for m, idx in enumerate(row):
            if idx.size:
                sel_idx[j, m, :idx.size] = idx
                sel_mask[j, m, :idx.size] = 1.0
    return sel_idx, sel_mask


def _stack_trust_padded(trust_np, n: int, k_max: int):
    """(N_tx, N_rx, K) stacked trust, zero-padded over ragged k_j."""
    t = np.zeros((n, n, k_max), np.int8)
    for j, tj in enumerate(trust_np):
        t[j, :, :tj.shape[1]] = tj
    return t


def _build_decisions(trust_np, sel, in_edge, fail, accept, apply_channel):
    """Decision tuples in the reference's loop order."""
    decisions = []
    for i in range(len(trust_np)):
        j = int(in_edge[i])
        if j == i:
            continue
        if apply_channel and fail[i]:
            decisions.append((i, j, -1, False))
            continue
        for m in range(trust_np[j].shape[1]):
            if int(trust_np[j][i, m]) == 0 or sel[j][m].size == 0:
                continue
            decisions.append((i, j, m, bool(accept[i, m])))
    return decisions


# ---------------------------------------------------------------------------
# the device plane
# ---------------------------------------------------------------------------

def _gate_scores(params, own, own_mask, cand, cand_mask, allowed, fail_u,
                 p_fail, in_edge, ae_cfg, apply_channel: bool):
    """Score the whole gate. own: (N, cap, H, W, C) with own_mask (N, cap);
    cand: (N, K, R, H, W, C) receiver-aligned reserves with cand_mask
    (N, K, R). Returns (base (N,), scores (N, K), fail (N,), accept (N, K))."""
    n, max_n = own.shape[:2]
    k, r = cand.shape[1:3]
    with torch.no_grad():
        y_own = ae.reconstruct_stacked(params, own, ae_cfg)
        base = ops.recon_gate_score(y_own.reshape(n, max_n, -1),
                                    own.reshape(n, max_n, -1), own_mask)
        del y_own
        cand_flat = cand.reshape((n, k * r) + cand.shape[3:])
        y_cand = ae.reconstruct_stacked(params, cand_flat, ae_cfg)
        scores = ops.recon_gate_score(y_cand.reshape(n, k, r, -1),
                                      cand.reshape(n, k, r, -1), cand_mask)
    rows = torch.arange(n, device=own.device)
    if apply_channel:
        fail = fail_u < p_fail[rows, in_edge]
    else:
        fail = torch.zeros((n,), dtype=torch.bool, device=own.device)
    accept = allowed & (base[:, None] < scores) & ~fail[:, None]
    return base, scores, fail, accept


def _exchange_device(params, data, sizes, labels, sel_idx, sel_mask, trust_s,
                     fail_u, p_fail, in_edge, ae_cfg, apply_channel: bool,
                     out_cap: int):
    """Gather reserves, score the gate, scatter the accepted subsets.

    Returns (new ClientData, moved, base, scores, fail, accept, overflowed).
    """
    n, cap = data.shape[:2]
    k, r = sel_idx.shape[1:3]
    dev = data.device
    rows = torch.arange(n, device=dev)
    own_mask = (torch.arange(cap, device=dev)[None, :]
                < sizes[:, None]).to(torch.float32)

    # transmitter-side row lookup, then the receiver-side gather (the D2D
    # transfer): cand[i] = transmitter in_edge[i]'s reserve rows
    flat_idx = sel_idx.reshape(n, k * r)
    cand = data[rows[:, None], flat_idx][in_edge]        # (N, K*R, ...)
    cand = cand.reshape((n, k, r) + data.shape[2:])
    cand_mask = sel_mask[in_edge]

    # trust gate, receiver-aligned: allowed[i, m] = T_{in_edge[i]}[i, m]
    allowed = trust_s[in_edge, rows] != 0                # (N, K)
    allowed &= (in_edge != rows)[:, None]
    allowed &= (cand_mask > 0).any(-1)

    base, scores, fail, accept = _gate_scores(
        params, data, own_mask, cand, cand_mask, allowed, fail_u, p_fail,
        in_edge, ae_cfg, apply_channel)

    # capacity-masked scatter: compact kept rows to sizes[i] + offset, with
    # everything that must not land sent to the sink row out_cap
    keep = (accept[:, :, None] & (cand_mask > 0)).reshape(n, k * r)
    dest = sizes[:, None] + torch.cumsum(keep.to(torch.int64), dim=1) - 1
    moved_full = torch.sum(keep, dim=1)
    dest_safe = torch.where(keep & (dest < out_cap), dest,
                            torch.full_like(dest, out_cap))
    buf = data.new_zeros((n, out_cap + 1) + data.shape[2:])
    buf[:, :cap] = data
    buf[rows[:, None], dest_safe] = cand.reshape((n, k * r) + data.shape[2:])
    new_labels = None
    if labels is not None:
        cand_lab = labels[rows[:, None], flat_idx][in_edge]
        lab = labels.new_zeros((n, out_cap + 1))
        lab[:, :cap] = labels
        lab[rows[:, None], dest_safe] = cand_lab
        new_labels = lab[:, :out_cap]
    new_sizes = torch.clamp_max(sizes + moved_full, out_cap)
    moved = new_sizes - sizes
    overflowed = torch.any(sizes + moved_full > out_cap)
    return (ClientData(buf[:, :out_cap], new_sizes, new_labels), moved, base,
            scores, fail, accept, overflowed)


def _trust_list(trust) -> list:
    """Per-transmitter T_j (N_rx, k_j) numpy matrices from the stacked
    (N_tx, N_rx, k) tensor or a list of matrices."""
    if isinstance(trust, (list, tuple)):
        return [np.asarray(torch.as_tensor(t).cpu()) for t in trust]
    t = trust.cpu().numpy()
    return [t[j] for j in range(t.shape[0])]


def _gate_batched(cd: ClientData, trust, in_edge, sel, fail_u, p_fail,
                  params, ae_cfg, cfg: ExchangeConfig) -> ExchangeResult:
    n, cap = cd.n_clients, cd.cap
    dev = cd.data.device
    trust_np = _trust_list(trust)
    k_max = max(t.shape[1] for t in trust_np)
    trust_s = _stack_trust_padded(trust_np, n, k_max)
    sel_idx, sel_mask = _sel_tensors(sel, n, k_max, cfg.reserve_per_cluster)
    if cfg.overflow == "grow":
        # static headroom: the largest reserve payload any transmitter
        # offers this round (host-known: indices only, no data)
        out_cap = cap + int(sel_mask.sum(axis=(1, 2)).max(initial=0))
    else:
        out_cap = cap
    in_edge = torch.as_tensor(in_edge, device=dev).long()
    new_cd, moved, base, scores, fail, accept, overflowed = _exchange_device(
        params, cd.data, cd.sizes, cd.labels,
        torch.as_tensor(sel_idx, device=dev),
        torch.as_tensor(sel_mask, device=dev),
        torch.as_tensor(trust_s, device=dev), fail_u, p_fail, in_edge,
        ae_cfg, cfg.apply_channel_failure, out_cap)
    if cfg.overflow == "error" and bool(overflowed):
        raise ValueError(
            "exchange overflow: accepted transfers exceed the ClientData "
            f"cap ({cap}); raise the cap or use overflow='grow'/'drop'")
    return ExchangeResult(new_cd, moved, fail, accept, base, scores,
                          _ctx=(trust_np, sel, in_edge,
                                cfg.apply_channel_failure))


def run_exchange(datasets, labels, assignments, trust, in_edge, p_fail,
                 ae_cfg, cfg: ExchangeConfig = ExchangeConfig(),
                 ae_params=None, draws: Optional[ExchangeDraws] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> ExchangeResult:
    """Algorithm 2's data-plane step over the discovered graph.

    datasets/labels: ragged lists, or one :class:`ClientData` as
    ``datasets`` (then ``labels`` must be None). assignments: stacked
    (N, cap) cluster ids; trust: stacked (N_tx, N_rx, k) or a list of T_j;
    in_edge: (N,) transmitter of each receiver. ``ae_params`` (stacked or a
    list) skips pretraining; otherwise the AEs start from
    ``draws.init_params``. Draws missing come from ``generator``."""
    if cfg.overflow not in OVERFLOW_POLICIES:
        raise ValueError(f"unknown overflow policy {cfg.overflow!r}; "
                         f"expected one of {OVERFLOW_POLICIES}")
    dev = resolve_device(device)
    cd = as_client_data(datasets, labels, device=dev)
    n = cd.n_clients
    if draws is None:
        if generator is None:
            raise ValueError("run_exchange needs draws or a generator")
        draws = draw_exchange(generator, n, ae_cfg)
    n_clusters = [t.shape[1] for t in _trust_list(trust)]
    sel = _select_reserves(draws.seed, assignments, n_clusters,
                           cfg.reserve_per_cluster, cd.sizes)
    if ae_params is None:
        params = pretrain_autoencoders_batched(
            tree_map(lambda p: p.to(dev), draws.init_params), cd, ae_cfg, cfg)
    elif isinstance(ae_params, (list, tuple)):
        params = stack_pytrees(list(ae_params))
    else:
        params = ae_params
    return _gate_batched(cd, trust, in_edge, sel,
                         torch.as_tensor(draws.fail_u, device=dev),
                         torch.as_tensor(p_fail, device=dev), params, ae_cfg,
                         cfg)
