"""Autoencoder-gated D2D data exchange (paper Sec. III-B / IV-B; mirrors
``repro.core.exchange``).

After graph discovery each link (transmitter j -> receiver i) moves data:

  1. j offers, per cluster m that T_j[i, m] permits, a random reserve
     subset of the cluster's members;
  2. i scores each subset with its own autoencoder (pretrained one GD step):
     if it reconstructs the subset worse than its own data
     (base < score), the subset carries information i lacks and moves;
  3. optionally the channel is sampled: with probability P_D(i, j) nothing
     moves.

Two data planes (``ExchangeConfig.method``):

``"batched"`` (default)  the client stack on the device. Both gate scores
    go through ``ops.recon_gate_score`` (one kernel launch each on the
    card); accepted subsets are scattered into each receiver's
    ``ClientData`` slot by a cumsum compaction. The reference's
    ``.at[].set(mode="drop")`` has no torch twin: rows that must be dropped
    are sent to an extra sink row at index ``out_cap``, which is sliced off.
``"loop"``  the host triple loop, one reconstruction loss per (receiver,
    cluster) pair, with a ragged concat: the batched plane's oracle. Both
    planes give the same gate decisions and moved counts on the same draws.

Two reserve selectors (``ExchangeConfig.reserve_selector``): ``"host"``
(``_select_reserves``, numpy from one integer seed, so subsets equal the
reference's for the same seed) and ``"device"``
(:func:`select_reserves_device`, a masked top-k over explicit uniforms that
never leaves the device).

Draws (:class:`ExchangeDraws`): the AE init parameters, the reserve seed,
the (N,) channel uniforms and, for the device selector, the
(N, k_max, cap) reserve uniforms.

Sharded over the clients (``rules``, batched plane only), pretraining is
each rank's own clients with no collective. The gate's reserve lookup is
transmitter-side; a receiver's transmitter may live on another rank, so
each rank gathers its transmitters' reserve rows, labels and masks in one
all-gather (the D2D transfer) and indexes that by its receivers' links, at
global row indices. ``recon_gate`` then launches on each rank's local
stacks, and the scatter is receiver-local. One more all-gather brings the
new sizes, moved counts, channel failures and overflow flags, so those,
the grown cap and ``overflowed`` are whole on every rank. The host selector
reads every client's cluster ids: sharded, one all-gather brings them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch import sharding as sh
from repro_torch.core.batching import ClientData, as_client_data, \
    client_data_from_lists, stack_pytrees, unstack_pytree, valid_mask
from repro_torch.kernels import ops
from repro_torch.models import autoencoder as ae
from repro_torch.models.common import tree_map, value_and_grad

OVERFLOW_POLICIES = ("grow", "drop", "error")
RESERVE_SELECTORS = ("host", "device")
METHODS = ("batched", "loop")


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
    method: str = "batched"          # see METHODS
    # "host": numpy subsets from ExchangeDraws.seed; "device": a masked
    # top-k over ExchangeDraws.sel_u (same distribution, other subsets)
    reserve_selector: str = "host"


class ExchangeDraws(NamedTuple):
    init_params: Optional[dict]   # stacked AE init (None: ae_params given)
    seed: int                     # host selector's numpy seed
    fail_u: torch.Tensor          # (N,) channel uniforms
    # (N, k_max, cap) device selector's uniforms; None for the host selector
    sel_u: Optional[torch.Tensor] = None


def draw_exchange(generator: torch.Generator, n: int, ae_cfg,
                  sel_shape: Optional[tuple] = None) -> ExchangeDraws:
    """``sel_shape`` (k_max, cap) also draws the device selector's
    uniforms, after every other draw."""
    dev = generator.device
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=dev).item())
    init = ae.init_ae(generator, ae_cfg, n_clients=n)
    fail_u = torch.rand(n, generator=generator, device=dev)
    sel_u = None if sel_shape is None else \
        torch.rand((n,) + tuple(sel_shape), generator=generator, device=dev)
    return ExchangeDraws(init, seed, fail_u, sel_u)


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
            if isinstance(sel, tuple):
                # device selector: (sel_idx, sel_mask) tensors, read back to
                # the ragged layout on first access
                si, sm = (sh.full_tensor(t).cpu().numpy() for t in sel)
                sel = [[si[j, m][sm[j, m] > 0]
                        for m in range(trust_np[j].shape[1])]
                       for j in range(len(trust_np))]
            self._decisions = _build_decisions(
                trust_np, sel, in_edge.cpu().numpy(),
                self.fail.cpu().numpy(),
                sh.full_tensor(self.accept).cpu().numpy(), apply_channel)
        return self._decisions

    def failed_links(self) -> list:
        """Live links whose sampled channel failed, as host ``(rx, tx)``
        pairs (the orchestrator's retry queue feeds on this). Self-links
        are left out: ``P_D(i, i) = 1`` makes every one of them "fail".
        Reads only the (N,) fail mask and the graph to the host."""
        if self.fail is None or self._ctx is None:
            if self._decisions is not None:                  # loop plane
                return [(d[0], d[1]) for d in self._decisions if d[2] == -1]
            return []
        in_edge = self._ctx[2].cpu().numpy()
        fail = self.fail.cpu().numpy()
        live = in_edge != np.arange(in_edge.shape[0])
        return [(int(i), int(in_edge[i])) for i in np.nonzero(fail & live)[0]]


# ---------------------------------------------------------------------------
# AE pretraining (paper Sec. III-B: one full-batch GD iteration per client)
# ---------------------------------------------------------------------------

def pretrain_autoencoders(init_params, datasets, ae_cfg, cfg: ExchangeConfig):
    """The loop plane's pretraining: one client at a time on its unpadded
    data. ``init_params``: a stacked tree or a per-client list. Returns the
    per-client list."""
    if not isinstance(init_params, (list, tuple)):
        init_params = unstack_pytree(init_params, len(datasets))

    def loss(p, x):
        return ae.recon_loss(p, x, ae_cfg)

    out = []
    for params, x in zip(init_params, datasets):
        for _ in range(cfg.pretrain_steps):
            _, grads = value_and_grad(loss, params, x)
            params = tree_map(lambda p, g: p - cfg.pretrain_lr * g, params,
                              grads)
        out.append(params)
    return out


def pretrain_autoencoders_batched(init_params, cd: ClientData, ae_cfg,
                                  cfg: ExchangeConfig, rules=None):
    """Full-batch GD on each client's masked reconstruction loss, all N
    clients at once. One backward of the summed per-client losses gives each
    client exactly its own gradient (the stacked AE never mixes clients).
    Sharded, each rank trains its own clients (no collective) and the
    result is placed."""
    part = sh.ClientSlice(rules, cd.n_clients)
    data = part.rows(cd.data)
    mask = valid_mask(part.rows(cd.sizes), cd.cap)

    def loss(p):
        return ae.masked_recon_loss_stacked(p, data, mask, ae_cfg).sum()

    params = part.rows(init_params)
    for _ in range(cfg.pretrain_steps):
        _, grads = value_and_grad(loss, params)
        params = tree_map(lambda p, g: p - cfg.pretrain_lr * g, params, grads)
    return part.place(params)


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


def select_reserves_device(sel_u, assignments, sizes, k_max: int, r: int):
    """Reserve subsets on the device: a uniform subset without replacement
    of each (transmitter j, cluster m)'s members, as the top-r of the
    uniforms ``sel_u`` (N, k_max, cap) masked to the members.

    ``assignments``: stacked (N, cap) cluster ids, entries past ``sizes[j]``
    being padding. Returns ``(sel_idx, sel_mask)``, (N, k_max, r) int64 and
    float32, each row holding min(r, |members|) distinct indices in
    ascending order as a valid prefix (``_sel_tensors``' layout). No host
    read: the scan engine selects inside its chunk with it."""
    n, cap = assignments.shape
    dev = assignments.device
    valid = torch.arange(cap, device=dev)[None, :] < sizes[:, None]
    member = valid[:, None, :] & (assignments[:, None, :].long()
                                  == torch.arange(k_max, device=dev)
                                  [None, :, None])
    score = torch.where(member, sel_u, torch.full_like(sel_u, -float("inf")))
    r_eff = min(int(r), int(cap))
    top_val, top_idx = torch.topk(score, r_eff, dim=-1)
    # non-members surface as -inf: send them past the cap, then sort so the
    # picks form an ascending valid prefix (the host selector's order)
    idx = torch.where(torch.isinf(top_val), torch.full_like(top_idx, cap),
                      top_idx)
    idx = torch.sort(idx, dim=-1).values
    mask = (idx < cap).to(torch.float32)
    idx = torch.where(idx < cap, idx, torch.zeros_like(idx))
    if r_eff < r:   # cap below the reserve budget: dead slots at the end
        idx = torch.nn.functional.pad(idx, (0, r - r_eff))
        mask = torch.nn.functional.pad(mask, (0, r - r_eff))
    return idx, mask


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
                     out_cap: Optional[int], rules=None):
    """Gather reserves, score the gate, scatter the accepted subsets.
    ``out_cap=None`` grows the cap by the largest reserve payload any
    transmitter offers (read from the gathered masks).

    Client stacks (params, data, labels, sel_idx, sel_mask) come placed or
    whole; sizes, the draws, trust, P_D and the graph are whole. Returns
    (new ClientData, moved, base, scores, fail, accept, overflowed), the
    stacks placed and moved, fail and overflowed whole."""
    n, cap = data.shape[:2]
    k, r = sel_idx.shape[1:3]
    part = sh.ClientSlice(rules, n)
    params, data, labels, sel_idx, sel_mask = part.rows(
        (params, data, labels, sel_idx, sel_mask))
    sizes = part.rows(sizes)
    in_rx = part.rows(in_edge)
    n_l = part.n_local
    dev = data.device
    rows = torch.arange(n_l, device=dev)
    rx_ids = torch.arange(part.lo, part.hi, device=dev)  # global receivers
    own_mask = (torch.arange(cap, device=dev)[None, :]
                < sizes[:, None]).to(torch.float32)

    # transmitter-side row lookup, then the receiver-side gather (the D2D
    # transfer): cand[i] = transmitter in_edge[i]'s reserve rows
    flat_idx = sel_idx.reshape(n_l, k * r)
    res = data[rows[:, None], flat_idx]                  # (n_l, K*R, ...)
    res_lab = None if labels is None else labels[rows[:, None], flat_idx]
    res, res_lab, mask_all = part.gather((res, res_lab, sel_mask))
    cand = res[in_rx].reshape((n_l, k, r) + data.shape[2:])
    cand_mask = mask_all[in_rx]
    if out_cap is None:
        out_cap = cap + int(mask_all.sum(dim=(1, 2)).max())

    # trust gate, receiver-aligned: allowed[i, m] = T_{in_edge[i]}[i, m]
    allowed = trust_s[in_rx, rx_ids] != 0                # (N, K)
    allowed &= (in_rx != rx_ids)[:, None]
    allowed &= (cand_mask > 0).any(-1)

    base, scores, fail, accept = _gate_scores(
        params, data, own_mask, cand, cand_mask, allowed, part.rows(fail_u),
        part.rows(p_fail), in_rx, ae_cfg, apply_channel)

    # capacity-masked scatter: compact kept rows to sizes[i] + offset, with
    # everything that must not land sent to the sink row out_cap
    keep = (accept[:, :, None] & (cand_mask > 0)).reshape(n_l, k * r)
    dest = sizes[:, None] + torch.cumsum(keep.to(torch.int64), dim=1) - 1
    moved_full = torch.sum(keep, dim=1)
    dest_safe = torch.where(keep & (dest < out_cap), dest,
                            torch.full_like(dest, out_cap))
    buf = data.new_zeros((n_l, out_cap + 1) + data.shape[2:])
    buf[:, :cap] = data
    buf[rows[:, None], dest_safe] = cand.reshape((n_l, k * r)
                                                 + data.shape[2:])
    new_labels = None
    if labels is not None:
        cand_lab = res_lab[in_rx]
        lab = labels.new_zeros((n_l, out_cap + 1))
        lab[:, :cap] = labels
        lab[rows[:, None], dest_safe] = cand_lab
        new_labels = lab[:, :out_cap]
    new_sizes = torch.clamp_max(sizes + moved_full, out_cap)
    new_sizes, moved, fail, over = part.gather(
        (new_sizes, new_sizes - sizes, fail, sizes + moved_full > out_cap))
    overflowed = torch.any(over)
    return (ClientData(part.place(buf[:, :out_cap]), new_sizes,
                       part.place(new_labels)), moved, part.place(base),
            part.place(scores), fail, part.place(accept), overflowed)


def _trust_list(trust) -> list:
    """Per-transmitter T_j (N_rx, k_j) numpy matrices from the stacked
    (N_tx, N_rx, k) tensor or a list of matrices."""
    if isinstance(trust, (list, tuple)):
        return [np.asarray(torch.as_tensor(t).cpu()) for t in trust]
    t = trust.cpu().numpy()
    return [t[j] for j in range(t.shape[0])]


def _gate_loop(datasets, labels, trust_np, in_edge, sel, fail_u, p_fail,
               params, ae_cfg, cfg: ExchangeConfig) -> ExchangeResult:
    """The reference's host loop: one mean reconstruction loss per
    receiver and per (receiver, cluster) pair, and a ragged concat."""
    n = len(datasets)
    in_edge = torch.as_tensor(in_edge).cpu().numpy()
    fail_u = torch.as_tensor(fail_u).cpu().numpy()
    p_fail = torch.as_tensor(p_fail).cpu().numpy()
    new_data, new_labels = list(datasets), list(labels)
    moved = np.zeros(n, np.int64)
    decisions = []
    with torch.no_grad():
        for i in range(n):
            j = int(in_edge[i])
            if j == i:
                continue
            if cfg.apply_channel_failure and \
                    float(fail_u[i]) < float(p_fail[i, j]):
                decisions.append((i, j, -1, False))
                continue
            base = float(ae.recon_loss(params[i], datasets[i], ae_cfg))
            for m in range(trust_np[j].shape[1]):
                idx = sel[j][m]
                if int(trust_np[j][i, m]) == 0 or idx.size == 0:
                    continue
                rows = torch.as_tensor(idx, device=datasets[j].device)
                score = float(ae.recon_loss(params[i], datasets[j][rows],
                                            ae_cfg))
                accepted = base < score   # i's AE is worse on the reserve
                decisions.append((i, j, m, accepted))
                if accepted:
                    new_data[i] = torch.cat([new_data[i], datasets[j][rows]])
                    new_labels[i] = torch.cat([new_labels[i],
                                               labels[j][rows]])
                    moved[i] += idx.size
    cd = client_data_from_lists(new_data, new_labels,
                                device=datasets[0].device)
    return ExchangeResult(cd, torch.as_tensor(moved, device=cd.data.device),
                          _decisions=decisions)


def _gate_batched(cd: ClientData, trust_np, in_edge, sel, fail_u, p_fail,
                  params, ae_cfg, cfg: ExchangeConfig,
                  rules=None) -> ExchangeResult:
    """``sel``: the host selector's ragged indices, or the device
    selector's ``(sel_idx, sel_mask)`` tensors (placed per ``rules``)."""
    n, cap = cd.n_clients, cd.cap
    dev = cd.sizes.device
    k_max = max(t.shape[1] for t in trust_np)
    trust_s = _stack_trust_padded(trust_np, n, k_max)
    if isinstance(sel, tuple):
        sel_idx, sel_mask = sel
    else:
        sel_idx, sel_mask = (torch.as_tensor(a, device=dev) for a in
                             _sel_tensors(sel, n, k_max,
                                          cfg.reserve_per_cluster))
    # "grow" (out_cap None): static headroom, the largest reserve payload
    # any transmitter offers this round (a read of the index mask only)
    in_edge = torch.as_tensor(in_edge, device=dev).long()
    new_cd, moved, base, scores, fail, accept, overflowed = _exchange_device(
        params, cd.data, cd.sizes, cd.labels, sel_idx, sel_mask,
        torch.as_tensor(trust_s, device=dev), fail_u, p_fail, in_edge,
        ae_cfg, cfg.apply_channel_failure,
        None if cfg.overflow == "grow" else cap, rules)
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
                 method: Optional[str] = None,
                 device="cuda", rules=None) -> ExchangeResult:
    """Algorithm 2's data-plane step over the discovered graph.

    datasets/labels: ragged lists, or one :class:`ClientData` as
    ``datasets`` (then ``labels`` must be None). assignments: stacked
    (N, cap) cluster ids; trust: stacked (N_tx, N_rx, k) or a list of T_j;
    in_edge: (N,) transmitter of each receiver. ``method`` (default
    ``cfg.method``) picks the data plane; the loop plane needs labels.
    ``ae_params`` (stacked or a list) skips pretraining; otherwise the AEs
    start from ``draws.init_params``. Draws missing come from
    ``generator``. ``rules`` shards the batched plane over the clients
    (module docstring); the draws, trust, P_D and graph stay whole."""
    method = (method or cfg.method).lower()
    if cfg.overflow not in OVERFLOW_POLICIES:
        raise ValueError(f"unknown overflow policy {cfg.overflow!r}; "
                         f"expected one of {OVERFLOW_POLICIES}")
    if cfg.reserve_selector not in RESERVE_SELECTORS:
        raise ValueError(
            f"unknown reserve selector {cfg.reserve_selector!r}; "
            f"expected one of {RESERVE_SELECTORS}")
    if method == "loop" and cfg.overflow != "grow":
        raise ValueError(
            "the loop plane only implements the 'grow' semantics (its "
            "ragged concat has no capacity); use the batched plane for "
            f"overflow={cfg.overflow!r}")
    if method == "loop" and cfg.reserve_selector != "host":
        raise ValueError(
            "the loop plane is the host-selector reference; "
            "reserve_selector='device' requires the batched plane")
    if method not in METHODS:
        raise ValueError(f"unknown exchange method: {method!r}")
    if method == "loop" and rules is not None:
        raise ValueError("the loop plane is the host-side reference and does "
                         "not shard; use method='batched' with rules")
    with obs.span("exchange", method=method):
        dev = resolve_device(device)
        cd = as_client_data(datasets, labels, device=dev, rules=rules)
        n = cd.n_clients
        part = sh.ClientSlice(rules, n)
        trust_np = _trust_list(trust)
        k_max = max(t.shape[1] for t in trust_np)
        device_sel = cfg.reserve_selector == "device"
        if draws is None:
            if generator is None:
                raise ValueError("run_exchange needs draws or a generator")
            draws = draw_exchange(generator, n, ae_cfg,
                                  (k_max, cd.cap) if device_sel else None)
        if not sh.is_dtensor(assignments):
            assignments = torch.as_tensor(assignments, device=dev)
        if device_sel:
            if draws.sel_u is None:
                raise ValueError("reserve_selector='device' needs "
                                 "ExchangeDraws.sel_u")
            sel = part.place(select_reserves_device(
                part.rows(draws.sel_u.to(dev)), part.rows(assignments),
                part.rows(cd.sizes), k_max, cfg.reserve_per_cluster))
        else:
            # the seeded subsets follow every client's ids in order
            assignments = sh.gather_clients(assignments, rules)
            sel = _select_reserves(draws.seed, assignments,
                                   [t.shape[1] for t in trust_np],
                                   cfg.reserve_per_cluster, cd.sizes)
        fail_u = torch.as_tensor(draws.fail_u, device=dev)
        p_fail = torch.as_tensor(p_fail, device=dev)

        if method == "loop":
            data_l, labels_l = cd.data_list(), cd.label_list()
            if labels_l is None:
                raise ValueError("the loop plane needs labels; pass them (the "
                                 "batched plane accepts unlabeled ClientData)")
            if ae_params is None:
                with obs.span("pretrain", method=method):
                    params = pretrain_autoencoders(
                        tree_map(lambda p: p.to(dev), draws.init_params),
                        data_l, ae_cfg, cfg)
            elif isinstance(ae_params, (list, tuple)):
                params = list(ae_params)
            else:
                params = unstack_pytree(ae_params, n)
            with obs.span("gate", method=method):
                return _gate_loop(data_l, labels_l, trust_np, in_edge, sel,
                                  fail_u, p_fail, params, ae_cfg, cfg)
        if ae_params is None:
            with obs.span("pretrain", method=method):
                params = pretrain_autoencoders_batched(
                    tree_map(lambda p: p.to(dev), draws.init_params), cd,
                    ae_cfg, cfg, rules)
        elif isinstance(ae_params, (list, tuple)):
            params = stack_pytrees(list(ae_params), rules)
        else:
            params = ae_params
        with obs.span("gate", method=method):
            return _gate_batched(cd, trust_np, in_edge, sel, fail_u, p_fail,
                                 params, ae_cfg, cfg, rules)
