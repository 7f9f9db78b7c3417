"""Logical-axis rules and the client plane's collectives (mirrors
``repro.sharding``).

The rules half is metadata, as in the reference. Tensor dimensions carry
*logical* axes ("batch", "d_ff", "clients", ...) and a :class:`ShardingRules`
maps them onto the mesh axes ("pod", "data", "model"). A dimension whose
size does not divide its mesh axes is replicated, and a mesh axis already
used by an earlier dimension is not used again. :meth:`ShardingRules.spec`
returns the reference's ``PartitionSpec`` entries as a plain tuple. The mesh
is a live ``DeviceMesh`` or a shape alone (``{"data": 16, "model": 16}``), so
specs can be computed for meshes this machine does not have.

The client half shards the federation's client stacks (every per-client
tensor has a leading CLIENTS axis) over a ``DeviceMesh`` with one "data"
dimension (``launch.mesh.make_client_mesh``). JAX lets XLA insert every
collective a ``NamedSharding`` implies; eager PyTorch does not, so here:

  * between stages a client stack is a ``DTensor``, ``Shard(0)`` or, when N
    does not divide the data axis, ``Replicate()`` (:func:`shard_clients`);
  * a stage computes on plain local shards (:class:`ClientSlice`: its
    ``rows``, and ``place`` for the outputs), with global row indices where
    a client looks at another client's row or column;
  * each cross-client read is one collective that the stage runs itself
    through this module. DTensor never redistributes a stack: nothing in
    the plane runs an operator on a DTensor.

A replicated stack is computed whole on every rank, exactly as unsharded,
and then no collective runs; nor does any at ``rules=None``. The sharded
plane's collectives, stage by stage (several tensors travel packed in one
buffer):

============  ===========================================================
clustering    an all-reduce of the PCA moments (sum x, sum x x^T, n)
              (``core.pca.fit_pca_federated_stacked``)
lambda        an all-gather of the (N, k, d) centroids for beta and the
              lambda matrix (``core.pipeline.link_rewards``' callers)
discovery     per episode an all-reduce of the mean local reward and the
              mean P_D of the chosen links; per buffer flush one of r_net;
              at the burst's end an all-gather of the agents' links
              (``core.qlearning``)
exchange      with the host reserve selector an all-gather of the cluster
              ids; the gate's all-gather of the transmitters' reserve rows,
              labels and masks (the D2D transfer); after the scatter an
              all-gather of the new sizes, the moved counts and the overflow
              flag (``core.exchange._exchange_device``)
FL            FedAvg/FedProx: an all-reduce of the masked parameter sum, one
              a round, the tree flattened into one buffer; FedSGD: one an
              iteration (``fl.trainer``)
orchestrator  a checkpoint: an all-gather of the state, then a barrier after
              rank 0's write; the run's end: an all-gather of the final
              client stack (``dynamics.orchestrator``)
============  ===========================================================

A ``ClientData``'s ``sizes`` stays whole on every rank (``core.batching``):
the draws map their uniforms onto every client's size, and the exchange's
result gather brings the new sizes, so keeping them whole costs no
collective of its own.

The default process group is never initialised on import; the mesh
constructors in ``launch.mesh`` do that.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import torch

# Logical axis names used throughout the model code (the reference's).
BATCH = "batch"
SEQ = "seq"
D_MODEL = "d_model"
D_FF = "d_ff"
HEADS = "heads"
KV_HEADS = "kv_heads"
KV_SEQ = "kv_seq"
HEAD_DIM = "head_dim"
VOCAB = "vocab"
EXPERTS = "experts"
CLIENTS = "clients"
STACK = "stack"  # leading scan-over-layers axis; never sharded
SCALAR = "scalar"  # logical marker for 0-dim tensors (an empty spec)


def _mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a shape mapping."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(k): int(v) for k, v in zip(mesh.mesh_dim_names, mesh.shape)}


def _axes(ax) -> tuple:
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _axis_size(shape: dict, axes) -> int:
    if axes is None:
        return 1
    return math.prod(shape[a] for a in _axes(axes))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to (tuples of) mesh axis names. ``mesh`` is
    a ``DeviceMesh`` (the client plane places tensors on it) or a shape
    mapping (specs only)."""

    mesh: Any
    rules: Mapping[str, Any]

    def __hash__(self):
        def _t(v):
            return tuple(v) if isinstance(v, (list, tuple)) else v
        return hash((tuple(self.shape.items()),
                     tuple(sorted((k, _t(v)) for k, v in self.rules.items()))))

    @property
    def shape(self) -> dict:
        """{mesh axis name: size}, in the mesh's order."""
        return _mesh_shape(self.mesh)

    @classmethod
    def default(cls, mesh) -> "ShardingRules":
        """The reference's layout: batch and clients over the data-parallel
        product (pod, data); d_model FSDP over it; d_ff, heads, kv heads,
        kv_seq, vocab and experts over "model"."""
        dp = ("pod", "data") if "pod" in _mesh_shape(mesh) else ("data",)
        return cls(mesh=mesh, rules={
            BATCH: dp, CLIENTS: dp, SEQ: None, D_MODEL: dp, D_FF: "model",
            HEADS: "model", KV_HEADS: "model", KV_SEQ: "model",
            HEAD_DIM: None, VOCAB: "model", EXPERTS: "model", STACK: None})

    def spec(self, logical: Sequence[Optional[str]] | str,
             dims: Optional[Sequence[int]] = None) -> tuple:
        """The ``PartitionSpec`` entries, as a tuple, of a tensor whose
        dimensions carry ``logical``. With ``dims``, a logical axis whose
        size does not divide its mesh axes is replicated (``None``); a mesh
        axis already used by an earlier dimension is not reused. ``SCALAR``
        gives the empty spec."""
        if isinstance(logical, str):
            return ()
        shape = self.shape
        entries, used = [], set()
        for i, name in enumerate(logical):
            ax = None if name is None else self.rules.get(name)
            if ax is None or any(a in used for a in _axes(ax)):
                entries.append(None)
                continue
            if dims is not None and dims[i] % _axis_size(shape, ax) != 0:
                entries.append(None)
                continue
            used.update(_axes(ax))
            # one mesh axis as its name, as a PartitionSpec normalises it
            entries.append(ax if len(_axes(ax)) > 1 else _axes(ax)[0])
        return tuple(entries)

    def data_axes(self) -> tuple:
        return _axes(self.rules[BATCH])


def client_axes(ndim: int) -> tuple:
    """Logical axes of a tensor whose leading dim is the client stack."""
    if ndim == 0:
        return ()
    return (CLIENTS,) + (None,) * (ndim - 1)


# ---------------------------------------------------------------------------
# trees (dicts, lists, tuples and named tuples, as the plane's states are)
# ---------------------------------------------------------------------------

def _map(fn, tree):
    """``fn`` over the leaves, dicts visited in sorted key order (JAX's
    flatten order), so leaf order does not depend on insertion order."""
    if isinstance(tree, dict):
        out = {k: _map(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    out = []
    _map(lambda x: out.append(x) if isinstance(x, torch.Tensor) else None,
         tree)
    return out


def _refill(tree, leaves):
    it = iter(leaves)
    return _map(lambda x: next(it) if isinstance(x, torch.Tensor) else x,
                tree)


_DTENSOR: list = []   # the DTensor class, resolved on first use


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    if not _DTENSOR:
        if torch.distributed.is_available():
            from torch.distributed.tensor import DTensor
            _DTENSOR.append(DTensor)
        else:
            _DTENSOR.append(type(None))
    return isinstance(x, _DTENSOR[0])


# ---------------------------------------------------------------------------
# the collectives: every one the plane runs goes through these three
# ---------------------------------------------------------------------------

def _group(rules: ShardingRules):
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(rules.mesh, DeviceMesh):
        raise ValueError("a shape-only mesh places nothing; build the rules "
                         "on a DeviceMesh (launch.mesh.make_client_mesh)")
    axes = _axes(rules.rules[CLIENTS])
    if len(axes) != 1:
        raise NotImplementedError(
            f"the client plane shards over one mesh dimension; CLIENTS maps "
            f"to {axes}")
    return rules.mesh.get_group(axes[0])


def _all_reduce(t: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    torch.distributed.all_reduce(t, group=_group(rules))
    return t


def _all_gather(t: torch.Tensor, rules: ShardingRules, k: int) -> torch.Tensor:
    """(n_l, ...) from each of the k ranks -> (k * n_l, ...) in rank order."""
    t = t.contiguous()
    out = t.new_empty((k * t.shape[0],) + tuple(t.shape[1:]))
    dist = torch.distributed
    # newer torch names it all_gather_single (the old name warns as
    # deprecated); older releases have only all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, t, group=_group(rules))
    return out


def barrier(rules: Optional[ShardingRules]) -> None:
    """Wait until every rank of the client axis gets here (a one-element
    all-reduce: NCCL's barrier would guess a device)."""
    if rules is None or _axis_size(rules.shape, rules.rules[CLIENTS]) == 1:
        return
    dev = rules.mesh.device_type
    t = torch.zeros(1, device=torch.device(
        dev, torch.cuda.current_device()) if dev == "cuda" else dev)
    _all_reduce(t, rules)


# ---------------------------------------------------------------------------
# one rank's slice of an N-client stack
# ---------------------------------------------------------------------------

def _pack_rows(tensors) -> torch.Tensor:
    """(n_l, ...) tensors of any dtypes -> one (n_l, bytes) uint8 buffer."""
    cols = []
    for t in tensors:
        t = t.contiguous()
        if t.dtype == torch.bool:
            t = t.to(torch.uint8)
        cols.append(t.reshape(t.shape[0], -1).view(torch.uint8))
    return torch.cat(cols, dim=1)


def _unpack_rows(buf: torch.Tensor, like) -> list:
    out, off = [], 0
    for t in like:
        dt = torch.uint8 if t.dtype == torch.bool else t.dtype
        width = math.prod(t.shape[1:]) * dt.itemsize
        col = buf[:, off:off + width].contiguous().view(dt)
        col = col.reshape((buf.shape[0],) + tuple(t.shape[1:]))
        out.append(col.to(torch.bool) if t.dtype == torch.bool else col)
        off += width
    return out


class ClientSlice:
    """This rank's rows ``[lo, hi)`` of an N-client stack under ``rules``,
    and the plane's collectives over them. With ``rules=None``, or when N
    does not divide the client axis (the stack is then replicated), it is
    the whole stack and every collective is the identity, so a stage body
    written against it is the unsharded program. On a one-rank client axis
    the collectives run over the one-rank group."""

    def __init__(self, rules: Optional[ShardingRules], n: int):
        self.rules, self.n = rules, int(n)
        ax = None if rules is None else rules.spec((CLIENTS,), (self.n,))[0]
        # placed: Shard(0) over the client axis, perhaps of one rank, whose
        # collectives then run over a one-rank group
        self.sharded = ax is not None
        self.k = _axis_size(rules.shape, ax) if self.sharded else 1
        rank = 0
        if self.sharded:
            _group(rules)                 # a live mesh, one dimension
            rank = rules.mesh.get_local_rank(_axes(ax)[0])
        m = self.n // self.k
        self.lo, self.hi = rank * m, (rank + 1) * m

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    # -- local views ------------------------------------------------------
    def rows(self, tree, dim: int = 0):
        """Every tensor leaf's rows of this slice along ``dim``: a DTensor's
        local shard, or the rows of a whole tensor (draws, masks and graphs
        are whole on every rank)."""
        def one(x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0:
                return x
            if is_dtensor(x):
                if dim != 0:
                    raise ValueError("a DTensor's client axis is dim 0")
                _check_placed(x, self)
                return x.to_local()
            if x.shape[dim] != self.n:
                raise ValueError(f"expected {self.n} clients along dim {dim}, "
                                 f"got shape {tuple(x.shape)}")
            if not self.sharded:
                return x
            return x.narrow(dim, self.lo, self.n_local)
        return _map(one, tree)

    def self_mask(self, device) -> torch.Tensor:
        """(n_local, N) bool, True at each row's own (global) column."""
        return (torch.arange(self.lo, self.hi, device=device)[:, None]
                == torch.arange(self.n, device=device)[None, :])

    # -- placement --------------------------------------------------------
    def place(self, tree):
        """Local rows -> DTensors of the N-client stack (no communication);
        the identity at ``rules=None``."""
        if self.rules is None:
            return tree
        from torch.distributed.tensor import Replicate, Shard, DTensor
        mesh = self.rules.mesh
        axes = _axes(self.rules.rules[CLIENTS])

        def one(x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0 or \
                    is_dtensor(x):
                return x
            shape = (self.n,) + tuple(x.shape[1:])
            placements = [Shard(0) if self.sharded and name in axes
                          else Replicate() for name in mesh.mesh_dim_names]
            stride, acc = [], 1
            for s in reversed(shape):
                stride.append(acc)
                acc *= s
            return DTensor.from_local(x, mesh, placements, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=tuple(reversed(stride)))
        return _map(one, tree)

    # -- collectives ------------------------------------------------------
    def gather(self, tree):
        """Local rows of every leaf -> the whole (N, ...) tensors on every
        rank, in one all-gather (leaves of any dtype, packed as bytes)."""
        leaves = [x for x in _leaves(tree) if x.dim() > 0]
        if not self.sharded or not leaves:
            return tree
        full = _unpack_rows(_all_gather(_pack_rows(leaves), self.rules,
                                        self.k), leaves)
        it = iter(full)
        return _map(lambda x: next(it) if isinstance(x, torch.Tensor)
                    and x.dim() > 0 else x, tree)

    def psum(self, tree):
        """Partial sums over this slice's clients -> the sums over all N, in
        one all-reduce (floating leaves of one dtype)."""
        leaves = _leaves(tree)
        if not self.sharded or not leaves:
            return tree
        flat = torch.cat([x.reshape(-1) for x in leaves])
        _all_reduce(flat, self.rules)
        out, off = [], 0
        for x in leaves:
            out.append(flat[off:off + x.numel()].reshape(x.shape))
            off += x.numel()
        return _refill(tree, out)

    def mean(self, tree):
        """Each leaf's mean over the leading client axis of the N-client
        stack whose local rows it holds: each rank's local mean weighted by
        its share of the clients, summed in one all-reduce. At one rank the
        weight is 1.0, so the result is ``torch.mean`` bit for bit."""
        means = _map(lambda x: (torch.mean(x) if x.dim() == 1 else
                                torch.mean(x, dim=0))
                     if isinstance(x, torch.Tensor) else x, tree)
        if not self.sharded:
            return means
        w = self.n_local / self.n
        return self.psum(_map(lambda x: x * w if isinstance(x, torch.Tensor)
                              else x, means))


def gather_clients(tree, rules: Optional[ShardingRules]):
    """Every DTensor leaf of ``tree`` whole on every rank, in one all-gather
    per client count (host views, checkpoints, digests); other leaves pass
    through. The gather is explicit, never DTensor's redistribute."""
    counts = sorted({x.shape[0] for x in _leaves(tree) if is_dtensor(x)})
    for n in counts:
        if rules is None:
            sl = None
        else:
            sl = ClientSlice(rules, n)
        pick = (lambda x, n=n: is_dtensor(x) and x.shape[0] == n)
        locs = [x.to_local() for x in _leaves(tree) if pick(x)]
        full = iter(locs if sl is None else sl.gather(locs))
        tree = _map(lambda x: next(full) if pick(x) else x, tree)
    return tree


def full_tensor(x):
    """One client stack whole on every rank (:func:`gather_clients` with the
    reference's default rules over the DTensor's own mesh)."""
    if not is_dtensor(x):
        return x
    return gather_clients(x, ShardingRules.default(x.device_mesh))


# ---------------------------------------------------------------------------
# the reference's client-axis helpers
# ---------------------------------------------------------------------------

def shard_clients(tree, rules: Optional[ShardingRules]):
    """Place every tensor leaf's leading client axis per ``rules``: a
    ``Shard(0)`` DTensor, or ``Replicate()`` when N does not divide the
    client axis. Whole tensors are sliced locally (every rank holds the
    same whole tensor, so no data moves) and a shard of several ranks is
    copied out, so the placed stack holds only this rank's rows, not a
    view of the whole; DTensors already placed pass through; 0-dim leaves
    stay plain. ``rules=None`` is the identity."""
    if rules is None:
        return tree

    def one(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        sl = ClientSlice(rules, x.shape[0])
        if is_dtensor(x):
            _check_placed(x, sl)
            return x
        rows = sl.rows(x)
        return sl.place(rows.clone() if sl.k > 1 else rows)
    return _map(one, tree)


def _check_placed(x, sl: ClientSlice) -> None:
    loc = x.to_local().shape[0]
    if loc != sl.n_local:
        raise ValueError(
            f"a DTensor of {x.shape[0]} clients holds {loc} rows here; the "
            "client plane never redistributes a stack, re-place it whole")


def constrain_clients(tree, rules: Optional[ShardingRules]):
    """Check that every DTensor leaf is placed as ``rules`` places it (the
    reference's in-jit constraint; a stack placed otherwise raises rather
    than being redistributed) and place the whole tensors."""
    return shard_clients(tree, rules)


def client_sum(x, rules: Optional[ShardingRules]):
    """Sum over the leading (possibly sharded) client axis, whole on every
    rank: per-shard partial sums and one all-reduce. ``rules=None`` is a
    plain sum."""
    if rules is None:
        return torch.sum(x, dim=0)
    sl = ClientSlice(rules, x.shape[0])
    return sl.psum(torch.sum(sl.rows(x), dim=0))


def client_mean(x, rules: Optional[ShardingRules]):
    """Mean over the leading (possibly sharded) client axis, whole on every
    rank (:meth:`ClientSlice.mean`). ``rules=None`` is a plain mean."""
    if rules is None:
        return torch.mean(x, dim=0)
    sl = ClientSlice(rules, x.shape[0])
    return sl.mean(sl.rows(x))
