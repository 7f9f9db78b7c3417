"""Logical-axis rules, and the collectives of the client plane and of the
model plane (mirrors ``repro.sharding``).

The rules half is metadata, as in the reference. Tensor dimensions carry
*logical* axes ("batch", "d_ff", "clients", ...) and a :class:`ShardingRules`
maps them onto the mesh axes ("pod", "data", "model"). A dimension whose
size does not divide its mesh axes is replicated, and a mesh axis already
used by an earlier dimension is not used again. :meth:`ShardingRules.spec`
returns the reference's ``PartitionSpec`` entries as a plain tuple. The mesh
is a live ``DeviceMesh`` or a shape alone (``{"data": 16, "model": 16}``), so
specs can be computed for meshes this machine does not have.

The client half shards the federation's client stacks (every per-client
tensor has a leading CLIENTS axis) over the data-parallel axes of a
``DeviceMesh``: "data" (``launch.mesh.make_client_mesh``) or the product
("pod", "data"), whose ranks form one group in row-major order
(:func:`axis_group`). JAX lets XLA insert every
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
and then no collective runs; nor does any at ``rules=None``, nor on a
one-rank client axis, where each is the identity. The sharded plane's
collectives above one rank, stage by stage (several tensors travel packed
in one buffer):

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

The model half (:class:`ModelPlane`) runs every transformer family (the
dense, MoE, recurrent, vision-stub and audio-codec configs) on a (data,
model) or (pod, data, model) mesh
(``models.transformer``): each rank holds the shards ``ShardingRules.spec``
gives it (:func:`place_params`) and computes on them; every collective the
layout needs goes through the plane's autograd functions, whose backward
is the adjoint collective. Per
unit (one attention block with its MLP) of L, with "D" the data axes and
"M" the model axis; ``kvg`` is 1 when M does not divide the KV heads (their
columns are then all-gathered over M), and ``kvs`` 1 when the cache then
lies over its slots (M divides them; else it lies whole on every rank,
below):

========  ==================================================================
prefill   a unit: an all-gather over D (its weights, one buffer), kvg over
          M (wk, wv), an all-reduce over M after ``wo`` and one after the
          MLP's ``wo``; the step: an all-gather over D of the embedding,
          an all-reduce over M of the lookup, an all-gather over D of the
          final norm and head, one over M of the logits
decode    as prefill, and per unit with kvs: an all-gather over M of the
          query heads and three all-reduces over M (the softmax's max, its
          sum, the partial P V)
train     the forward as prefill's (no logits gather) plus, for the loss,
          two all-reduces over M (max; the exponentials' sum with the
          label's logit) and one over D (token sum and count); block remat
          recomputes each unit's forward up to its last saved tensor (all
          but the MLP's closing collective); the backward: per unit a
          reduce-scatter over D and kvg over M (the gathers' adjoints), an
          all-reduce over M before each of the three column-parallel
          products (the attention's, the MLP's and the head's input); a
          reduce-scatter over D for the embedding and one for the final
          norm and head; the step: one all-reduce over D and M (the global
          norm), and one over D of any leaf stored whole there
seq       ``act_seq_shard`` (train, prefill): each all-reduce over M after a
          row-parallel product becomes a reduce-scatter along S, each
          column-parallel product (the head's too) starts with an
          all-gather along S, the embedding's all-reduce is a
          reduce-scatter; the backward swaps each for the other; the train
          step adds one all-reduce over M of the norm scales' gradients
========  ==================================================================

A collective over axes of one rank is the identity and does not run
(:class:`ModelPlane`), so a step runs the terms of the axes above one rank
only: D, M, or "DM", the product of both (the global norm's). Summed over
a step, by kind (AG all-gather, RS reduce-scatter, AR all-reduce) and
axes:

=================  ==========  ============  ======
                   D           M             DM
=================  ==========  ============  ======
prefill            AG L + 2    AG L kvg + 1
                               AR 2L + 1
prefill, seq       AG L + 2    AG L kvg
                               + 2L + 2
                               RS 2L + 1
decode step        AG L + 2    AG L kvg + 1
                               + L kvs
                               AR 2L + 1
                               + 3L kvs
train, remat       AG 2L + 2   AG 2L kvg     AR 1
                   RS L + 2    RS L kvg
                   AR 1        AR 5L + 4
train, remat, seq  AG 2L + 2   AG 2L kvg     AR 1
                   RS L + 2    + 6L + 2
                   AR 1        RS L kvg
                               + 5L + 2
                               AR 3
=================  ==========  ============  ======

(kvg as counted assumes M divides the KV columns, as every dense config's
do on the meshes here; a weight stored whole is ``copy``-ed instead, whose
forward moves nothing: see the uneven table below.)
``tests/test_torch_model_plane.py`` holds every count to this table on
gloo ranks. On a :class:`CountingMesh` the same
calls record their bytes instead of running (``launch.dryrun``'s
production meshes).

An MoE unit (an attention block whose second branch is the MoE,
``models.moe``) runs as a dense unit with the MoE in the MLP's place:
the routed experts split along E over M where M divides them, else along
their d_ff; the shared experts column/row-parallel; the router whole on
every rank. With ``rg`` 1 when M divides the experts (the router is then
stored split over M) and ``cg`` 1 when the step's capacity groups span
data ranks (the gather dispatch's one group of the batch's tokens, a
decode step's included, or a ``moe_group_size`` above a rank's tokens):

========  ==================================================================
prefill   as a dense unit (one all-reduce over M after the routed and
          shared outputs' sum), plus an all-gather over M of the router
          (rg; ``ModelPlane.replicate``) and one over D of the
          per-(group, expert) choice counts (cg; ``gather_counts``)
decode    as prefill
train     the forward as prefill's, plus per unit one all-reduce over D
          of the aux loss's two (E,) sums and token count; the backward:
          an all-reduce over M of the gates' gradient (their ``copy``);
          the router's gather has no backward collective (each rank keeps
          its slice of the whole gradient)
seq       the MoE's input is all-gathered along S through ``replicate``
          (the router reads whole rows); the expert branch's ``copy`` of it
          all-reduces its gradient over M where ``_mlp``'s input
          reduce-scatters along S
========  ==================================================================

Added to the dense table's counts (remat recomputes the router's gather,
the counts' gather and the aux sum):

=================  ==========  ============
                   D           M
=================  ==========  ============
prefill            AG cg L     AG rg L
decode step        AG cg L     AG rg L
train, remat       AG 2 cg L   AG 2 rg L
                   AR 2L       AR L
train, remat, seq  AG 2 cg L   AG 2 rg L
                   AR 2L       RS -L
                               AR 2L
=================  ==========  ============

The recurrent blocks (``models.rglru``, ``models.xlstm``) run on their
D_FF channels over M, each with the dense unit's column- and row-parallel
pair: "enter" (forward nothing, backward an all-reduce over M; under seq
an all-gather along S, a reduce-scatter backward) and "exit" (an
all-reduce over M, nothing backward; under seq a reduce-scatter along S,
an all-gather backward). Their state lies as the cache does
(``transformer.cache_logical``): the RG-LRU's on the rank's channels; the
mLSTM's and sLSTM's whole, each rank computing the cell alike, with no
collective inside a loop over time. recurrentgemma's local attention is a
dense unit's attention block (one KV head: kvg is 1 above one rank). Per
block, with "g" 1 when M divides the mLSTM's inner width and "h" 1 when M
divides the sLSTM's heads (both then stored split over M):

========  ==========================================  =======================
block     forward                                     backward (train)
========  ==========================================  =======================
rglru     AG D (weights); enter; RS M (the gates'     RS D; AG M (the gates'
          products by the rank's rows of w_a, w_i,    sums); AR M (b_a, b_i,
          to its channels); exit; the MLP's pair      cut from whole: copy);
                                                      the pairs'
mlstm     AG D; enter; AG M (w_up: the rank's x_i     RS D; RS M (w_up); AG M
          and z columns); g AG M (gn, replicate);     (the output's ``split``
          AR M (the partial q, k, v, i, f, one        to the rank's channels);
          buffer); the cell whole; exit               the pair's
slstm     AG D; enter; AG M (W x's columns,           RS D; the pairs'; under
          replicate); AG M (b_gates); h AG M          seq AG M (the output's
          (r_gates); the loop whole; the FFN's pair   split along S)
========  ==========================================  =======================

Summed over a unit of b blocks, the unit's closing exit not recomputed
under remat (recurrentgemma's: rglru, rglru, local_attn, b = 3; xlstm's:
mlstm, slstm, b = 2):

=================  =====  =========================  =====================
                   D      M, recurrentgemma          M, xlstm
=================  =====  =========================  =====================
prefill            AG b   AG kvg; RS 2; AR 6         AG 3 + g + h; AR 3
prefill, seq       AG b   AG 6 + kvg; RS 8           AG 6 + g + h; AR 1;
                                                     RS 2
decode step        AG b   AG 2 kvg; RS 2;            AG 3 + g + h; AR 3
                          AR 6 + 3 kvg
train, remat       AG 2b  AG 2 + 2 kvg; RS 4 + kvg;  AG 7 + 2g + 2h; RS 1;
                   RS b   AR 19                      AR 8
train, remat, seq  AG 2b  AG 20 + 2 kvg;             AG 16 + 2g + 2h; AR 2;
                   RS b   RS 21 + kvg; AR 2          RS 7
=================  =====  =========================  =====================

A step adds the dense
table's step terms and, in training, one all-reduce over D of the
gradients of the leaves stored whole there (the recurrent blocks' conv,
gate and bias weights); under seq the norm scales' all-reduce over M
covers the blocks' own ``ln``. ``tests/test_torch_recurrent_plane.py``
holds every count to these tables on gloo ranks.

The frontends' layers are dense units. What they add is at the step's
ends (``transformer._Plan.embed``, ``_Plan.logits``):

========  ==================================================================
vision    the projector ``embed.proj`` (F, D) is stored FSDP over D and
          whole over M; it joins the embedding's all-gather over D (one
          buffer, no call of its own; a decode step embeds no image and
          gathers the token table alone). Its image rows ``embeds @ proj``
          are whole on every rank and go ahead of the text rows after the
          lookup's all-reduce over M, so they never enter that sum. Under
          seq the whole sequence's rows are reduce-scattered along S: the
          image rows enter the sum on M rank 0 alone (zeros elsewhere), so
          each position has one nonzero term; the backward adds one
          all-reduce over M, the projector's ``copy`` (its gradient is
          nonzero on rank 0 alone). M-RoPE's (B, S, 3) positions are the
          batch's, whole along S.
audio     the table (nq, V, D) lies over M along V; each codebook's lookup
          is masked to the rank's rows and the (nq, B, S, D) stack of
          partial rows is summed in one all-reduce over M (under seq one
          reduce-scatter along S), then added in codebook order: each
          entry has one nonzero term, so every mesh sums the codebooks in
          the unsharded order and rounding; a local sum and one all-reduce
          of (B, S, D) would move 1/nq of the bytes but round differently
          above one rank. The head (D, nq V) stores contiguous parts of
          nq V columns, where the rank needs ``q V + split_range(V, M, r)``
          of every codebook (the loss's and the serve gather's split): it
          is all-gathered over M and cut (at M = 1 the stored whole), as
          the mLSTM's ``w_up`` is. The (D, nq V) weight moves fewer bytes
          than the rank's (B, S, nq V / M) logits would at any train or
          prefill shape of the configs
========  ==================================================================

Added to the dense table's counts, over M only:

=================  ====================  =========================
                   vision                audio
=================  ====================  =========================
prefill                                  AG 1
decode step                              AG 1
train, remat                             AG 1; RS 1
train, remat, seq  AR 1                  AG 1; RS 1
=================  ====================  =========================

``tests/test_torch_frontend_plane.py`` holds every count to these tables
on gloo ranks.

A model axis that does not divide a width: ``rules.spec`` stores such a
dimension whole over M, and the plane computes it as stored. A part of a
layer that each rank computes on its own share (query heads, d_ff, vocab,
an expert's d_ff) stays split, unevenly, by ``split_range``; a part whose
state or cache would have to be split (the KV_SEQ cache, the recurrent
channels) is computed whole on every model rank, with no collective
inside it, as the xLSTM cells already were:

=============  ===============================================================
what           how; its collectives over M
=============  ===============================================================
a weight       (heads, d_ff, vocab, an expert's d_ff; the KV columns where M
stored whole,  divides neither them nor the heads) cut to the rank's part
cut            through ``copy``: forward nothing, backward one all-reduce a
               block of all such weights' gradients ("cp"); the KV columns'
               copy stands in for kvg's all-gather
KV_SEQ cache   (M divides neither the KV heads nor the cache's W slots)
               whole on every rank, as ``init_cache(rules=)`` lays it:
               prefill writes every slot, a decode step writes its slot on
               every rank and each rank attends with its own query heads to
               the KV heads they read; kvs 0: no query all-gather, no
               combine. The cache holds its capacity ("cap"): its local
               shape alone does not tell the two layouts apart
rglru          (M does not divide its channels) whole on every rank: its
               weights, h and conv state whole; no enter, no reduce-scatter
               of the gates, no exit; under seq its input is gathered along S
               through ``replicate`` (backward: this rank's part) and its
               output cut by ``split`` (backward: an all-gather); its MLP
               stays the dense pair
mlstm          (M does not divide the inner width) whole on every rank, as
               the RG-LRU: no ``w_up`` or ``gn`` gather, no all-reduce of
               q, k, v and the gates, no split of the cell's output
slstm          (M does not divide W x's 4 D columns) W x computed whole: no
               all-gather of it or of ``b_gates``; the loop and the FFN's
               pair as above
=============  ===============================================================

A whole block's weights' gradients are whole on every rank, so a step sums
none of them over M (``transformer.grad_sum_axes``); under seq its norm
scale is applied to the rank's part of S and summed over M as the others
are. Per block, in the recurrent table's terms (a block that divides keeps
its row there):

=============  ================================  ==========================
block          forward                           backward (train)
=============  ================================  ==========================
rglru, whole   AG D; seq: AG M; the MLP's pair   RS D; seq: AG M; the
                                                 pair's; cp
mlstm, whole   AG D; seq: AG M                   RS D; seq: AG M
slstm, whole   AG D; seq: AG M; h AG M           RS D; seq: AG M; the
               (r_gates); the FFN's pair         pair's; cp
=============  ================================  ==========================

and an attention block with cp adds one all-reduce over M to its backward.
At the step's ends the embedding and the head, stored whole and cut where
M does not divide the vocab, add one all-reduce over M each to a train
step's backward (the vision projector's copy under seq joins the
embedding's). ``tests/test_torch_uneven_plane.py`` holds every count to
these rows at M = 3, which divides no width of the smoke configs.

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

def axis_group(mesh, axes):
    """The process group over the mesh axes ``axes`` (one name or a tuple)
    that holds this rank: one mesh dimension's own group, or for a product
    of dimensions (("pod", "data")) a group over their ranks in the
    product's row-major order, the order a ``PartitionSpec`` entry of
    several axes shards in. Product groups are made once per mesh, every
    one of them on every rank in the same order (``new_group`` is
    collective), and kept on the mesh object."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_product_groups", {})
    if axes not in groups:
        names = list(mesh.mesh_dim_names)
        rest = [n for n in names if n not in axes]
        order = [names.index(n) for n in rest + list(axes)]
        rows = mesh.mesh.permute(order).reshape(-1, math.prod(
            mesh.shape[names.index(n)] for n in axes))
        me = torch.distributed.get_rank()
        for row in rows.tolist():
            g = torch.distributed.new_group(row)
            if me in row:
                groups[axes] = g
    return groups[axes]


def axis_rank(mesh, axes) -> int:
    """This rank's index along the mesh axes ``axes``: for a product of
    dimensions the row-major linear index over them (the shard a
    ``PartitionSpec`` entry of several axes gives it); 0 on a shape-only
    mesh, whose count stands for the first rank."""
    if isinstance(mesh, Mapping):
        return 0
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.shape[mesh.mesh_dim_names.index(a)] + \
            mesh.get_local_rank(a)
    return idx


def _group(rules: ShardingRules):
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(rules.mesh, DeviceMesh):
        raise ValueError("a shape-only mesh places nothing; build the rules "
                         "on a DeviceMesh (launch.mesh.make_client_mesh)")
    return axis_group(rules.mesh, rules.rules[CLIENTS])


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
    the stack is placed ``Shard(0)`` all the same, and every collective is
    the identity too: it returns its input and runs nothing."""

    def __init__(self, rules: Optional[ShardingRules], n: int):
        self.rules, self.n = rules, int(n)
        ax = None if rules is None else rules.spec((CLIENTS,), (self.n,))[0]
        # placed: Shard(0) over the client axis, perhaps of one rank, whose
        # collectives are then the identity
        self.sharded = ax is not None
        self.k = _axis_size(rules.shape, ax) if self.sharded else 1
        rank = 0
        if self.sharded:
            _group(rules)                 # a live mesh
            rank = axis_rank(rules.mesh, ax)
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
        rank, in one all-gather (leaves of any dtype, packed as bytes); the
        identity on one rank."""
        leaves = [x for x in _leaves(tree) if x.dim() > 0]
        if self.k == 1 or not leaves:
            return tree
        full = _unpack_rows(_all_gather(_pack_rows(leaves), self.rules,
                                        self.k), leaves)
        it = iter(full)
        return _map(lambda x: next(it) if isinstance(x, torch.Tensor)
                    and x.dim() > 0 else x, tree)

    def psum(self, tree):
        """Partial sums over this slice's clients -> the sums over all N, in
        one all-reduce (floating leaves of one dtype); the identity on one
        rank."""
        leaves = _leaves(tree)
        if self.k == 1 or not leaves:
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


# ---------------------------------------------------------------------------
# the model plane: one rank's view of a (pod, data, model) mesh
# ---------------------------------------------------------------------------

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


class CountingMesh(dict):
    """A mesh as a shape, for counting one rank's step (``launch.dryrun``):
    the model plane's collectives run no process group; each records its
    kind, mesh axes and result bytes here (as the reference's
    ``parse_collective_bytes`` sums result shapes) and returns an empty
    tensor of the result's shape and dtype on the input's device (``meta``
    in the dry run). It stands for the mesh's first rank."""

    def __init__(self, shape: Mapping):
        super().__init__({str(k): int(v) for k, v in shape.items()})
        self.calls: dict = {}
        self.bytes: dict = {}

    def record(self, kind: str, axes: tuple, nbytes: int) -> None:
        key = (kind, tuple(axes))
        self.calls[key] = self.calls.get(key, 0) + 1
        self.bytes[key] = self.bytes.get(key, 0) + int(nbytes)

    def by_kind(self) -> dict:
        """{kind: result bytes} over every axis group, each of ``KINDS``."""
        out = {k: 0 for k in KINDS}
        for (kind, _), b in self.bytes.items():
            out[kind] += b
        return out

    def summary(self) -> list:
        """[{kind, axes, calls, bytes}] sorted by kind then axes."""
        return [{"kind": k, "axes": list(a), "calls": self.calls[(k, a)],
                 "bytes": self.bytes[(k, a)]}
                for k, a in sorted(self.calls)]


def _gather_fn():
    dist = torch.distributed
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


def _scatter_fn():
    dist = torch.distributed
    return getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor


def split_range(n: int, k: int, i: int) -> tuple:
    """Part ``i`` of ``n`` items over ``k`` ranks: [i n // k, (i+1) n // k)
    (equal parts when k divides n)."""
    return i * n // k, (i + 1) * n // k


class ModelPlane:
    """The model plane's collectives and local shapes on one rank of a
    mesh with a "model" axis (``launch.mesh.make_host_mesh``, or a
    :class:`CountingMesh` for the dry run).

    ``dp`` is the data-parallel product the rules put BATCH and D_MODEL on
    (("data",) or ("pod", "data")), ``model`` the tensor-parallel axis and
    ``all`` both (a mesh axis the rules do not use, such as a test's
    "replica", holds independent copies). Each collective goes through one of the
    autograd functions below, whose backward is the collective's adjoint:

    =============  =============================  ==========================
    method         forward                        backward
    =============  =============================  ==========================
    ``gather``     all-gather along ``dim``       reduce-scatter along it
    ``scatter``    reduce-scatter along ``dim``   all-gather along it
    ``psum``       all-reduce (sum)               identity
    ``copy``       identity                       all-reduce (sum)
    ``replicate``  all-gather along ``dim``       this rank's slice
    ``split``      this rank's slice              all-gather along ``dim``
    =============  =============================  ==========================

    ``gather_counts`` is a plain all-gather over the data axes (no
    autograd) of a small int tensor.

    ``gather_packed``, ``copy_packed`` and ``psum_packed`` move several
    tensors of one dtype in one buffer. Over axes of one rank every
    collective is the identity: it returns its input, copies nothing and
    runs (or records) nothing, so a one-rank mesh computes the unsharded
    step on the same tensors."""

    def __init__(self, rules: ShardingRules):
        shape = rules.shape
        if "model" not in shape:
            raise ValueError(f"the model plane needs a 'model' mesh axis; the "
                             f"mesh is {shape}")
        self.rules = rules
        self.mesh = rules.mesh
        self.counting = isinstance(rules.mesh, CountingMesh)
        if not self.counting:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(rules.mesh, DeviceMesh):
                raise ValueError("a shape-only mesh runs no step; use a "
                                 "DeviceMesh or a CountingMesh")
        self.axes = {"dp": rules.data_axes(), "model": ("model",),
                     "all": rules.data_axes() + ("model",)}
        self.size = {k: _axis_size(shape, v) for k, v in self.axes.items()}
        self.rank = {k: axis_rank(rules.mesh, v)
                     for k, v in self.axes.items()}
        self.m = self.size["model"]
        self.k_dp = self.size["dp"]

    # -- layout --------------------------------------------------------------
    def spec(self, logical, dims) -> tuple:
        return self.rules.spec(logical, dims)

    def entry_size(self, entry) -> int:
        return _axis_size(self.rules.shape, entry)

    def entry_rank(self, entry) -> int:
        return 0 if entry is None else axis_rank(self.mesh, entry)

    def local_shape(self, logical, dims) -> tuple:
        """The shape of this rank's shard of a ``dims`` tensor whose
        dimensions carry ``logical``."""
        if isinstance(logical, str):
            return tuple(dims)
        return tuple(d // self.entry_size(e)
                     for d, e in zip(dims, self.spec(logical, dims)))

    def local_slice(self, x: torch.Tensor, logical) -> torch.Tensor:
        """This rank's shard of the whole tensor ``x`` (a view)."""
        if isinstance(logical, str):
            return x
        for d, e in enumerate(self.spec(logical, x.shape)):
            if e is not None:
                lo, hi = split_range(x.shape[d], self.entry_size(e),
                                     self.entry_rank(e))
                x = x.narrow(d, lo, hi - lo)
        return x

    def group(self, axis: str):
        return axis_group(self.mesh, self.axes[axis])

    # -- raw collectives (no autograd) -------------------------------------
    def _record(self, kind, axis, out):
        self.mesh.record(kind, self.axes[axis], out.numel() * out.element_size())

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0):
        """(.., n, ..) from each of the k ranks -> (.., k n, ..) along
        ``dim``, in rank order."""
        k = self.size[axis]
        if k == 1:
            return x
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((k * x.shape[0],) + tuple(x.shape[1:]))
        if self.counting:
            self._record("all-gather", axis, out)
        else:
            _gather_fn()(out, x, group=self.group(axis))
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int = 0):
        """Sums over the ranks, each keeping its part ``dim`` of the sum:
        (.., k n, ..) -> (.., n, ..)."""
        k = self.size[axis]
        if k == 1:
            return x
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // k,) + tuple(x.shape[1:]))
        if self.counting:
            self._record("reduce-scatter", axis, out)
        else:
            _scatter_fn()(out, x, group=self.group(axis))
        return out.movedim(0, dim).contiguous()

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum"):
        """The sum (or ``op="max"``) over the ranks, into a new tensor."""
        if self.size[axis] == 1:
            return x
        out = x.contiguous().clone()
        if self.counting:
            self._record("all-reduce", axis, out)
            return out
        dist = torch.distributed
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        dist.all_reduce(out, op=red, group=self.group(axis))
        return out

    def all_gather_uneven(self, x: torch.Tensor, axis: str, dim: int, n: int):
        """This rank's part ``split_range(n, k, rank)`` of a length-``n``
        dimension ``dim`` -> the whole of it on every rank: each part
        padded to the longest, one all-gather, the padding dropped."""
        k = self.size[axis]
        width = -(-n // k)
        lo, hi = split_range(n, k, self.rank[axis])
        if hi - lo < width:
            pad = list(x.shape)
            pad[dim] = width - (hi - lo)
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        full = self.all_gather(x, axis, dim)
        if width * k == n:
            return full
        keep = [i * width + j for i in range(k)
                for j in range(split_range(n, k, i)[1] - split_range(n, k, i)[0])]
        return full.index_select(dim, torch.as_tensor(keep, device=x.device))

    # -- autograd collectives ----------------------------------------------
    def gather(self, x, axis: str, dim: int):
        if self.size[axis] == 1:
            return x
        return _Gather.apply(x, self, axis, dim)

    def scatter(self, x, axis: str, dim: int):
        if self.size[axis] == 1:
            return x
        return _Scatter.apply(x, self, axis, dim)

    def psum(self, x, axis: str):
        if self.size[axis] == 1:
            return x
        return _Psum.apply(x, self, axis)

    def copy(self, x, axis: str):
        if self.size[axis] == 1:
            return x
        return _Copy.apply(x, self, axis)

    def split(self, x, axis: str, dim: int):
        """This rank's part ``split_range`` along ``dim`` of a tensor every
        rank holds whole and alike (a recurrent cell's output, computed
        whole on every rank): no collective forward; the backward
        all-gathers the parts' gradients, so every rank differentiates
        the whole cell alike."""
        if self.size[axis] == 1:
            return x
        return _Split.apply(x, self, axis, dim)

    def psum_packed(self, leaves, axis: str) -> list:
        """Each leaf summed over ``axis``, all in one all-reduce of one
        buffer (backward: the identity, as ``psum``'s)."""
        if not leaves or self.size[axis] == 1:
            return list(leaves)
        flat = self.psum(_flat_cat(leaves), axis)
        out, off = [], 0
        for x in leaves:
            out.append(flat[off:off + x.numel()].view(x.shape))
            off += x.numel()
        return out

    def replicate(self, x, axis: str, dim: int):
        """All-gather along ``dim`` for a tensor every rank then computes
        with whole and alike (the MoE router's weight, its input under
        ``act_seq_shard``): its gradient comes out whole and equal on every
        rank, so the backward keeps this rank's slice (no collective)."""
        if self.size[axis] == 1:
            return x
        return _Replicate.apply(x, self, axis, dim)

    def gather_counts(self, x):
        """An int tensor from every data rank, stacked in rank order on a
        new leading dimension (no autograd): the MoE's per-(group, expert)
        choice counts."""
        return self.all_gather(x[None], "dp", 0)

    def gather_packed(self, leaves, dims, axis: str) -> list:
        """Each leaf all-gathered along its ``dims`` entry over ``axis``, all
        in one all-gather of one buffer (backward: one reduce-scatter)."""
        if not leaves or self.size[axis] == 1:
            return list(leaves)
        return list(_GatherPacked.apply(self, axis, tuple(dims), *leaves))

    def copy_packed(self, leaves, axis: str) -> list:
        """The leaves unchanged; their gradients summed over ``axis`` in one
        all-reduce."""
        if not leaves or self.size[axis] == 1:
            return list(leaves)
        return list(_CopyPacked.apply(self, axis, *leaves))


def _flat_cat(ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plane, axis, dim):
        ctx.plane, ctx.axis, ctx.dim = plane, axis, dim
        return plane.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.plane.reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plane, axis, dim):
        ctx.plane, ctx.axis, ctx.dim = plane, axis, dim
        return plane.reduce_scatter(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.plane.all_gather(g, ctx.axis, ctx.dim), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plane, axis):
        return plane.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plane, axis, dim):
        ctx.part = dim, plane.rank[axis] * x.shape[dim], x.shape[dim]
        return plane.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        dim, lo, n = ctx.part
        return g.narrow(dim, lo, n).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plane, axis, dim):
        n = x.shape[dim]
        lo, hi = split_range(n, plane.size[axis], plane.rank[axis])
        ctx.plane, ctx.axis, ctx.dim, ctx.n = plane, axis, dim, n
        return x.narrow(dim, lo, hi - lo).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (ctx.plane.all_gather_uneven(g.contiguous(), ctx.axis,
                                            ctx.dim, ctx.n),
                None, None, None)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plane, axis):
        ctx.plane, ctx.axis = plane, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plane.all_reduce(g, ctx.axis), None, None


class _GatherPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plane, axis, dims, *leaves):
        k = plane.size[axis]
        # each leaf with its gathered dim first, flattened into one buffer
        moved = [x.movedim(d, 0) for x, d in zip(leaves, dims)]
        full = plane.all_gather(_flat_cat(moved), axis, 0).view(k, -1)
        outs, off = [], 0
        for x, d, mv in zip(leaves, dims, moved):
            n = x.numel()
            part = full[:, off:off + n].reshape((k,) + tuple(mv.shape))
            outs.append(part.reshape((k * mv.shape[0],) + tuple(mv.shape[1:]))
                        .movedim(0, d).contiguous())
            off += n
        ctx.plane, ctx.axis, ctx.dims = plane, axis, dims
        ctx.shapes = [tuple(x.shape) for x in leaves]
        ctx.like = leaves[0]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        k = ctx.plane.size[ctx.axis]
        cols = []
        for g, d, shape in zip(grads, ctx.dims, ctx.shapes):
            full = list(shape)
            full[d] *= k
            if g is None:
                g = ctx.like.new_zeros(full)
            g = g.movedim(d, 0)
            cols.append(g.reshape((k, -1)))
        buf = torch.cat(cols, dim=1).reshape(-1)
        local = ctx.plane.reduce_scatter(buf, ctx.axis, 0)
        out, off = [], 0
        for d, shape in zip(ctx.dims, ctx.shapes):
            n = math.prod(shape)
            moved = (shape[d],) + tuple(s for i, s in enumerate(shape)
                                        if i != d)
            out.append(local[off:off + n].reshape(moved).movedim(0, d)
                       .contiguous())
            off += n
        return (None, None, None, *out)


class _CopyPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plane, axis, *leaves):
        ctx.plane, ctx.axis = plane, axis
        ctx.shapes = [tuple(x.shape) for x in leaves]
        ctx.like = leaves[0]
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        grads = [ctx.like.new_zeros(s) if g is None else g
                 for g, s in zip(grads, ctx.shapes)]
        flat = ctx.plane.all_reduce(_flat_cat(grads), ctx.axis)
        out, off = [], 0
        for s in ctx.shapes:
            n = math.prod(s)
            out.append(flat[off:off + n].reshape(s))
            off += n
        return (None, None, *out)


# ---------------------------------------------------------------------------
# placement of whole trees
# ---------------------------------------------------------------------------

def _map_logical(fn, tree, logical):
    """``fn(leaf, logical)`` over the tensor leaves of ``tree``, whose
    logical tree has the same containers with a tuple of axis names (or
    ``SCALAR``) at each tensor leaf; non-tensor leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, logical)
    if isinstance(tree, dict):
        return {k: _map_logical(fn, tree[k], logical[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_logical(fn, t, lg)
                            for t, lg in zip(tree, logical)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_logical(fn, t, lg)
                          for t, lg in zip(tree, logical))
    return tree


def place_params(tree, logical, rules: Optional[ShardingRules]):
    """A whole tree (parameters, moments, a cache or a batch, as every rank
    holds it) -> this rank's shards, each where ``rules.spec(logical,
    shape)`` puts it. A shard smaller than its tensor is copied out, so
    the placed tree holds only this rank's part; a whole one is the same
    tensor. ``rules=None`` is the identity."""
    if rules is None:
        return tree
    plane = ModelPlane(rules)

    def one(x, lg):
        loc = plane.local_slice(x, lg)
        return loc if loc.shape == x.shape else loc.clone()
    return _map_logical(one, tree, logical)


def whole_params(tree, logical, shapes, rules: Optional[ShardingRules]):
    """The inverse of :func:`place_params`: each leaf whole on every rank
    (all-gathers along its sharded dimensions), ``shapes`` the whole tree
    (tensors, or anything with ``.shape``) that says which dimensions were
    sharded. For tests and host views; the gathers are plain collectives,
    not the model plane's counted ones."""
    if rules is None:
        return tree
    plane = ModelPlane(rules)

    def one(x, lg, full):
        if isinstance(lg, str):
            return x
        for d, e in enumerate(plane.spec(lg, tuple(full.shape))):
            if e is None:
                continue
            k = plane.entry_size(e)
            grp = axis_group(plane.mesh, e)
            xm = x.movedim(d, 0).contiguous()
            out = xm.new_empty((k * xm.shape[0],) + tuple(xm.shape[1:]))
            _gather_fn()(out, xm, group=grp)
            x = out.movedim(0, d)
        return x.contiguous()

    def walk(t, lg, full):
        if isinstance(t, torch.Tensor):
            return one(t, lg, full)
        if isinstance(t, dict):
            return {k: walk(t[k], lg[k], full[k]) for k in t}
        if isinstance(t, (list, tuple)):
            vals = [walk(a, b, c) for a, b, c in zip(t, lg, full)]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return t
    return walk(tree, logical, shapes)
