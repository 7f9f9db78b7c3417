"""Decoder backbone: the dense-attention, MoE, xLSTM, RG-LRU hybrid,
vision-stub and audio-codec families (mirrors
``repro.models.transformer``).

Layer stacking: layers are grouped into *units* of ``len(block_pattern)``
layers, and each unit's parameters are stacked along a leading n_units axis,
as in the JAX package; where it scans over units, the port loops over them
and indexes the stacked tensors. ``n_layers % period`` remainder layers are
applied unrolled.

Entry points:
  * forward_train(params, batch, cfg)          -> (loss, {"ce", "aux"})
  * forward_prefill(params, batch, cfg)        -> (last_logits, cache)
  * forward_decode(params, cache, batch, cfg)  -> (logits, cache)

``forward_train(..., remat=True)`` recomputes each unit's activations in
the backward pass (``torch.utils.checkpoint``, the counterpart of the
reference's ``jax.checkpoint`` of the unit body), so only one unit's
activations are live at a time.

Cache layout: {"pos": int, "scan": (per pattern position a block cache with
a leading n_units axis,), "tail": (per tail layer a block cache,)}. An
attention block's cache is {"k", "v"}: ring buffers of length
min(capacity, window). A recurrent block carries O(1) state: rglru {"h",
"conv"}, mlstm {"C", "n", "m", "conv"}, slstm {"c", "n", "m", "h"}, the
states in float32 and the conv histories in the activation dtype.
:func:`init_cache` allocates every buffer once; prefill writes the prompt's
K/V and final states into them, and each decode step updates them in place.
Under the model plane the cache also holds its capacity, "cap".

An MoE config's attention blocks take ``moe.moe_forward`` as their second
residual branch; each adds its router loss times ``cfg.router_aux_weight``
to ``aux``, which the blocks pass along and ``forward_train`` adds to the
loss (prefill and decode drop it, as the reference does).

The modality frontends are stubs, as in the JAX package. The vision stub
(``frontend="vision_stub"``) takes ``{"embeds": (B, S_img, frontend_dim),
"tokens": (B, S_txt)}``: a linear projector ``embed.proj`` maps the patch
embeddings into d_model ahead of the text tokens' embeddings, and M-RoPE
rotates by (B, S, 3) (t, h, w) positions (each stream at the token index
when the batch gives none; a decode step puts all three at its position).
The audio codec (``frontend="audio_codec"``) takes ``{"codes": (B, S,
nq)}``: ``embed.tok`` is (nq, V, D), the codebooks' embeddings are summed
in order in the activation dtype, and the head's nq * V columns reshape to
logits (B, S, nq, V), codebook-major.

The model plane (``rules=``, a :class:`~repro_torch.sharding.ShardingRules`
over a (data, model) or (pod, data, model) mesh) runs every family, the
frontends included, on each rank's shards, as ``rules.spec`` places the
parameters, the batch (B over the data axes,
replicated there when they do not divide it; above one data rank the
callers pass ``global_batch``, the whole rows, which tells the two apart)
and the cache:

  * FSDP: a unit's weights, stored split over the data axes along d_model,
    are all-gathered there before use, one packed buffer a unit (the
    embedding at the start, the final norm and head at the end);
  * attention: rank r of m computes query heads ``split_range(H, m, r)``;
    ``wq`` column-parallel, ``wo`` row-parallel and all-reduced over
    "model". When m does not divide the KV heads (whose columns are then
    stored in pieces that cut a head), ``wk``/``wv`` are all-gathered over
    "model" and every rank computes all KV heads, the ones its query heads
    read taken from them; the cache then lies over its sequence slots
    (KV_SEQ) where m divides them: prefill writes each rank's slots, decode
    writes at the slot's owner and combines the ranks' partial softmaxes
    (``attention.decode_attention_kv_seq``); where m does not, the cache
    lies whole on every rank, prefill writes every slot, and a decode step
    writes its slot and attends with the rank's own query heads, no
    collective;
  * the MLP: ``wi_gate``/``wi_up`` column-parallel, ``wo`` row-parallel and
    all-reduced;
  * the MoE (:meth:`_Plan.moe`): the router whole on every rank (gathered
    over "model" through ``replicate`` where stored split there), routing
    the whole rows alike on each; the routed experts split along E where
    the rules put EXPERTS on "model", else along their d_ff (stored split,
    or whole and cut); the shared experts column/row-parallel; the routed
    and shared partial outputs summed, then all-reduced once. A capacity
    group that spans data ranks ranks each rank's choices after the lower
    ranks' (their counts all-gathered), and the aux loss's sums go over
    the data axes;
  * the recurrent blocks on their D_FF channels (``rglru.rglru_block``,
    ``xlstm.mlstm_block``, ``xlstm.slstm_block`` take the plan): the RG-LRU
    whole on the rank's channels, its gates' partial products
    reduce-scattered to them (``channel_sums``); the mLSTM's ``w_up``
    all-gathered over "model" and cut to the rank's columns of x_i and of
    z (``_need`` gives several ranges of one dimension), rather than
    computed with the stored columns (at m = 2 rank 0 stores all of x_i)
    and the activations exchanged: the (d, 2 d_inner) weight moves fewer
    bytes than the (B, S, 2 d_inner) activations at any train or prefill
    shape, and it takes an all-gather the plane has; its partial q, k, v
    and gates summed in one all-reduce and the cell run whole on every
    rank; the sLSTM's ``W x`` all-gathered along its columns once a block
    and its loop over time run whole on every rank, no collective inside
    it. A recurrent block under ``act_seq_shard`` starts with ``enter``
    (the whole S) and needs no carry between ranks. Where m does not
    divide a block's channels (the RG-LRU's, the mLSTM's inner width, the
    sLSTM's 4 D columns of ``W x``), the block runs whole on every rank
    (``_Plan.whole``): its weights and state whole, no collective inside
    it, its input and output through ``replicate`` and ``split`` along S
    under ``act_seq_shard``;
  * the embedding (:meth:`_Plan.embed`): vocab-parallel, a masked local
    lookup then an all-reduce; the head: vocab-parallel logits
    (all-gathered where serving samples them), the loss
    ``common.cross_entropy``'s vocab-parallel form. The positions are the
    batch's when it has them, else built as ``embed_inputs`` builds them;
  * the frontends: the vision stub's projector is FSDP over the data axes
    and whole over "model", gathered with the embedding; its image rows,
    whole on every rank, go ahead of the vocab-parallel text rows after
    their sum (under ``act_seq_shard`` they enter the sum on model rank 0
    alone, and the projector's gradient is summed over "model"). The audio
    codec's table lies over "model" along V (dim 1): the codebooks'
    masked lookups are summed over "model" in one (nq, B, S, D) stack, then
    added in codebook order; its head's nq * V columns are gathered over
    "model" and cut to the rank's V columns of every codebook, so the
    logits are (B, S, nq, V_r) and the vocab-parallel loss and the serve
    gather run as for a token model;
  * ``act_seq_shard`` (train and prefill, when m > 1 divides S): between
    units the activations are (B, S/m, D) on each rank; the row-parallel
    products end in a reduce-scatter along S instead of an all-reduce and
    the column-parallel ones begin with an all-gather along S. With m = 1,
    or with no rules, it changes nothing, as the reference's constraint
    returns x outside a model axis.

The plane follows ``rules.spec``, which stores a dimension whole over
"model" where m does not divide it. A rank's share of a layer (query
heads, d_ff columns, vocab rows, an expert's d_ff) is then still its
``split_range``, uneven, and the weight is taken whole and cut (its
gradient summed over "model"); a part whose state or cache would have to
lie split (the KV_SEQ cache's slots, a recurrent block's channels) is
computed whole on every model rank, with no collective inside it, and its
weights' gradients come out whole on each rank. A collective over axes of
one rank is the identity, so on a one-rank mesh none runs and the results
are the unsharded ones bit for bit.
"""
from __future__ import annotations

import copy
import math
from typing import Any

import torch
# checkpoint() imports torch._dynamo on its first call, and that import
# leaves the frames then on the stack (a train step's, with its logits and
# gradients) in a reference cycle that only the cyclic collector frees;
# imported here, it runs before any training frame exists
import torch._dynamo  # noqa: F401
import torch.nn.functional as F
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as sh
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.rope import apply_mrope, apply_rope


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def mlp_specs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": cm.Spec((d, f), ("d_model", "d_ff")),
        "wi_up": cm.Spec((d, f), ("d_model", "d_ff")),
        "wo": cm.Spec((f, d), ("d_ff", "d_model"), "scaled"),
    }


def attn_specs(cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "ln1": cm.Spec((d,), ("d_model",), "zeros"),
        "wq": cm.Spec((d, h * hd), ("d_model", "heads")),
        "wk": cm.Spec((d, kv * hd), ("d_model", "kv_heads")),
        "wv": cm.Spec((d, kv * hd), ("d_model", "kv_heads")),
        "wo": cm.Spec((h * hd, d), ("heads", "d_model"), "scaled"),
        "ln2": cm.Spec((d,), ("d_model",), "zeros"),
    }
    if cfg.is_moe:
        p["moe"] = moe_lib.moe_specs(cfg)
    else:
        p["mlp"] = mlp_specs(cfg)
    return p


def block_specs(cfg, kind: str):
    if kind in ("attn", "local_attn"):
        return attn_specs(cfg)
    if kind == "mlstm":
        return xlstm_lib.mlstm_specs(cfg)
    if kind == "slstm":
        return xlstm_lib.slstm_specs(cfg)
    if kind == "rglru":
        p = rglru_lib.rglru_specs(cfg)
        p["ln2"] = cm.Spec((cfg.d_model,), ("d_model",), "zeros")
        p["mlp"] = mlp_specs(cfg)
        return p
    raise ValueError(kind)


def model_specs(cfg):
    """Full parameter Spec tree. Stacked units + unrolled tail."""
    period = len(cfg.block_pattern)
    n_units, n_tail = divmod(cfg.n_layers, period)
    emb: dict[str, Any] = {}
    if cfg.frontend == "audio_codec":
        emb["tok"] = cm.Spec((cfg.n_codebooks, cfg.vocab_size, cfg.d_model),
                             (None, "vocab", "d_model"))
    else:
        emb["tok"] = cm.Spec((cfg.vocab_size, cfg.d_model),
                             ("vocab", "d_model"))
    if cfg.frontend == "vision_stub":
        emb["proj"] = cm.Spec((cfg.frontend_dim, cfg.d_model),
                              (None, "d_model"))
    specs: dict[str, Any] = {"embed": emb}
    specs["scan"] = tuple(
        cm.stack_specs(block_specs(cfg, kind), n_units)
        for kind in cfg.block_pattern
    ) if n_units else ()
    specs["tail"] = tuple(
        block_specs(cfg, cfg.layer_kinds[n_units * period + i])
        for i in range(n_tail)
    )
    specs["final_norm"] = cm.Spec((cfg.d_model,), ("d_model",), "zeros")
    out_v = cfg.vocab_size * max(cfg.n_codebooks, 1)
    specs["head"] = cm.Spec((cfg.d_model, out_v), ("d_model", "vocab"))
    return specs


def scan_meta(cfg):
    period = len(cfg.block_pattern)
    n_units, n_tail = divmod(cfg.n_layers, period)
    tail_kinds = tuple(cfg.layer_kinds[n_units * period + i] for i in range(n_tail))
    return period, n_units, tail_kinds


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def attn_cache_len(cfg, kind: str, seq_len: int) -> int:
    if kind == "local_attn":
        return min(seq_len, cfg.local_window)
    if cfg.attention == "sliding":
        return min(seq_len, cfg.window)
    return seq_len


def init_block_cache(cfg, kind: str, batch: int, seq_len: int, dtype,
                     lead: tuple = (), device=None):
    """One block's empty cache, every leaf with the leading dims ``lead``:
    zero K/V ring buffers (B, W, Kv, hd) in ``dtype`` for attention; for a
    recurrent block its initial state in float32 (m at -1e9) and a zero conv
    history in ``dtype``."""
    d = cfg.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)
    if kind in ("attn", "local_attn"):
        shape = (batch, attn_cache_len(cfg, kind, seq_len), cfg.n_kv_heads,
                 cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}
    if kind == "rglru":
        dr = cfg.rglru_d_rnn
        return {"h": zeros(batch, dr, dt=torch.float32),
                "conv": zeros(batch, cfg.rglru_conv_width - 1, dr)}
    if kind == "mlstm":
        di = xlstm_lib._round64(cfg.xlstm_proj_factor * d)
        dh = di // cfg.n_heads
        st = xlstm_lib.mlstm_init_state(batch, cfg.n_heads, dh, dh,
                                        device=device, lead=lead)
        return {"C": st.C, "n": st.n, "m": st.m,
                "conv": zeros(batch, cfg.xlstm_conv_width - 1, di)}
    if kind == "slstm":
        st = xlstm_lib.slstm_init_state(batch, d, device=device, lead=lead)
        return st._asdict()
    raise ValueError(kind)


def cache_logical(cfg, seq_len: int, model_axis_size: int):
    """Logical-axis tree matching :func:`init_cache`: KV over heads when
    they divide the model axis, over the cache's sequence otherwise."""
    kv_ok = cfg.n_kv_heads % model_axis_size == 0

    def block_logical(kind):
        if kind in ("attn", "local_attn"):
            lg = (sh.BATCH, None, sh.KV_HEADS, None) if kv_ok else \
                (sh.BATCH, sh.KV_SEQ, None, None)
            return {"k": lg, "v": lg}
        if kind == "rglru":
            return {"h": (sh.BATCH, sh.D_FF),
                    "conv": (sh.BATCH, None, sh.D_FF)}
        if kind == "mlstm":
            return {"C": (sh.BATCH, None, None, None),
                    "n": (sh.BATCH, None, None), "m": (sh.BATCH, None),
                    "conv": (sh.BATCH, None, sh.D_FF)}
        if kind == "slstm":
            lg = (sh.BATCH, None)
            return {"c": lg, "n": lg, "m": lg, "h": lg}
        raise ValueError(kind)

    def add_stack(tree):
        return {k: (sh.STACK,) + v for k, v in tree.items()}

    period, n_units, tail_kinds = scan_meta(cfg)
    scan_lg = tuple(add_stack(block_logical(k)) for k in cfg.block_pattern) \
        if n_units else ()
    tail_lg = tuple(block_logical(k) for k in tail_kinds)
    return {"pos": sh.SCALAR, "scan": scan_lg, "tail": tail_lg}


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None, rules=None):
    """An empty cache of capacity ``seq_len``; prefill fills it. With
    ``rules``, this rank's shards of it, each leaf where ``rules.spec``
    puts it (``cache_logical`` for the mesh's model axis): the batch split
    over the data axes when ``batch`` divides them, a KV_SEQ cache over
    "model" along its slots where m divides them and whole on every rank
    where it does not. Such a cache also holds its capacity, ``"cap"``:
    its shards alone do not say which of the two layouts they are."""
    if rules is not None:
        plane = sh.ModelPlane(rules)
        # the whole cache's shapes, as meta tensors made outside any
        # dispatch mode: the dry run's counter would count them as the
        # step's memory (a prefill's whole-batch cache, every layer's)
        with _disable_current_modes():
            whole = init_cache(cfg, batch, seq_len, dtype, "meta")
        logical = cache_logical(cfg, seq_len, plane.m)
        local = sh._map_logical(
            lambda t, lg: torch.zeros(plane.local_shape(lg, t.shape),
                                      dtype=t.dtype, device=device),
            whole, logical)
        for block in local["scan"] + local["tail"]:
            if "m" in block:    # the xLSTM stabilisers start at -1e9
                block["m"].fill_(-1e9)
        return dict(local, cap=seq_len)
    period, n_units, tail_kinds = scan_meta(cfg)
    scan_caches = tuple(
        init_block_cache(cfg, kind, batch, seq_len, dtype, (n_units,), device)
        for kind in cfg.block_pattern
    ) if n_units else ()
    tail_caches = tuple(
        init_block_cache(cfg, kind, batch, seq_len, dtype, (), device)
        for kind in tail_kinds
    )
    return {"pos": 0, "scan": scan_caches, "tail": tail_caches}


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------

def _project_qkv(p, x, cfg):
    """q (B,S,H,hd), k and v (B,S,Kv,hd); under the model plane the heads
    this rank's weights hold."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = cm.dense(x, p["wq"].to(x.dtype)).reshape(b, s, -1, hd)
    k = cm.dense(x, p["wk"].to(x.dtype)).reshape(b, s, -1, hd)
    v = cm.dense(x, p["wv"].to(x.dtype)).reshape(b, s, -1, hd)
    return q, k, v


def _apply_rope(q, k, positions, cfg):
    if cfg.mrope_sections:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _mlp(p, x, plan=None):
    if plan is not None:
        x = plan.enter(x)
    h = F.silu(cm.dense(x, p["wi_gate"].to(x.dtype))) * \
        cm.dense(x, p["wi_up"].to(x.dtype))
    out = cm.dense(h, p["wo"].to(x.dtype))
    return out if plan is None else plan.exit(out)


def _ffn(p, x, cfg, aux, plan=None):
    """Second residual branch (MLP or MoE) of an attention block; returns
    (x, aux) with the MoE router loss, weighted, added to ``aux``."""
    xin = cm.rms_norm(x, p["ln2"])
    if "moe" in p:
        if plan is not None:
            y, loss = plan.moe(p["moe"], xin)
            return x + y, aux + loss * cfg.router_aux_weight
        out = moe_lib.moe_forward(p["moe"], xin, cfg)
        return x + out.y, aux + out.aux_loss * cfg.router_aux_weight
    return x + _mlp(p["mlp"], xin, plan), aux


def attn_block_seq(p, x, cfg, kind, positions, *, aux, cache=None,
                   use_flash=False, plan=None):
    """Train/prefill attention block; returns (x, aux). positions: (B,S),
    or (B,S,3) under M-RoPE.
    A prefill passes ``cache`` ({"k", "v"} ring buffers from
    :func:`init_cache`) and the block writes its K/V there."""
    window = None
    if kind == "local_attn":
        window = cfg.local_window
    elif cfg.attention == "sliding":
        window = cfg.window
    h = cm.rms_norm(x, p["ln1"])
    if plan is not None:
        h = plan.enter(h)
    q, k, v = _project_qkv(p, h, cfg)
    q, k = _apply_rope(q, k, positions, cfg)
    kq, vq = (k, v) if plan is None else (plan.kv_heads(k), plan.kv_heads(v))
    # a model rank of more ranks than query heads may hold none
    y = q if q.shape[2] == 0 else attn.attention(
        q, kq, vq, causal=True, window=window, use_flash=use_flash)
    b, s, _, _ = y.shape
    out = cm.dense(y.reshape(b, s, -1), p["wo"].to(x.dtype))
    x = x + (out if plan is None else plan.exit(out))
    x, aux = _ffn(p, x, cfg, aux, plan)
    if cache is not None and plan is not None and plan.kv_seq:
        plan.write_prefill(cache, kind, k, v, s)
    elif cache is not None:
        write_prompt(cache, k, v, s)
    return x, aux


def write_prompt(cache, k, v, s: int):
    """An ``s``-token prompt's K/V (B,S,Kv,hd) into the whole ring buffers
    of ``cache``: positions 0..s-1 at slots 0..s-1 when they fit, else the
    last W positions, position p at slot p % W."""
    w = cache["k"].shape[1]
    if w >= s:      # linear region: positions 0..s-1 land at slots 0..s-1
        cache["k"][:, :s] = k
        cache["v"][:, :s] = v
    else:           # ring: keep the last w positions at slot p % w
        cache["k"].copy_(torch.roll(k[:, -w:], s % w, dims=1))
        cache["v"].copy_(torch.roll(v[:, -w:], s % w, dims=1))


def attn_block_step(p, cache, x, cfg, pos: int, aux, plan=None,
                    kind: str = "attn"):
    """Single-token decode; returns (x, aux). x: (B,1,D); pos: absolute
    position (under M-RoPE every stream at ``pos``). Writes the token's K/V
    into ``cache`` (the ``kind`` block's) in place."""
    h = cm.rms_norm(x, p["ln1"])
    if plan is not None:
        h = plan.enter(h)
    q, k, v = _project_qkv(p, h, cfg)
    b = x.shape[0]
    posb = torch.full((b, 1, 3) if cfg.mrope_sections else (b, 1), pos,
                      dtype=torch.int64, device=x.device)
    q, k = _apply_rope(q, k, posb, cfg)
    if plan is not None and plan.kv_seq:
        y = plan.decode_kv_seq(q, k, v, cache, pos, kind)
    else:
        w = cache["k"].shape[1]
        kc, vc = attn.cache_write(cache["k"], cache["v"], k, v, pos, w)
        slot_pos = attn.cache_slot_positions(pos, w, x.device)
        y = attn.decode_attention(q, kc, vc, slot_pos, pos=pos)
    out = cm.dense(y.reshape(b, 1, -1), p["wo"].to(x.dtype))
    x = x + (out if plan is None else plan.exit(out))
    return _ffn(p, x, cfg, aux, plan)


def _store(cache, new: dict):
    """Writes a recurrent block's new state into its cache buffers."""
    for name, t in new.items():
        cache[name].copy_(t)


def apply_block(p, cache, x, cfg, kind, positions, *, mode, pos, aux,
                use_flash=False, plan=None):
    """Dispatch one block; returns (x, aux). A block given a cache
    (prefill, decode) reads its state there and writes the new one in
    place. Under the model plane (``plan``) ``p`` holds the weights as
    this rank computes with them (:meth:`_Plan.weights`)."""
    if kind in ("attn", "local_attn"):
        if mode == "decode":
            return attn_block_step(p, cache, x, cfg, pos, aux, plan, kind)
        return attn_block_seq(p, x, cfg, kind, positions, aux=aux,
                              cache=cache, use_flash=use_flash, plan=plan)
    if kind == "rglru":
        st = None if cache is None else rglru_lib.RGLRUState(cache["h"],
                                                             cache["conv"])
        x, st = rglru_lib.rglru_block(
            {k: v for k, v in p.items() if k not in ("ln2", "mlp")}, x, cfg,
            st, plan)
        x = x + _mlp(p["mlp"], cm.rms_norm(x, p["ln2"]), plan)
        if cache is not None:
            _store(cache, st._asdict())
        return x, aux
    if kind == "mlstm":
        st = conv = None
        if cache is not None:
            st = xlstm_lib.MLSTMState(cache["C"], cache["n"], cache["m"])
            conv = cache["conv"]
        x, (st, conv) = xlstm_lib.mlstm_block(p, x, cfg, st, conv, plan)
        if cache is not None:
            _store(cache, dict(st._asdict(), conv=conv))
        return x, aux
    if kind == "slstm":
        st = None if cache is None else xlstm_lib.SLSTMState(
            cache["c"], cache["n"], cache["m"], cache["h"])
        x, st = xlstm_lib.slstm_block(p, x, cfg, st, plan)
        if cache is not None:
            _store(cache, st._asdict())
        return x, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed_codes(codes, table, dtype):
    """The codebooks' embeddings of codes (..., nq), summed in codebook
    order in ``dtype`` from an exact first term, as the reference's Python
    ``sum`` adds them."""
    x = cm.embed_lookup(codes[..., 0], table[0], dtype)
    for qi in range(1, table.shape[0]):
        x = x + cm.embed_lookup(codes[..., qi], table[qi], dtype)
    return x


def embed_inputs(params, batch, cfg):
    """Returns (x: (B,S,D), positions, labels or None). The batch is
    {"tokens"}, {"embeds", "tokens"} (vision: the projected patches first)
    or {"codes"} (audio), each with optional "positions" and "labels"."""
    emb = params["embed"]
    dtype = cfg.act_dtype
    if cfg.frontend == "audio_codec":
        x = _embed_codes(batch["codes"], emb["tok"], dtype)   # codes (B,S,nq)
    elif cfg.frontend == "vision_stub":
        ximg = torch.matmul(batch["embeds"].to(dtype), emb["proj"].to(dtype))
        xtxt = cm.embed_lookup(batch["tokens"], emb["tok"], dtype)
        x = torch.cat([ximg, xtxt], dim=1)
    else:
        x = cm.embed_lookup(batch["tokens"], emb["tok"], dtype)
    return x, batch_positions(batch, cfg, x.device), batch.get("labels")


def batch_rows_len(batch) -> tuple:
    """(rows, S) of a step's batch: S the positions the step embeds (a
    vision batch's patches and text tokens together)."""
    if "embeds" in batch:
        return (batch["embeds"].shape[0],
                batch["embeds"].shape[1] + batch["tokens"].shape[1])
    for key in ("codes", "tokens", "token"):
        if key in batch:
            return tuple(batch[key].shape[:2])
    raise KeyError(f"a batch of {sorted(batch)} holds no input")


def batch_positions(batch, cfg, device):
    """The batch's "positions", or the token indices (B, S), each of
    M-RoPE's three streams at the index (B, S, 3)."""
    positions = batch.get("positions")
    if positions is None:
        b, s = batch_rows_len(batch)
        positions = torch.arange(s, device=device)[None].expand(b, s)
        if cfg.mrope_sections:
            positions = positions[..., None].expand(b, s, 3)
    return positions


def logits_from_hidden(params, x, cfg):
    """Final norm and LM head: x's dtype operands, ``cfg.logits_dtype``
    products and sums (float32 by default, so bf16 logits are not rounded
    to bf16). An audio config's logits are (B, S, nq, V)."""
    x = cm.rms_norm(x, params["final_norm"])
    logits = cm.dense(x, params["head"].to(x.dtype),
                      getattr(torch, cfg.logits_dtype))
    if cfg.n_codebooks:
        logits = logits.reshape(*logits.shape[:2], cfg.n_codebooks,
                                cfg.vocab_size)
    return logits


# ---------------------------------------------------------------------------
# full forwards
# ---------------------------------------------------------------------------

def _unit_views(tree, n_units: int) -> list:
    """One tree per unit of views into the stacked leaves (``unbind``: the
    units' gradients reach each stacked leaf through one stack)."""
    leaves = [a.unbind(0) for a in cm.tree_leaves(tree)]
    return [cm.tree_unflatten(tree, [a[u] for a in leaves])
            for u in range(n_units)]


def _run_stack(params, cache, x, cfg, positions, *, mode, pos=0,
               use_flash=False, remat=False, plan=None):
    """Every layer in order; returns (x, aux), aux the MoE layers' weighted
    router losses summed (a float32 zero for the other families). mode:
    "train" (no cache), "prefill" (fills ``cache``) or "decode" (reads and
    updates ``cache`` in place). ``remat`` checkpoints each unit: its
    parameter views, x and aux go in, only x and aux are kept. Under the
    model plane each unit gathers its weights first (inside the checkpoint,
    so the backward gathers them again)."""
    period, n_units, tail_kinds = scan_meta(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    def unit_body(x, aux, p_unit, c_unit):
        for i, kind in enumerate(cfg.block_pattern):
            p_i = p_unit[i] if plan is None else plan.weights(
                kind, lambda kind=kind: block_specs(cfg, kind), p_unit[i])
            x, aux = apply_block(p_i, None if c_unit is None else c_unit[i],
                                 x, cfg, kind, positions, mode=mode, pos=pos,
                                 aux=aux, use_flash=use_flash, plan=plan)
        return x, aux

    units = list(zip(*(_unit_views(params["scan"][i], n_units)
                       for i in range(period)))) if n_units else []
    for u, p_unit in enumerate(units):
        c_unit = None if cache is None else tuple(
            cm.tree_map(lambda a: a[u], cache["scan"][i])
            for i in range(period))
        if remat:
            x, aux = checkpoint(unit_body, x, aux, p_unit, c_unit,
                                use_reentrant=False)
        else:
            x, aux = unit_body(x, aux, p_unit, c_unit)
    for i, kind in enumerate(tail_kinds):
        c_i = None if cache is None else cache["tail"][i]
        p_i = params["tail"][i] if plan is None else plan.weights(
            kind, lambda kind=kind: block_specs(cfg, kind), params["tail"][i])
        x, aux = apply_block(p_i, c_i, x, cfg, kind, positions, mode=mode,
                             pos=pos, aux=aux, use_flash=use_flash, plan=plan)
    return x, aux


def forward_train(params, batch, cfg, *, remat=False, use_flash=False,
                  rules=None, global_batch=None):
    """Returns (loss, {"ce", "aux"}): loss = ce + aux, ce the mean CE of
    the logits at positions 0..S-2 against ``batch["labels"]`` at 1..S-1,
    aux the MoE layers' router losses times ``cfg.router_aux_weight`` (0
    for the other families). Under ``rules`` the batch is this rank's rows
    and ce the mean over the whole batch's tokens; ``global_batch``, the
    whole batch's rows, says whether they are split over the data axes or
    replicated there (``launch.specs.place_batch``); it is required above
    one data rank."""
    plan = _plan(cfg, rules, "train", batch, global_batch)
    if plan is not None:
        x, positions = plan.embed(params, batch)
        x, aux = _run_stack(params, None, x, cfg, positions, mode="train",
                            use_flash=use_flash, remat=remat, plan=plan)
        logits = plan.logits(params, x)
        ce = cm.cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                              plane=plan.plane, vocab_start=plan.vocab[0])
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux}
    x, positions, labels = embed_inputs(params, batch, cfg)
    x, aux = _run_stack(params, None, x, cfg, positions, mode="train",
                        use_flash=use_flash, remat=remat)
    logits = logits_from_hidden(params, x, cfg)
    ce = cm.cross_entropy(logits[:, :-1], labels[:, 1:])
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


def forward_prefill(params, batch, cfg, *, max_len=None, use_flash=False,
                    rules=None, global_batch=None):
    """Returns (last_token_logits, cache).

    ``max_len``: cache capacity (prompt + expected decode steps). Defaults
    to the prompt length; serving callers pass prompt_len + generation
    budget. Under ``rules`` the batch and the returned cache are this
    rank's shards and the logits this rank's rows over the whole vocab
    (``global_batch`` as in :func:`forward_train`)."""
    plan = _plan(cfg, rules, "prefill", batch, global_batch)
    if plan is not None:
        x, positions = plan.embed(params, batch)
        b, s = positions.shape[:2]
        cap = max(max_len or s, s)
        plan = plan.for_cache(cap)
        cache = plan.init_cache(b, cap, x.device)
        x, _ = _run_stack(params, cache, x, cfg, positions, mode="prefill",
                          use_flash=use_flash, plan=plan)
        return plan.serve_logits(params, x, last=True), dict(cache, pos=s)
    x, positions, _ = embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    cap = max(max_len or s, s)
    cache = init_cache(cfg, b, cap, cfg.act_dtype, x.device)
    x, _ = _run_stack(params, cache, x, cfg, positions, mode="prefill",
                      use_flash=use_flash)
    return logits_from_hidden(params, x[:, -1:], cfg), dict(cache, pos=s)


def forward_decode(params, cache, batch, cfg, *, rules=None,
                   global_batch=None):
    """One new token. batch: {"token": (B,1)} or, audio, {"codes": (B,1,nq)}.
    Returns (logits, cache): the cache's buffers are updated in place and
    its position advanced (``rules``, ``global_batch`` as in
    :func:`forward_train`)."""
    pos = cache["pos"]
    plan = _plan(cfg, rules, "decode", batch, global_batch)
    if plan is not None:
        plan = plan.for_cache(cache.get("cap"))
        x, _ = plan.embed(params, batch)
        x, _ = _run_stack(params, cache, x, cfg, None, mode="decode",
                          pos=pos, plan=plan)
        return plan.serve_logits(params, x), dict(cache, pos=pos + 1)
    if cfg.frontend == "audio_codec":
        x = _embed_codes(batch["codes"], params["embed"]["tok"], cfg.act_dtype)
    else:
        x = cm.embed_lookup(batch["token"], params["embed"]["tok"],
                            cfg.act_dtype)
    x, _ = _run_stack(params, cache, x, cfg, None, mode="decode", pos=pos)
    return logits_from_hidden(params, x, cfg), dict(cache, pos=pos + 1)


# ---------------------------------------------------------------------------
# the model plane
# ---------------------------------------------------------------------------

def plane_supported(cfg) -> bool:
    """Whether the model plane runs ``cfg``: every block kind of it is one
    the plane has (every config of the package: the dense, MoE, xLSTM,
    RG-LRU hybrid, vision-stub and audio-codec families)."""
    return set(cfg.layer_kinds) <= {"attn", "local_attn", "rglru", "mlstm",
                                    "slstm"}


def _plan(cfg, rules, mode, batch, global_batch=None):
    """The step's :class:`_Plan`, or None without rules. A plan is made
    once per (config, step kind, sequence length, batch layout) and kept on
    ``rules``, so a step repeats none of its layout work; the sequence
    length is the positions the step embeds (``batch_rows_len``).
    ``global_batch`` (the whole batch's rows; above one data rank the
    caller must pass it) says whether the batch is replicated over the
    data axes, as ``rules.spec`` places a BATCH the axes do not divide
    (``launch.specs.place_batch``)."""
    if rules is None:
        return None
    rows, seq = batch_rows_len(batch)
    plans = rules.__dict__.setdefault("_plans", {})
    plane = sh.ModelPlane(rules)
    if global_batch is None:
        if plane.k_dp > 1:
            raise ValueError(
                f"a batch over {plane.k_dp} data ranks needs global_batch=, "
                "its whole rows: split or replicated there is rules.spec's "
                "placement of them (launch.specs.place_batch)")
        global_batch = rows
    replicated = plane.spec((sh.BATCH,), (global_batch,))[0] is None
    if global_batch != rows * (1 if replicated else plane.k_dp):
        raise ValueError(f"{rows} rows a rank do not make a batch of "
                         f"{global_batch} over {plane.k_dp} data ranks")
    key = (cfg, mode, seq, replicated)
    if key not in plans:
        plans[key] = _Plan(cfg, plane, mode, seq, replicated)
    return plans[key]


# a recurrent block's leaf whose length is its channels (D_FF)
_CHANNELS = {"rglru": "lam", "mlstm": "conv_b", "slstm": "b_gates"}


class _Plan:
    """How one rank computes a step under the model plane: its query heads,
    KV heads, d_ff columns, experts (or expert d_ff columns), recurrent
    channels and vocab rows on "model", whether the KV heads lie whole on
    every rank (``kv_seq``: m does not divide them; the cache then lies
    over its slots where m divides those, else whole), which recurrent
    blocks run whole on every model rank (``whole``: m does not divide
    their channels), whether the activations between units are split along
    S (``seq_shard``) and whether the batch is replicated over the data
    axes (``replicated``). A serving step binds the capacity of its cache
    (``for_cache``)."""

    def __init__(self, cfg, plane: sh.ModelPlane, mode: str, seq_len: int,
                 replicated: bool = False):
        self.cfg, self.plane, self.mode = cfg, plane, mode
        self.replicated = replicated
        m, r = plane.m, plane.rank["model"]
        heads, kv = cfg.n_heads, cfg.n_kv_heads
        self.heads = sh.split_range(heads, m, r)
        self.kv_seq = kv % m != 0
        g = heads // kv
        kv_of = [h // g for h in range(*self.heads)]
        # a rank of more model ranks than query heads may hold none
        self.kv_range = (kv_of[0], kv_of[-1] + 1) if kv_of else (0, 0)
        n = self.kv_range[1] - self.kv_range[0]
        # the query heads' KV heads as a slice when each is read by an equal
        # run of them (a uniform GQA group); else one KV head per query head
        even = not kv_of or len(kv_of) % n == 0 and kv_of == [
            k for k in range(*self.kv_range) for _ in range(len(kv_of) // n)]
        self.kv_index = None if even else torch.as_tensor(kv_of)
        self.ff = sh.split_range(cfg.d_ff, m, r)
        self.vocab = sh.split_range(cfg.vocab_size, m, r)
        if cfg.is_moe:
            # experts split along E where the rules put EXPERTS on
            # "model", else along their d_ff (stored split or whole)
            e, f = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
            self.moe_ep = plane.spec(("experts", "d_model", "d_ff"),
                                     (e, cfg.d_model, f))[0] == "model"
            self.experts = sh.split_range(e, m, r) if self.moe_ep else (0, e)
            self.moe_ff = sh.split_range(f, m, r)
            self.shared_ff = sh.split_range(cfg.n_shared_experts * f, m, r)
        self.whole = {kind for kind, leaf in _CHANNELS.items()
                      if kind in cfg.layer_kinds and plane.spec(
                          (sh.D_FF,), block_specs(cfg, kind)[leaf].shape)[0]
                      is None}
        self.seq_shard = (cfg.act_seq_shard and mode != "decode" and m > 1
                          and seq_len % m == 0)
        self.cap = None
        self._layouts = {}

    def for_cache(self, cap):
        """This plan for a step on a cache of capacity ``cap`` (None: not
        known), which fixes its KV_SEQ slots' layout (``_slots``); the
        layouts of the weights are shared."""
        bound = copy.copy(self)
        bound.cap = cap
        return bound

    # -- weights -----------------------------------------------------------
    def _need(self, kind, path, spec):
        """(dim, ((lo, hi), ...)): the part of a weight of a ``kind`` block
        (None for the outer weights) along "model" that this rank computes
        with, one or more ranges of one dimension concatenated in order;
        None for a weight every rank uses whole as stored (split over
        "model" nowhere), "whole" for one every rank computes with whole
        whatever its storage (the MoE router; the sLSTM's recurrence and
        bias, and the mLSTM's group norm, whose cells run whole; every
        channel weight of a recurrent block in ``whole``)."""
        if kind in ("rglru", "mlstm", "slstm") and path[0] != "mlp":
            return self._need_recurrent(kind, path, spec)
        hd = self.cfg.head_dim
        h0, h1 = self.heads
        if path == ("wq",):
            return 1, ((h0 * hd, h1 * hd),)
        if path == ("wo",):
            return 0, ((h0 * hd, h1 * hd),)
        if path in (("wk",), ("wv",)):
            if self.kv_seq:
                return 1, ((0, spec.shape[1]),)
            return 1, ((self.kv_range[0] * hd, self.kv_range[1] * hd),)
        if path[0] == "mlp":
            return (0 if path[1] == "wo" else 1), (self.ff,)
        if path[0] == "moe":
            if path[1] == "router":
                return "whole"
            if path[1] == "shared":
                return (0 if path[2] == "wo" else 1), (self.shared_ff,)
            if self.moe_ep:
                return 0, (self.experts,)
            return (1 if path[1] == "wo" else 2), (self.moe_ff,)
        nq, v = self.cfg.n_codebooks, self.cfg.vocab_size
        if path == ("embed", "tok"):    # an audio table (nq, V, D): V on dim 1
            return (1 if nq else 0), (self.vocab,)
        if path == ("head",):
            # an audio head's nq * V columns: the rank's rows of every
            # codebook (stored in contiguous parts of all nq * V, so
            # gathered over "model" and cut; on one rank the stored whole)
            v0, v1 = self.vocab
            if not nq:
                return 1, ((v0, v1),)
            if v1 - v0 < v:
                return 1, tuple((q * v + v0, q * v + v1) for q in range(nq))
            return 1, ((0, nq * v),)
        if path == ("embed", "proj") and self.seq_shard:
            # the image rows enter on model rank 0 alone (``embed``): the
            # projector's gradient is summed over "model" (``copy``)
            return 0, ((0, spec.shape[0]),)
        return None

    def _need_recurrent(self, kind, path, spec):
        """``_need`` of a recurrent block's own weights: the rank's
        ``split_range`` of the rows or columns that carry D_FF (the
        RG-LRU's and the sLSTM's even: their gate sums and W x meet in
        equal parts); the mLSTM's ``w_up`` its part of each half, x_i and
        z (stored in contiguous parts of the concatenated columns: at m = 2
        rank 0 stores all of x_i, so the rank's columns are gathered over
        "model" and cut, not used as stored). A block in ``whole`` takes
        its channel weights whole (the sLSTM's FFN stays a column/row
        pair)."""
        name = path[0]
        if name in ("ln", "ln2", "b_if"):
            return None
        if kind == "slstm":
            if name in ("r_gates", "b_gates") or \
                    name == "w_gates" and kind in self.whole:
                return "whole"
            if name not in ("w_gates", "ffn_up", "ffn_down"):
                return None
        elif name == "gn" or kind in self.whole:
            return "whole"
        d = 1 if name in ("w_x", "w_gate", "conv_w", "w_up", "w_gates",
                          "ffn_up") else 0
        m, r = self.plane.m, self.plane.rank["model"]
        width = spec.shape[d]
        if name != "w_up":
            return d, (sh.split_range(width, m, r),)
        di = width // 2
        lo, hi = sh.split_range(di, m, r)
        # on one model rank the two halves are the stored whole
        return d, ((lo, hi), (di + lo, di + hi)) if hi - lo < di else \
            ((0, 2 * di),)

    def weights(self, key, specs, p_loc):
        """``p_loc`` (this rank's stored shards of the weights that the spec
        tree ``specs()`` describes, whole-tree paths) as the rank computes
        with them: each leaf stored split over the data axes all-gathered
        there (FSDP, one buffer), then cut to the rank's part along
        "model"; a leaf whose stored part is not that part is all-gathered
        over "model" (one buffer) or, stored whole, passed through ``copy``
        (its gradient is then summed over "model"); a leaf every rank
        computes with whole and alike (``_need`` "whole") and stored split
        over "model" is gathered through ``replicate`` (its gradient is
        whole: the backward keeps this rank's slice). The layout is worked
        out once per ``key`` (a block kind, or the outer weights' names)."""
        if key not in self._layouts:
            self._layouts[key] = self._layout(
                specs(), key if isinstance(key, str) else None)
        dp_idx, dp_dims, gather, copy, needs, whole = self._layouts[key]
        plane = self.plane
        out = list(cm.tree_leaves(p_loc))
        for i, t in zip(dp_idx, plane.gather_packed(
                [out[i] for i in dp_idx], dp_dims, "dp")):
            out[i] = t
        for i, t in zip(gather, plane.gather_packed(
                [out[i] for i in gather], [needs[i][0] for i in gather],
                "model")):
            out[i] = t
        for i, t in zip(copy, plane.copy_packed([out[i] for i in copy],
                                                "model")):
            out[i] = t
        for i in gather + copy:
            d, ranges = needs[i]
            parts = [out[i].narrow(d, lo, hi - lo) for lo, hi in ranges]
            out[i] = parts[0] if len(parts) == 1 else torch.cat(parts, d)
        for i, d in whole:
            out[i] = plane.replicate(out[i], "model", d)
        return cm.tree_unflatten(p_loc, out)

    def _layout(self, specs, kind):
        """For the leaves of ``specs`` (``tree_leaves`` order) of a ``kind``
        block: those stored split over the data axes and the dimension of
        each, those to all-gather over "model", those to ``copy``, each
        one's part along "model" (``_need``), and (index, dim) of those to
        ``replicate``."""
        plane = self.plane
        paths = list(cm.spec_paths(specs))
        specs_ = [plane.spec(sp.logical, sp.shape) for _, sp in paths]
        dp = plane.axes["dp"]

        def dp_dim(entries):
            for d, e in enumerate(entries):
                if e is not None and sh._axes(e) == dp:
                    return d
            return None
        dp_idx = [i for i, e in enumerate(specs_) if dp_dim(e) is not None]
        needs, gather, copy, whole = {}, [], [], []
        for i, (path, sp) in enumerate(paths):
            need = self._need(kind, path, sp)
            if need == "whole":
                whole += [(i, d) for d, e in enumerate(specs_[i])
                          if e == "model"]
                continue
            if need is None:
                continue
            d, ranges = needs[i] = need
            if specs_[i][d] is None:
                copy.append(i)
            elif ranges != (sh.split_range(sp.shape[d], plane.m,
                                           plane.rank["model"]),):
                gather.append(i)
        return (dp_idx, [dp_dim(specs_[i]) for i in dp_idx], gather, copy,
                needs, whole)

    def _outer(self, params, names):
        def specs():
            full = model_specs(self.cfg)
            return {k: full[k] for k in names}
        return self.weights(names, specs, {k: params[k] for k in names})

    # -- activations ---------------------------------------------------------
    def enter(self, h, kind=None):
        """Before a column-parallel product: the whole sequence (an
        all-gather along S) or, unsplit, ``copy`` (its gradient summed).
        Before a ``kind`` block in ``whole``, which every rank computes
        whole and alike: the whole sequence through ``replicate`` (the
        backward keeps this rank's part of the whole gradient), or h
        itself."""
        if kind in self.whole:
            return self.plane.replicate(h, "model", 1) if self.seq_shard \
                else h
        if self.seq_shard:
            return self.plane.gather(h, "model", 1)
        return self.plane.copy(h, "model")

    def exit(self, out, kind=None):
        """After a row-parallel product: the sum over "model", split along S
        (a reduce-scatter) or whole (an all-reduce). After a ``kind`` block
        in ``whole`` (its output whole and alike on every rank): this
        rank's part of S (``split``), or out itself."""
        if kind in self.whole:
            return self.plane.split(out, "model", 1) if self.seq_shard \
                else out
        if self.seq_shard:
            return self.plane.scatter(out, "model", 1)
        return self.plane.psum(out, "model")

    def channel_sums(self):
        """The RG-LRU gates' sums: (2, ..., Dr) partial products of this
        rank's channels by its rows of w_a and w_i -> their sums over
        "model", this rank's channels of each (one reduce-scatter along
        the last dim); None on one model rank or for a block in ``whole``
        (nothing to sum)."""
        if self.plane.m == 1 or "rglru" in self.whole:
            return None
        return lambda t: self.plane.scatter(t, "model", t.dim() - 1).unbind(0)

    def moe(self, p, xin):
        """The MoE branch of (B, S, D) normed activations (this rank's part
        of S under ``seq_shard``); returns (y, aux loss). Every rank of
        "model" routes the whole rows alike: the router reads them
        replicated (an all-gather along S under ``seq_shard``, whose
        backward keeps this rank's slice: the router's gradient is whole
        on every rank). The expert branch reads them and the gates through
        ``copy`` (each rank's experts give them a partial gradient); the
        routed and shared outputs, each this rank's partial sum, are
        summed, then summed over "model" once (in float32 for the gather
        dispatch above one rank). The aux loss's sums go over the data
        ranks in a train step (serving drops the loss). A batch replicated
        over the data axes is the whole batch on every data rank: its
        groups are the whole batch's, and no rank ranks its choices after
        another's (each holds every token)."""
        cfg, plane = self.cfg, self.plane
        xw = plane.replicate(xin, "model", 1) if self.seq_shard else xin
        b, s, _ = xw.shape
        n = b * s
        rows = b if self.replicated else b * plane.k_dp
        t = moe_lib.group_size(cfg, rows, s)
        if (rows * s) % t:
            raise ValueError(
                f"MoE groups of {t} tokens do not tile the batch's "
                f"{rows * s} tokens (the unsharded layer reshapes to them)")
        h = plane.copy(xw, "model")
        # the rank's tokens in segments of gcd(t, n): each inside one group
        # and one rank (``moe_lib.Part``), ranked after the group's earlier
        # segments when a group is not inside the rank (never for a batch
        # replicated over the data axes: its n tokens are the batch's)
        u = math.gcd(t, n)
        part = moe_lib.Part(
            self.experts, t, h, lambda gates: plane.copy(gates, "model"),
            self._offsets(t // u) if u < t else None,
            (lambda v: plane.psum(v, "dp")) if self.mode == "train" else None)
        out = moe_lib.moe_forward(p, xw, cfg, part)
        y = out.y if plane.m > 1 else out.y.to(xin.dtype)
        if "shared" in p:
            y = y + moe_lib.shared_branch(p, h)
        return self.exit(y).to(xin.dtype), out.aux_loss

    def _offsets(self, q: int):
        """For groups of ``q`` segments, over data ranks that each hold G
        consecutive segments of the token stream: this rank's (G, E) choice
        counts -> for each of its segments the counts of the earlier
        segments of its group (one all-gather over the data axes): for a
        group of q ranks' tokens (G = 1) the lower ranks' of its group."""
        r = self.plane.rank["dp"]

        def offsets(counts):
            g = counts.shape[0]
            every = self.plane.gather_counts(counts).flatten(0, 1)
            before = torch.cumsum(every, 0) - every         # (k_dp G, E)
            seg = torch.arange(r * g, (r + 1) * g, device=counts.device)
            return before[seg] - before[seg - seg % q]
        return offsets

    def kv_heads(self, k):
        """The KV heads this rank's query heads read, of k (B,S,Kv,hd)."""
        if not self.kv_seq:
            return k
        if self.kv_index is None:
            return k[:, :, self.kv_range[0]:self.kv_range[1]]
        return k.index_select(2, self.kv_index.to(k.device))

    def _lookup(self, tokens, table):
        """This rank's vocab rows' part of the embedding of ``tokens`` in
        the activation dtype: the rows it holds, zero elsewhere."""
        v0, v1 = self.vocab
        if (v0, v1) == (0, self.cfg.vocab_size):
            e = table[tokens]
        else:
            inside = (tokens >= v0) & (tokens < v1)
            e = table[torch.where(inside, tokens - v0, 0)] * \
                inside[..., None].to(table.dtype)
        return e.to(self.cfg.act_dtype)

    def _rows_sum(self, e, dim: int):
        """The ranks' parts summed over "model", split along S (``dim``)
        under ``seq_shard``. One rank's term of each entry is nonzero, so
        the sum is exact in any dtype."""
        if self.seq_shard:
            return self.plane.scatter(e, "model", dim)
        return self.plane.psum(e, "model")

    def embed(self, params, batch):
        """The step's input embedding, vocab-parallel, and its positions
        (None in decode): each rank looks up the tokens in its rows (zero
        elsewhere) and the ranks' parts are summed over "model" (split
        along S under ``seq_shard``). An audio batch's codebooks are
        looked up so, stacked (nq, B, S, D) into one sum, then added in
        codebook order as ``embed_inputs`` adds them. A vision batch's
        image rows (``embeds @ proj`` in the activation dtype, whole on
        every rank) go ahead of the summed text rows; under ``seq_shard``
        they enter the sum on model rank 0 alone. The positions are the
        batch's, whole along S (attention reads them after ``enter``), or
        ``batch_positions``'."""
        cfg = self.cfg
        # a decode step embeds tokens alone: the projector is not gathered
        keys = ("tok",) if self.mode == "decode" else tuple(params["embed"])

        def specs():
            emb = model_specs(cfg)["embed"]
            return {"embed": {k: emb[k] for k in keys}}
        emb = self.weights(("embed",) + keys, specs, {"embed": {
            k: params["embed"][k] for k in keys}})["embed"]
        if cfg.frontend == "audio_codec":
            codes = batch["codes"]
            e = self._rows_sum(torch.stack([
                self._lookup(codes[..., q], emb["tok"][q])
                for q in range(cfg.n_codebooks)]), 2)
            x = e[0]
            for q in range(1, cfg.n_codebooks):
                x = x + e[q]
        elif cfg.frontend == "vision_stub" and self.mode != "decode":
            dt = cfg.act_dtype
            ximg = torch.matmul(batch["embeds"].to(dt), emb["proj"].to(dt))
            e = self._lookup(batch["tokens"], emb["tok"])
            if self.seq_shard:
                keep = float(self.plane.rank["model"] == 0)
                x = self._rows_sum(torch.cat([ximg * keep, e], 1), 1)
            else:
                x = torch.cat([ximg, self._rows_sum(e, 1)], 1)
        else:
            x = self._rows_sum(self._lookup(
                batch["token" if self.mode == "decode" else "tokens"],
                emb["tok"]), 1)
        if self.mode == "decode":
            return x, None
        return x, batch_positions(batch, cfg, x.device)

    def logits(self, params, x, last: bool = False):
        """This rank's vocab columns of the logits (B,S,V_r), or of the
        last position's (``last``); an audio config's (B,S,nq,V_r), the
        rank's columns of each codebook. The head is column-parallel: its
        input enters as the blocks' products do (under ``seq_shard`` the
        final norm runs on each rank's part of S, then one all-gather)."""
        w = self._outer(params, ("final_norm", "head"))
        if last and not self.seq_shard:
            x = x[:, -1:]
        h = self.enter(cm.rms_norm(x, w["final_norm"]))
        if last and self.seq_shard:
            h = h[:, -1:]
        out = cm.dense(h, w["head"].to(h.dtype),
                       getattr(torch, self.cfg.logits_dtype))
        if self.cfg.n_codebooks:
            out = out.reshape(*out.shape[:2], self.cfg.n_codebooks, -1)
        return out

    def serve_logits(self, params, x, last: bool = False):
        """The logits over the whole vocab, all-gathered over "model"."""
        out = self.logits(params, x, last)
        return self.plane.all_gather_uneven(out, "model", out.dim() - 1,
                                            self.cfg.vocab_size)

    # -- the cache -----------------------------------------------------------
    def init_cache(self, b: int, cap: int, device):
        """This rank's empty cache shards for its ``b`` rows."""
        return init_cache(self.cfg, b * self.plane.k_dp, cap,
                          self.cfg.act_dtype, device, rules=self.plane.rules)

    def _slots(self, kind: str, cache):
        """(W, lo, hi): the W slots of the ``kind`` blocks' KV_SEQ cache of
        the bound capacity and this rank's [lo, hi) of them, as
        ``rules.spec`` lays them: over "model" where m divides W, else
        whole on every rank (lo, hi = 0, W)."""
        if self.cap is None:
            raise ValueError(
                "a cache that lies over its slots needs its capacity, "
                "'cap', which init_cache(rules=) and prefill give it")
        w = attn_cache_len(self.cfg, kind, self.cap)
        lo, hi = 0, w
        if self.plane.spec((sh.KV_SEQ,), (w,))[0] is not None:
            lo, hi = sh.split_range(w, self.plane.m, self.plane.rank["model"])
        if cache["k"].shape[1] != hi - lo:
            raise ValueError(
                f"a {kind} cache of capacity {self.cap} holds {hi - lo} of "
                f"its {w} slots on this rank, not {cache['k'].shape[1]}")
        return w, lo, hi

    def write_prefill(self, cache, kind: str, k, v, s: int):
        """This rank's slots of the cache after an ``s``-token prompt: slot
        j holds the latest position p < s with p % W == j (positions 0..s-1
        at slots 0..s-1 when the prompt fits). The slot map is computed on
        the host from the static sizes. A cache whole on every rank takes
        the prompt as without the plane (every rank computes every KV
        head)."""
        w, lo, hi = self._slots(kind, cache)
        if hi - lo == w:
            write_prompt(cache, k, v, s)
            return
        held = attn.cache_slot_positions(s - 1, w)[lo:hi]
        dst = torch.nonzero(held >= 0).flatten()
        src, dst = held[dst].to(k.device), dst.to(k.device)
        cache["k"].index_copy_(1, dst, k.index_select(1, src))
        cache["v"].index_copy_(1, dst, v.index_select(1, src))

    def decode_kv_seq(self, q, k, v, cache, pos: int, kind: str):
        """One token's attention over a cache that lies over its slots: the
        slot's owner writes k/v, the query heads are all-gathered, the
        ranks' partial softmaxes combined, and this rank's heads kept. Over
        a cache whole on every rank, each rank writes the slot and attends
        with its own query heads to the KV heads they read, no collective
        (a rank with no query head computes nothing)."""
        w, lo, hi = self._slots(kind, cache)
        if hi - lo == w:
            kc, vc = attn.cache_write(cache["k"], cache["v"], k, v, pos, w)
            if q.shape[2] == 0:
                return q
            return attn.decode_attention(
                q, self.kv_heads(kc), self.kv_heads(vc),
                attn.cache_slot_positions(pos, w, q.device), pos=pos)
        slot = pos % w
        if lo <= slot < hi:
            cache["k"][:, slot - lo:slot - lo + 1] = k.to(cache["k"].dtype)
            cache["v"][:, slot - lo:slot - lo + 1] = v.to(cache["v"].dtype)
        held = attn.cache_slot_positions(pos, w, q.device)[lo:hi]
        q_all = self.plane.all_gather_uneven(q, "model", 2, self.cfg.n_heads)
        y = attn.decode_attention_kv_seq(q_all, cache["k"], cache["v"], held,
                                         pos=pos, plane=self.plane)
        return y[:, :, self.heads[0]:self.heads[1]]


def grad_sum_axes(cfg, rules, seq_len: int):
    """Per parameter leaf (in ``tree_leaves`` order), the plane's axes
    ("dp", "model") over which a train step sums its gradient as autograd
    leaves it on each rank: the data axes for a leaf stored whole there
    (each rank's batch rows add a part), "model" for the norm scales under
    ``seq_shard`` (each rank normalises its part of S). The other
    leaves' gradients are whole already: the gathers' and copies'
    backwards sum them. The MoE router takes no "model" sum: every rank
    computes it whole on the whole rows, so its gradient is whole on each
    (``replicate`` keeps the rank's slice); nor does a recurrent block in
    ``_Plan.whole``, whose weights every rank differentiates whole and
    alike."""
    if rules is None:
        return None
    plane = sh.ModelPlane(rules)
    seq = cfg.act_seq_shard and plane.m > 1 and seq_len % plane.m == 0
    out = []
    for path, spec in cm.spec_paths(model_specs(cfg)):
        entries = plane.spec(spec.logical, spec.shape)
        axes = []
        if not any(e is not None and sh._axes(e) == plane.axes["dp"]
                   for e in entries):
            axes.append("dp")
        if seq and path[-1] in ("ln", "ln1", "ln2", "final_norm"):
            axes.append("model")
        out.append(tuple(axes))
    return out
