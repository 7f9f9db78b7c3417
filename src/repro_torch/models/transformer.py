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
logits (B, S, nq, V), codebook-major. ``act_seq_shard`` is not ported yet
and raises ``NotImplementedError`` (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

from typing import Any

import torch
# checkpoint() imports torch._dynamo on its first call, and that import
# leaves the frames then on the stack (a train step's, with its logits and
# gradients) in a reference cycle that only the cyclic collector frees;
# imported here, it runs before any training frame exists
import torch._dynamo  # noqa: F401
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as sh
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.rope import apply_mrope, apply_rope

_LATER = "not ported yet: ROADMAP Queue 1, item {}"


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
               device=None):
    """An empty cache of capacity ``seq_len``; prefill fills it."""
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
    b, s, _ = x.shape
    q = cm.dense(x, p["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = cm.dense(x, p["wk"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = cm.dense(x, p["wv"].to(x.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _apply_rope(q, k, positions, cfg):
    if cfg.mrope_sections:
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _mlp(p, x):
    h = F.silu(cm.dense(x, p["wi_gate"].to(x.dtype))) * \
        cm.dense(x, p["wi_up"].to(x.dtype))
    return cm.dense(h, p["wo"].to(x.dtype))


def _ffn(p, x, cfg, aux):
    """Second residual branch (MLP or MoE) of an attention block; returns
    (x, aux) with the MoE router loss, weighted, added to ``aux``."""
    xin = cm.rms_norm(x, p["ln2"])
    if "moe" in p:
        out = moe_lib.moe_forward(p["moe"], xin, cfg)
        return x + out.y, aux + out.aux_loss * cfg.router_aux_weight
    return x + _mlp(p["mlp"], xin), aux


def attn_block_seq(p, x, cfg, kind, positions, *, aux, cache=None,
                   use_flash=False):
    """Train/prefill attention block; returns (x, aux). positions: (B,S),
    or (B,S,3) under M-RoPE.
    A prefill passes ``cache`` ({"k", "v"} ring buffers from
    :func:`init_cache`) and the block writes its K/V there."""
    window = None
    if kind == "local_attn":
        window = cfg.local_window
    elif cfg.attention == "sliding":
        window = cfg.window
    q, k, v = _project_qkv(p, cm.rms_norm(x, p["ln1"]), cfg)
    q, k = _apply_rope(q, k, positions, cfg)
    y = attn.attention(q, k, v, causal=True, window=window, use_flash=use_flash)
    b, s, _, _ = y.shape
    x = x + cm.dense(y.reshape(b, s, -1), p["wo"].to(x.dtype))
    x, aux = _ffn(p, x, cfg, aux)
    if cache is not None:
        w = cache["k"].shape[1]
        if w >= s:      # linear region: positions 0..s-1 land at slots 0..s-1
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
        else:           # ring: keep the last w positions at slot p % w
            cache["k"].copy_(torch.roll(k[:, -w:], s % w, dims=1))
            cache["v"].copy_(torch.roll(v[:, -w:], s % w, dims=1))
    return x, aux


def attn_block_step(p, cache, x, cfg, pos: int, aux):
    """Single-token decode; returns (x, aux). x: (B,1,D); pos: absolute
    position (under M-RoPE every stream at ``pos``). Writes the token's K/V
    into ``cache`` in place."""
    q, k, v = _project_qkv(p, cm.rms_norm(x, p["ln1"]), cfg)
    b = x.shape[0]
    posb = torch.full((b, 1, 3) if cfg.mrope_sections else (b, 1), pos,
                      dtype=torch.int64, device=x.device)
    q, k = _apply_rope(q, k, posb, cfg)
    w = cache["k"].shape[1]
    kc, vc = attn.cache_write(cache["k"], cache["v"], k, v, pos, w)
    slot_pos = attn.cache_slot_positions(pos, w, x.device)
    y = attn.decode_attention(q, kc, vc, slot_pos, pos=pos)
    x = x + cm.dense(y.reshape(b, 1, -1), p["wo"].to(x.dtype))
    return _ffn(p, x, cfg, aux)


def _store(cache, new: dict):
    """Writes a recurrent block's new state into its cache buffers."""
    for name, t in new.items():
        cache[name].copy_(t)


def apply_block(p, cache, x, cfg, kind, positions, *, mode, pos, aux,
                use_flash=False):
    """Dispatch one block; returns (x, aux). A block given a cache
    (prefill, decode) reads its state there and writes the new one in
    place."""
    if kind in ("attn", "local_attn"):
        if mode == "decode":
            return attn_block_step(p, cache, x, cfg, pos, aux)
        return attn_block_seq(p, x, cfg, kind, positions, aux=aux,
                              cache=cache, use_flash=use_flash)
    if kind == "rglru":
        st = None if cache is None else rglru_lib.RGLRUState(cache["h"],
                                                             cache["conv"])
        x, st = rglru_lib.rglru_block(
            {k: v for k, v in p.items() if k not in ("ln2", "mlp")}, x, cfg,
            st)
        x = x + _mlp(p["mlp"], cm.rms_norm(x, p["ln2"]))
        if cache is not None:
            _store(cache, st._asdict())
        return x, aux
    if kind == "mlstm":
        st = conv = None
        if cache is not None:
            st = xlstm_lib.MLSTMState(cache["C"], cache["n"], cache["m"])
            conv = cache["conv"]
        x, (st, conv) = xlstm_lib.mlstm_block(p, x, cfg, st, conv)
        if cache is not None:
            _store(cache, dict(st._asdict(), conv=conv))
        return x, aux
    if kind == "slstm":
        st = None if cache is None else xlstm_lib.SLSTMState(
            cache["c"], cache["n"], cache["m"], cache["h"])
        x, st = xlstm_lib.slstm_block(p, x, cfg, st)
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
    b, s = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        if cfg.mrope_sections:
            positions = positions[..., None].expand(b, s, 3)
    return x, positions, batch.get("labels")


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
               use_flash=False, remat=False):
    """Every layer in order; returns (x, aux), aux the MoE layers' weighted
    router losses summed (a float32 zero for the other families). mode:
    "train" (no cache), "prefill" (fills ``cache``) or "decode" (reads and
    updates ``cache`` in place). ``remat`` checkpoints each unit: its
    parameter views, x and aux go in, only x and aux are kept."""
    if cfg.act_seq_shard:
        raise NotImplementedError(_LATER.format("11: sharding"))
    period, n_units, tail_kinds = scan_meta(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def unit_body(x, aux, p_unit, c_unit):
        for i, kind in enumerate(cfg.block_pattern):
            x, aux = apply_block(p_unit[i],
                                 None if c_unit is None else c_unit[i], x,
                                 cfg, kind, positions, mode=mode, pos=pos,
                                 aux=aux, use_flash=use_flash)
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
        x, aux = apply_block(params["tail"][i], c_i, x, cfg, kind, positions,
                             mode=mode, pos=pos, aux=aux, use_flash=use_flash)
    return x, aux


def forward_train(params, batch, cfg, *, remat=False, use_flash=False):
    """Returns (loss, {"ce", "aux"}): loss = ce + aux, ce the mean CE of
    the logits at positions 0..S-2 against ``batch["labels"]`` at 1..S-1,
    aux the MoE layers' router losses times ``cfg.router_aux_weight`` (0
    for the other families)."""
    x, positions, labels = embed_inputs(params, batch, cfg)
    x, aux = _run_stack(params, None, x, cfg, positions, mode="train",
                        use_flash=use_flash, remat=remat)
    logits = logits_from_hidden(params, x, cfg)
    ce = cm.cross_entropy(logits[:, :-1], labels[:, 1:])
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux}


def forward_prefill(params, batch, cfg, *, max_len=None, use_flash=False):
    """Returns (last_token_logits, cache).

    ``max_len``: cache capacity (prompt + expected decode steps). Defaults
    to the prompt length; serving callers pass prompt_len + generation
    budget."""
    x, positions, _ = embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    cap = max(max_len or s, s)
    cache = init_cache(cfg, b, cap, cfg.act_dtype, x.device)
    x, _ = _run_stack(params, cache, x, cfg, positions, mode="prefill",
                      use_flash=use_flash)
    return logits_from_hidden(params, x[:, -1:], cfg), dict(cache, pos=s)


def forward_decode(params, cache, batch, cfg):
    """One new token. batch: {"token": (B,1)} or, audio, {"codes": (B,1,nq)}.
    Returns (logits, cache): the cache's buffers are updated in place and
    its position advanced."""
    pos = cache["pos"]
    if cfg.frontend == "audio_codec":
        x = _embed_codes(batch["codes"], params["embed"]["tok"], cfg.act_dtype)
    else:
        x = cm.embed_lookup(batch["token"], params["embed"]["tok"],
                            cfg.act_dtype)
    x, _ = _run_stack(params, cache, x, cfg, None, mode="decode", pos=pos)
    return logits_from_hidden(params, x, cfg), dict(cache, pos=pos + 1)
