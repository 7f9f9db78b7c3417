"""Decoder backbone, dense-attention path (mirrors ``repro.models.transformer``).

Layer stacking: layers are grouped into *units* of ``len(block_pattern)``
layers, and each unit's parameters are stacked along a leading n_units axis,
as in the JAX package; where it scans over units, the port loops over them
and indexes the stacked tensors. ``n_layers % period`` remainder layers are
applied unrolled.

Entry points:
  * forward_prefill(params, batch, cfg)        -> (last_logits, cache)
  * forward_decode(params, cache, batch, cfg)  -> (logits, cache)
  * _run_stack(..., mode="train")              -> hidden states (forward only)

Cache layout: {"pos": int, "scan": (per pattern position {"k", "v"} with a
leading n_units axis,), "tail": (per tail layer {"k", "v"},)}. Attention
caches are ring buffers of length min(capacity, window). Prefill fills
buffers allocated once by :func:`init_cache`; decode writes each new token's
K/V into them in place.

MoE, the recurrent blocks (rglru, mlstm, slstm), the vision and audio
frontends and ``act_seq_shard`` are not ported yet and raise
``NotImplementedError`` (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.rope import apply_rope

_LATER = "not ported yet: ROADMAP Queue 1, {}"


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
    if cfg.is_moe:
        raise NotImplementedError(_LATER.format("the MoE family (moe.py)"))
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "ln1": cm.Spec((d,), ("d_model",), "zeros"),
        "wq": cm.Spec((d, h * hd), ("d_model", "heads")),
        "wk": cm.Spec((d, kv * hd), ("d_model", "kv_heads")),
        "wv": cm.Spec((d, kv * hd), ("d_model", "kv_heads")),
        "wo": cm.Spec((h * hd, d), ("heads", "d_model"), "scaled"),
        "ln2": cm.Spec((d,), ("d_model",), "zeros"),
        "mlp": mlp_specs(cfg),
    }


def _unported_kind(kind: str):
    if kind in ("mlstm", "slstm"):
        return NotImplementedError(_LATER.format("the xLSTM family (xlstm.py)"))
    if kind == "rglru":
        return NotImplementedError(
            _LATER.format("the recurrentgemma family (rglru.py)"))
    return ValueError(kind)


def block_specs(cfg, kind: str):
    if kind in ("attn", "local_attn"):
        return attn_specs(cfg)
    raise _unported_kind(kind)


def model_specs(cfg):
    """Full parameter Spec tree. Stacked units + unrolled tail."""
    if cfg.frontend != "none":
        raise NotImplementedError(_LATER.format(
            f"the {cfg.frontend} frontend (qwen2-vl, musicgen)"))
    period = len(cfg.block_pattern)
    n_units, n_tail = divmod(cfg.n_layers, period)
    specs: dict[str, Any] = {
        "embed": {"tok": cm.Spec((cfg.vocab_size, cfg.d_model),
                                 ("vocab", "d_model"))}}
    specs["scan"] = tuple(
        cm.stack_specs(block_specs(cfg, kind), n_units)
        for kind in cfg.block_pattern
    ) if n_units else ()
    specs["tail"] = tuple(
        block_specs(cfg, cfg.layer_kinds[n_units * period + i])
        for i in range(n_tail)
    )
    specs["final_norm"] = cm.Spec((cfg.d_model,), ("d_model",), "zeros")
    specs["head"] = cm.Spec((cfg.d_model, cfg.vocab_size), ("d_model", "vocab"))
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
    """Zero K/V ring buffers (*lead, B, W, Kv, hd) for one attention block."""
    if kind not in ("attn", "local_attn"):
        raise _unported_kind(kind)
    shape = lead + (batch, attn_cache_len(cfg, kind, seq_len), cfg.n_kv_heads,
                    cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
        raise NotImplementedError(_LATER.format("M-RoPE (the vision family)"))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _mlp(p, x):
    h = F.silu(cm.dense(x, p["wi_gate"].to(x.dtype))) * \
        cm.dense(x, p["wi_up"].to(x.dtype))
    return cm.dense(h, p["wo"].to(x.dtype))


def _ffn(p, x, cfg):
    """Second residual branch (the MLP) of an attention block."""
    if "moe" in p:
        raise NotImplementedError(_LATER.format("the MoE family (moe.py)"))
    return x + _mlp(p["mlp"], cm.rms_norm(x, p["ln2"]))


def attn_block_seq(p, x, cfg, kind, positions, *, cache=None,
                   use_flash=False):
    """Train/prefill attention block. positions: (B,S). A prefill passes
    ``cache`` ({"k", "v"} ring buffers from :func:`init_cache`) and the
    block writes its K/V there."""
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
    x = _ffn(p, x, cfg)
    if cache is not None:
        w = cache["k"].shape[1]
        if w >= s:      # linear region: positions 0..s-1 land at slots 0..s-1
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
        else:           # ring: keep the last w positions at slot p % w
            cache["k"].copy_(torch.roll(k[:, -w:], s % w, dims=1))
            cache["v"].copy_(torch.roll(v[:, -w:], s % w, dims=1))
    return x


def attn_block_step(p, cache, x, cfg, pos: int):
    """Single-token decode. x: (B,1,D); pos: absolute position. Writes the
    token's K/V into ``cache`` in place."""
    q, k, v = _project_qkv(p, cm.rms_norm(x, p["ln1"]), cfg)
    b = x.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k = _apply_rope(q, k, posb, cfg)
    w = cache["k"].shape[1]
    kc, vc = attn.cache_write(cache["k"], cache["v"], k, v, pos, w)
    slot_pos = attn.cache_slot_positions(pos, w, x.device)
    y = attn.decode_attention(q, kc, vc, slot_pos, pos=pos)
    x = x + cm.dense(y.reshape(b, 1, -1), p["wo"].to(x.dtype))
    return _ffn(p, x, cfg)


def apply_block(p, cache, x, cfg, kind, positions, *, mode, pos,
                use_flash=False):
    """Dispatch one block; returns x (a cache is filled in place)."""
    if kind not in ("attn", "local_attn"):
        raise _unported_kind(kind)
    if mode == "decode":
        return attn_block_step(p, cache, x, cfg, pos)
    return attn_block_seq(p, x, cfg, kind, positions, cache=cache,
                          use_flash=use_flash)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params, batch, cfg):
    """Returns (x: (B,S,D), positions, labels or None)."""
    if cfg.frontend != "none":
        raise NotImplementedError(_LATER.format(f"the {cfg.frontend} frontend"))
    tokens = batch["tokens"]
    x = cm.embed_lookup(tokens, params["embed"]["tok"], cfg.act_dtype)
    b, s = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return x, positions, batch.get("labels")


def logits_from_hidden(params, x, cfg):
    """Final norm and LM head: x's dtype operands, ``cfg.logits_dtype``
    products and sums (float32 by default, so bf16 logits are not rounded
    to bf16)."""
    x = cm.rms_norm(x, params["final_norm"])
    return cm.dense(x, params["head"].to(x.dtype),
                    getattr(torch, cfg.logits_dtype))


# ---------------------------------------------------------------------------
# full forwards
# ---------------------------------------------------------------------------

def _run_stack(params, cache, x, cfg, positions, *, mode, pos=0,
               use_flash=False):
    """Every layer in order; returns x. mode: "train" (no cache),
    "prefill" (fills ``cache``) or "decode" (reads and updates ``cache`` in
    place)."""
    if cfg.act_seq_shard:
        raise NotImplementedError(_LATER.format("sharding (slice 3)"))
    period, n_units, tail_kinds = scan_meta(cfg)
    for u in range(n_units):
        for i, kind in enumerate(cfg.block_pattern):
            p_i = cm.tree_map(lambda a: a[u], params["scan"][i])
            c_i = None if cache is None else \
                cm.tree_map(lambda a: a[u], cache["scan"][i])
            x = apply_block(p_i, c_i, x, cfg, kind, positions, mode=mode,
                            pos=pos, use_flash=use_flash)
    for i, kind in enumerate(tail_kinds):
        c_i = None if cache is None else cache["tail"][i]
        x = apply_block(params["tail"][i], c_i, x, cfg, kind, positions,
                        mode=mode, pos=pos, use_flash=use_flash)
    return x


def forward_prefill(params, batch, cfg, *, max_len=None, use_flash=False):
    """Returns (last_token_logits, cache).

    ``max_len``: cache capacity (prompt + expected decode steps). Defaults
    to the prompt length; serving callers pass prompt_len + generation
    budget."""
    x, positions, _ = embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    cap = max(max_len or s, s)
    cache = init_cache(cfg, b, cap, cfg.act_dtype, x.device)
    x = _run_stack(params, cache, x, cfg, positions, mode="prefill",
                   use_flash=use_flash)
    return logits_from_hidden(params, x[:, -1:], cfg), dict(cache, pos=s)


def forward_decode(params, cache, batch, cfg):
    """One new token. batch: {"token": (B,1)}. Returns (logits, cache): the
    cache's buffers are updated in place and its position advanced."""
    pos = cache["pos"]
    x = cm.embed_lookup(batch["token"], params["embed"]["tok"], cfg.act_dtype)
    x = _run_stack(params, cache, x, cfg, None, mode="decode", pos=pos)
    return logits_from_hidden(params, x, cfg), dict(cache, pos=pos + 1)
