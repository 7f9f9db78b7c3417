"""xLSTM blocks [arXiv:2405.04517]: mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, true recurrence) (mirrors ``repro.models.xlstm``).

mLSTM runs in the chunkwise-parallel form: a loop over chunks of 256 steps
carrying the (C, n, m) state, with a quadratic stabilised part inside each
chunk (chunk-local matmuls). sLSTM is sequential (h_{t-1} feeds the gates):
a loop over time whose input projection ``x @ w_gates`` is one GEMM over the
whole sequence before it, as it does not depend on h. Both have single-step
forms for decode.

Every stabiliser (the log-sigmoid forget gate, m, ``exp(-m)``) and every
state is float32 whatever the activation dtype, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm

NEG_INF = -1e30


def _round64(x: float) -> int:
    return max(64, int(math.ceil(x / 64)) * 64)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def mlstm_specs(cfg):
    d = cfg.d_model
    di = _round64(cfg.xlstm_proj_factor * d)
    h = cfg.n_heads
    cw = cfg.xlstm_conv_width
    return {
        "ln": cm.Spec((d,), ("d_model",), "zeros"),
        "w_up": cm.Spec((d, 2 * di), ("d_model", "d_ff")),
        "conv_w": cm.Spec((cw, di), (None, "d_ff")),
        "conv_b": cm.Spec((di,), ("d_ff",), "zeros"),
        "wq": cm.Spec((di, di), ("d_ff", None)),
        "wk": cm.Spec((di, di), ("d_ff", None)),
        "wv": cm.Spec((di, di), ("d_ff", None)),
        "w_if": cm.Spec((di, 2 * h), ("d_ff", None)),
        "b_if": cm.Spec((2 * h,), (None,), "zeros"),
        "gn": cm.Spec((di,), ("d_ff",), "ones"),
        "w_down": cm.Spec((di, d), ("d_ff", "d_model"), "scaled"),
    }


def slstm_specs(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    fu = _round64(4 * d / 3)
    return {
        "ln": cm.Spec((d,), ("d_model",), "zeros"),
        "w_gates": cm.Spec((d, 4 * d), ("d_model", "d_ff")),
        "r_gates": cm.Spec((h, dh, 4 * dh), ("heads", None, None)),
        "b_gates": cm.Spec((4 * d,), ("d_ff",), "zeros"),
        "gn": cm.Spec((d,), ("d_model",), "ones"),
        "ln2": cm.Spec((d,), ("d_model",), "zeros"),
        "ffn_up": cm.Spec((d, fu), ("d_model", "d_ff")),
        "ffn_down": cm.Spec((fu, d), ("d_ff", "d_model"), "scaled"),
    }


# ---------------------------------------------------------------------------
# mLSTM cell math
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B,H,dk,dv)
    n: torch.Tensor   # (B,H,dk)
    m: torch.Tensor   # (B,H)


def mlstm_init_state(b, h, dk, dv, dtype=torch.float32, device=None,
                     lead: tuple = ()):
    return MLSTMState(
        C=torch.zeros(lead + (b, h, dk, dv), dtype=dtype, device=device),
        n=torch.zeros(lead + (b, h, dk), dtype=dtype, device=device),
        m=torch.full(lead + (b, h), -1e9, dtype=dtype, device=device),
    )


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state: MLSTMState,
                    chunk: int = 256):
    """Chunkwise-parallel stabilised mLSTM.

    q,k,v: (B,S,H,dh) -- q pre-scaled by dh^-0.5 by the caller.
    i_pre,f_pre: (B,S,H) gate pre-activations.
    Returns (h: (B,S,H,dh) f32, final state).

    A ragged last chunk is padded: q, k, v with 0, ``i_pre`` with -1e9 (no
    input from padding) and ``f_pre`` with 30 (log sigmoid(30) ~ 0), so the
    padded steps neither decay the state nor shift the stabiliser m.
    """
    b, s, h, dh = q.shape
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        i_pre = F.pad(i_pre, (0, 0, 0, pad), value=-1e9)
        f_pre = F.pad(f_pre, (0, 0, 0, pad), value=30.0)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    C, n, m = state
    hs = []
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        qx, kx, vx = (x[:, sl].float() for x in (q, k, v))    # (B,c,H,dh)
        logf = F.logsigmoid(f_pre[:, sl].float())             # (B,c,H)
        bcum = torch.cumsum(logf, dim=1)                      # inclusive
        btot = bcum[:, -1]                                    # (B,H)
        ig = i_pre[:, sl].float()                             # log input gate

        # intra-chunk decay matrix D[i,j] = b_i - b_j + i_j  (j <= i)
        Dm = bcum[:, :, None, :] - bcum[:, None, :, :] + ig[:, None, :, :]
        Dm = torch.where(tri, Dm, NEG_INF)                    # (B,i,j,H)
        m_intra = torch.amax(Dm, dim=2)                       # (B,c,H)
        # inter-chunk scale for q_i on the carried state
        m_inter = bcum + m[:, None, :]                        # (B,c,H)
        m_i = torch.maximum(m_intra, m_inter)                 # (B,c,H)

        sc = torch.einsum("bihd,bjhd->bijh", qx, kx)          # (B,i,j,H)
        e = torch.exp(Dm - m_i[:, :, None, :])
        h_intra = torch.einsum("bijh,bjhd->bihd", e * sc, vx)
        n_intra = torch.einsum("bijh,bjhd->bihd", e, kx)

        scale_st = torch.exp(m_inter - m_i)                   # (B,c,H)
        h_inter = torch.einsum("bihd,bhdv->bihv", qx, C) * scale_st[..., None]
        n_inter = torch.einsum("bihd,bhd->bih", qx, n) * scale_st

        num = h_intra + h_inter                               # (B,c,H,dv)
        den = torch.abs(torch.sum(n_intra * qx, dim=-1) + n_inter)
        den = torch.maximum(den, torch.exp(-m_i))
        hs.append(num / den[..., None])

        # ---- state update ----
        decay_j = ig + btot[:, None, :] - bcum                # i_j + B - b_j
        m_upd = torch.amax(decay_j, dim=1)                    # (B,H)
        m_new = torch.maximum(m + btot, m_upd)
        sj = torch.exp(decay_j - m_new[:, None, :])           # (B,c,H)
        carry = torch.exp(m + btot - m_new)                   # (B,H)
        C = carry[:, :, None, None] * C + torch.einsum(
            "bjhd,bjhv->bhdv", sj[..., None] * kx, vx)
        n = carry[:, :, None] * n + torch.einsum("bjh,bjhd->bhd", sj, kx)
        m = m_new
    return torch.cat(hs, dim=1)[:, :s], MLSTMState(C, n, m)


def mlstm_step(q, k, v, i_pre, f_pre, state: MLSTMState):
    """Single-token recurrent mLSTM. q,k,v: (B,H,dh); gates (B,H)."""
    q, k, v = q.float(), k.float(), v.float()
    logf = F.logsigmoid(f_pre.float())
    ig = i_pre.float()
    m_new = torch.maximum(logf + state.m, ig)
    fs = torch.exp(logf + state.m - m_new)
    is_ = torch.exp(ig - m_new)
    C = fs[..., None, None] * state.C + is_[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = fs[..., None] * state.n + is_[..., None] * k
    num = torch.einsum("bhd,bhdv->bhv", q, C)
    den = torch.maximum(torch.abs(torch.sum(n * q, -1)), torch.exp(-m_new))
    return num / den[..., None], MLSTMState(C, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM cell math
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B,D)
    n: torch.Tensor   # (B,D)
    m: torch.Tensor   # (B,D)
    h: torch.Tensor   # (B,D)


def slstm_init_state(b, d, dtype=torch.float32, device=None,
                     lead: tuple = ()):
    shape = lead + (b, d)
    return SLSTMState(torch.zeros(shape, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device),
                      torch.full(shape, -1e9, dtype=dtype, device=device),
                      torch.zeros(shape, dtype=dtype, device=device))


def _input_gates(x, p):
    """W x: (..., D) -> (..., 4D) in f32; the part of the gates that does
    not depend on h."""
    return x.float() @ p["w_gates"].float()


def slstm_gates(x_t, h_prev, p, n_heads, wx=None):
    """Gate pre-activations: W x_t + R_blockdiag h_{t-1} + b -> 4 of (B,D).
    ``wx``: W x_t when the caller computed it already."""
    b, d = h_prev.shape
    dh = d // n_heads
    if wx is None:
        wx = _input_gates(x_t, p)
    hh = h_prev.reshape(b, n_heads, dh).float()
    # r_gates maps dh -> 4*dh per head (block-diagonal recurrence)
    rh = torch.einsum("bhd,hde->bhe", hh, p["r_gates"].float())
    rh = rh.reshape(b, n_heads, 4, dh).transpose(1, 2).reshape(b, 4, d)
    pre = wx.reshape(b, 4, d) + rh + p["b_gates"].float().reshape(1, 4, d)
    return pre.unbind(1)                                   # z, i, f, o


def slstm_step(x_t, state: SLSTMState, p, n_heads, wx=None):
    z, i, f, o = slstm_gates(x_t, state.h, p, n_heads, wx)
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + state.m, i)
    fs = torch.exp(logf + state.m - m_new)
    is_ = torch.exp(i - m_new)
    c = fs * state.c + is_ * torch.tanh(z)
    n = fs * state.n + is_
    h = torch.sigmoid(o) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c, n, m_new, h), h


def slstm_sequence(x, state: SLSTMState, p, n_heads, wx=None):
    """x: (B,S,D) -> (h: (B,S,D) f32, final state). A loop over time after
    one GEMM for every step's W x_t (``wx``, (B,S,4D), when the caller
    computed it)."""
    if wx is None:
        wx = _input_gates(x, p)                            # (B,S,4D)
    hs = []
    for t in range(x.shape[1]):
        state, h = slstm_step(None, state, p, n_heads, wx[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), state


# ---------------------------------------------------------------------------
# blocks (residual wrappers) -- forward over a full sequence or one step
# ---------------------------------------------------------------------------

def causal_conv(x, w, b, state=None):
    """Depthwise causal conv over time. x: (B,S,Di), w: (cw,Di).

    state: (B,cw-1,Di) carried history for decode; returns (y, new_state).
    """
    cw = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, cw):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    new_state = xp[:, -(cw - 1):] if cw > 1 else None
    return y.to(x.dtype), new_state


def mlstm_block(p, x, cfg, state=None, conv_state=None, plan=None):
    """x: (B,S,D). Returns (y, (MLSTMState, conv_state)).

    Under the model plane (``plan``, ``transformer._Plan``) ``w_up`` holds
    this rank's ``D_FF`` channels of x_i and of z (``[xi_r | z_r]``), and
    the conv and the rows of ``wq``/``wk``/``wv``/``w_if`` are the rank's:
    their partial products are summed over "model" in one all-reduce, the
    cell and the per-head group norm run whole on every rank (the state
    has no model axis), and the rank keeps its channels of the output
    (``ModelPlane.split``) for ``* silu(z)`` and the row-parallel
    ``w_down``. Where m does not divide the inner width (``plan.whole``)
    the block runs whole on every rank, with no collective inside it."""
    b = x.shape[0]
    h = cfg.n_heads
    di = p["wq"].shape[1]
    dh = di // h
    split = plan is not None and "mlstm" not in plan.whole
    xin = cm.rms_norm(x, p["ln"])
    if plan is not None:
        xin = plan.enter(xin, "mlstm")
    s = xin.shape[1]
    up = cm.dense(xin, p["w_up"].to(x.dtype))
    xi, z = up.chunk(2, dim=-1)
    xc, conv_state = causal_conv(xi, p["conv_w"].to(x.dtype),
                                 p["conv_b"].to(x.dtype), conv_state)
    xc = F.silu(xc)
    q = cm.dense(xc, p["wq"].to(x.dtype))
    k = cm.dense(xc, p["wk"].to(x.dtype))
    v = cm.dense(xi, p["wv"].to(x.dtype))
    gates = cm.dense(xc, p["w_if"].to(x.dtype))
    if split:
        q, k, v, gates = plan.plane.psum_packed([q, k, v, gates], "model")
    q = q.reshape(b, s, h, dh) * dh ** -0.5
    k = k.reshape(b, s, h, dh) * dh ** -0.5
    v = v.reshape(b, s, h, dh)
    gates = gates + p["b_if"].to(x.dtype)
    i_pre, f_pre = gates.chunk(2, dim=-1)                  # (B,S,H)
    f_pre = f_pre + 3.0                                    # remember-bias
    if state is None:
        state = mlstm_init_state(b, h, dh, dh, device=x.device)
    if s == 1:
        hy, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0],
                               i_pre[:, 0], f_pre[:, 0], state)
        hy = hy[:, None]
    else:
        hy, state = mlstm_chunkwise(q, k, v, i_pre, f_pre, state)
    hy = cm.group_norm_heads(hy, p["gn"].reshape(h, dh), h).reshape(b, s, di)
    if split:
        hy = plan.plane.split(hy, "model", 2)
    out = hy.to(x.dtype) * F.silu(z)
    y = cm.dense(out, p["w_down"].to(x.dtype))
    return x + (y if plan is None else plan.exit(y, "mlstm")), \
        (state, conv_state)


def slstm_block(p, x, cfg, state=None, plan=None):
    """x: (B,S,D). Returns (y, SLSTMState).

    Under the model plane (``plan``) each rank computes its columns of
    ``W x`` (``w_gates`` column-parallel, stored gate-major in contiguous
    parts), all-gathered along the last dim once a block
    (``ModelPlane.replicate``); ``r_gates`` and ``b_gates`` come whole
    (``replicate``), and the loop over time runs whole on every rank, no
    collective inside it (the state has no model axis). Under
    ``act_seq_shard`` the rank keeps its part of S of the cell's output
    (``ModelPlane.split``). Where m does not divide ``W x``'s columns
    (``plan.whole``) every rank computes it whole, with no collective. The
    post-FFN is the dense MLP's column/row pair."""
    b, s, d = x.shape
    nh = cfg.n_heads
    xin = cm.rms_norm(x, p["ln"])
    wx = None
    if plan is not None:
        xin = plan.enter(xin, "slstm")
        s = xin.shape[1]
        xw = xin[:, 0] if s == 1 else xin
        wx = _input_gates(xw, p)
        if "slstm" not in plan.whole:
            wx = plan.plane.replicate(wx, "model", xw.dim() - 1)
    if state is None:
        state = slstm_init_state(b, d, device=x.device)
    if s == 1:
        state, h = slstm_step(xin[:, 0], state, p, nh, wx)
        h = h[:, None]
    else:
        h, state = slstm_sequence(xin, state, p, nh, wx)
    h = cm.group_norm_heads(h.reshape(b, s, nh, d // nh),
                            p["gn"].reshape(nh, d // nh), nh).reshape(b, s, d)
    if plan is not None and plan.seq_shard:
        h = plan.plane.split(h, "model", 1)
    x = x + h.to(x.dtype)
    # post-FFN (GeLU in its tanh form, as jax.nn.gelu; pf 4/3)
    xin2 = cm.rms_norm(x, p["ln2"])
    if plan is not None:
        xin2 = plan.enter(xin2)
    f = cm.dense(xin2, p["ffn_up"].to(x.dtype))
    out = cm.dense(F.gelu(f, approximate="tanh"), p["ffn_down"].to(x.dtype))
    return x + (out if plan is None else plan.exit(out)), state
