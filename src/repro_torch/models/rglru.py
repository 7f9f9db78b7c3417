"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427]
(mirrors ``repro.models.rglru``).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
  a_t = exp(-c * softplus(Lambda) * r_t),  r_t = sigmoid(W_a x_t),
  i_t = sigmoid(W_x x_t),  c = 8.

The diagonal linear recurrence over a sequence is a log-depth parallel
prefix scan over (a_t, b_t) pairs: ceil(log2 S) steps, each one combine of
every position with the one ``2^k`` before it, where the reference runs
``lax.associative_scan`` with the same operator. Decode is one elementwise
step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.xlstm import causal_conv

_C = 8.0


def rglru_specs(cfg):
    d, dr = cfg.d_model, cfg.rglru_d_rnn
    cw = cfg.rglru_conv_width
    return {
        "ln": cm.Spec((d,), ("d_model",), "zeros"),
        "w_x": cm.Spec((d, dr), ("d_model", "d_ff")),      # recurrent branch
        "w_gate": cm.Spec((d, dr), ("d_model", "d_ff")),   # GeLU gate branch
        "conv_w": cm.Spec((cw, dr), (None, "d_ff")),
        "conv_b": cm.Spec((dr,), ("d_ff",), "zeros"),
        "lam": cm.Spec((dr,), ("d_ff",), "lambda_init"),
        "w_a": cm.Spec((dr, dr), ("d_ff", None)),
        "b_a": cm.Spec((dr,), (None,), "zeros"),
        "w_i": cm.Spec((dr, dr), ("d_ff", None)),
        "b_i": cm.Spec((dr,), (None,), "zeros"),
        "w_out": cm.Spec((dr, d), ("d_ff", "d_model"), "scaled"),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, Dr) recurrent state
    conv: torch.Tensor       # (B, cw-1, Dr) conv history


def rglru_init_state(b, dr, cw, dtype=torch.float32, device=None):
    return RGLRUState(torch.zeros((b, dr), dtype=dtype, device=device),
                      torch.zeros((b, cw - 1, dr), dtype=dtype,
                                  device=device))


def _gates(x, p, mix=None):
    """x: (..., Dr) conv output -> (log_a, gated input) both f32. ``mix``
    (under the model plane, x this rank's channels and w_a, w_i their
    rows): the (2, ..., Dr) partial products -> the sums' columns of this
    rank's channels, a and i."""
    xf = x.float()
    pa, pi = xf @ p["w_a"].float(), xf @ p["w_i"].float()
    if mix is not None:
        pa, pi = mix(torch.stack([pa, pi]))
    r = torch.sigmoid(pa + p["b_a"])
    i = torch.sigmoid(pi + p["b_i"])
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a2, 1e-12)) * (i * xf)
    return log_a, b


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over dim 1:
    the prefix combine (a1, b1) . (a2, b2) = (a1 a2, b2 + a2 b1), one step
    per power of two below S (Hillis-Steele). Returns every h_t."""
    s = a.shape[1]
    k = 1
    while k < s:
        b = torch.cat([b[:, :k], b[:, k:] + a[:, k:] * b[:, :-k]], dim=1)
        if 2 * k < s:   # the last step's products are not read again
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b


def rglru_scan(x, p, h0, mix=None):
    """x: (B,S,Dr) conv output; h0: (B,Dr). Parallel scan over time."""
    log_a, b = _gates(x, p, mix)                     # (B,S,Dr) each
    a = torch.exp(log_a)
    # fold h0 into the first step: b_0 += a_0 * h0
    b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], 1)
    h = linear_scan(a, b)
    return h, h[:, -1]


def rglru_step(x_t, p, h_prev, mix=None):
    """x_t: (B,Dr) conv output; one decode step."""
    log_a, b = _gates(x_t, p, mix)
    h = torch.exp(log_a) * h_prev.float() + b
    return h, h


def rglru_block(p, x, cfg, state: RGLRUState | None = None, plan=None):
    """Full recurrent block: LN -> (conv -> RG-LRU) * GeLU gate -> out proj.

    x: (B,S,D). Returns (y, new_state).

    Under the model plane (``plan``, ``transformer._Plan``) the block runs
    on this rank's ``D_FF`` channels: ``w_x``/``w_gate`` column-parallel
    (their input through ``plan.enter``), the conv, Λ, the scan and its
    state on the rank's channels, the gates' products by the rank's rows of
    w_a and w_i reduce-scattered to its channels (``plan.channel_sums``),
    ``w_out`` row-parallel (``plan.exit``). Where m does not divide its
    channels (``plan.whole``) the block runs whole on every rank, its
    weights and state whole, with no collective inside it."""
    b = x.shape[0]
    if state is None:
        state = rglru_init_state(b, p["w_x"].shape[1], cfg.rglru_conv_width,
                                 device=x.device)
    xin = cm.rms_norm(x, p["ln"])
    mix = None
    if plan is not None:
        xin, mix = plan.enter(xin, "rglru"), plan.channel_sums()
    xr = cm.dense(xin, p["w_x"].to(x.dtype))         # (B,S,Dr)
    gate = F.gelu(cm.dense(xin, p["w_gate"].to(x.dtype)), approximate="tanh")
    xc, conv_state = causal_conv(xr, p["conv_w"].to(x.dtype),
                                 p["conv_b"].to(x.dtype), state.conv)
    if xc.shape[1] == 1:
        h, h_last = rglru_step(xc[:, 0], p, state.h, mix)
        h = h[:, None]
    else:
        h, h_last = rglru_scan(xc, p, state.h, mix)
    y = h.to(x.dtype) * gate
    out = cm.dense(y, p["w_out"].to(x.dtype))
    return x + (out if plan is None else plan.exit(out, "rglru")), \
        RGLRUState(h_last, conv_state)
