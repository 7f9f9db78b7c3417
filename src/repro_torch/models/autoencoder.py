"""The paper's convolutional autoencoder (mirrors
``repro.models.autoencoder``).

Public functions keep the JAX package's layout: images NHWC, conv weights
(kh, kw, C, F), dense weights (in, out). ``encode`` and ``recon_loss``
take one model on (B, H, W, C); the ``*_stacked`` functions take N
per-client models (every leaf with a leading client axis) on
(N, B, H, W, C). The stacked form runs the N models as one grouped
convolution (``groups=N``), so client i's activations only ever meet client
i's weights: the gradient of a sum of per-client losses with respect to
client i's parameters is exactly client i's own gradient.

Padding follows the reference exactly: ``_conv`` pads SAME asymmetrically
((0, 1) at stride 2), and ``_conv_t`` is the reference's zero-stuff, (2, 1)
pad and correlation with unflipped weights, computed as a transposed
convolution with flipped weights whose extra last row and column are cropped
(the zero-stuffed image is never materialised).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


@dataclasses.dataclass(frozen=True)
class AEConfig:
    height: int = 28
    width: int = 28
    channels: int = 1
    widths: tuple = (32, 64)
    latent_dim: int = 64

    @property
    def h4(self):
        return self.height // 4

    @property
    def w4(self):
        return self.width // 4


def ae_specs(cfg: AEConfig):
    c = cfg.channels
    w1, w2 = cfg.widths
    flat = cfg.h4 * cfg.w4 * w2
    return {
        "enc": {
            "conv1": cm.Spec((3, 3, c, w1), (None,) * 4, "he"),
            "b1": cm.Spec((w1,), (None,), "zeros"),
            "conv2": cm.Spec((3, 3, w1, w2), (None,) * 4, "he"),
            "b2": cm.Spec((w2,), (None,), "zeros"),
            "proj": cm.Spec((flat, cfg.latent_dim), (None, None), "he"),
            "bp": cm.Spec((cfg.latent_dim,), (None,), "zeros"),
        },
        "dec": {
            "proj": cm.Spec((cfg.latent_dim, flat), (None, None), "he"),
            "bp": cm.Spec((flat,), (None,), "zeros"),
            "conv1": cm.Spec((3, 3, w2, w1), (None,) * 4, "he"),
            "b1": cm.Spec((w1,), (None,), "zeros"),
            "conv2": cm.Spec((3, 3, w1, c), (None,) * 4, "he"),
            "b2": cm.Spec((c,), (None,), "zeros"),
        },
    }


def init_ae(generator: torch.Generator, cfg: AEConfig, n_clients=None,
            dtype=torch.float32):
    """One AE's parameters, or ``n_clients`` independent ones stacked."""
    return cm.init_params(generator, ae_specs(cfg), dtype, n=n_clients)


def _same_pads(size, k, s):
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _grouped(x):
    """(N, B, H, W, C) -> (B, N*C, H, W): clients become channel groups."""
    n, b, h, w, c = x.shape
    return x.permute(1, 0, 4, 2, 3).reshape(b, n * c, h, w)


def _ungrouped(h, n):
    """(B, N*C, H, W) -> (N, B, H, W, C)."""
    b, nc, hh, ww = h.shape
    return h.reshape(b, n, nc // n, hh, ww).permute(1, 0, 3, 4, 2)


def _conv(h, w, b, stride=1):
    """'SAME' conv of grouped h with per-client w (N, kh, kw, C, F)."""
    n, kh, kw, c, f = w.shape
    plo, phi = _same_pads(h.shape[2], kh, stride)
    qlo, qhi = _same_pads(h.shape[3], kw, stride)
    h = F.pad(h, (qlo, qhi, plo, phi))
    wg = w.permute(0, 4, 3, 1, 2).reshape(n * f, c, kh, kw)
    return F.conv2d(h, wg, b.reshape(n * f), stride=stride, groups=n)


def _conv_t(h, w, b, stride=2):
    """'SAME' transposed conv with the reference's padding rule."""
    n, kh, kw, c, f = w.shape
    pad_len = kh + stride - 2
    pad_a = kh - 1 if stride > kh - 1 else -(-pad_len // 2)
    lo = kh - 1 - pad_a
    out_h = stride * h.shape[2] - (stride - 1) + pad_len - kh + 1
    out_w = stride * h.shape[3] - (stride - 1) + pad_len - kw + 1
    wt = w.flip(1, 2).permute(0, 3, 4, 1, 2).reshape(n * c, f, kh, kw)
    y = F.conv_transpose2d(h, wt, b.reshape(n * f), stride=stride, groups=n)
    return y[:, :, lo:lo + out_h, lo:lo + out_w]


def encode_stacked(params, x, cfg: AEConfig):
    """x: (N, B, H, W, C) -> (N, B, latent)."""
    e = params["enc"]
    n, b = x.shape[:2]
    h = F.relu(_conv(_grouped(x), e["conv1"], e["b1"], 2))
    h = F.relu(_conv(h, e["conv2"], e["b2"], 2))
    h = _ungrouped(h, n).reshape(n, b, -1)
    return torch.baddbmm(e["bp"][:, None, :], h, e["proj"])


def decode_stacked(params, z, cfg: AEConfig):
    """z: (N, B, latent) -> (N, B, H, W, C)."""
    d = params["dec"]
    n, b = z.shape[:2]
    h = F.relu(torch.baddbmm(d["bp"][:, None, :], z, d["proj"]))
    h = _grouped(h.reshape(n, b, cfg.h4, cfg.w4, cfg.widths[1]))
    h = F.relu(_conv_t(h, d["conv1"], d["b1"], 2))
    # linear output head (no sigmoid), as in the reference
    return _ungrouped(_conv_t(h, d["conv2"], d["b2"], 2), n)


def reconstruct_stacked(params, x, cfg: AEConfig):
    return decode_stacked(params, encode_stacked(params, x, cfg), cfg)


def per_sample_loss_stacked(params, x, cfg: AEConfig):
    """(N, B) per-sample MSE: the exchange gate's anomaly score."""
    y = reconstruct_stacked(params, x, cfg)
    return torch.mean(torch.square(y - x), dim=(2, 3, 4))


def recon_loss_stacked(params, x, cfg: AEConfig):
    """(N,) mean-squared reconstruction error of each client's model."""
    y = reconstruct_stacked(params, x, cfg)
    return torch.mean(torch.square(y - x), dim=(1, 2, 3, 4))


def masked_recon_loss_stacked(params, x, mask, cfg: AEConfig):
    """(N,) masked mean per-sample MSE over a padded client stack; with
    ``mask`` selecting each real sample once this equals the unpadded
    :func:`recon_loss` of each client."""
    per = per_sample_loss_stacked(params, x, cfg)
    m = mask.to(per.dtype)
    return torch.sum(per * m, dim=1) / torch.clamp_min(torch.sum(m, dim=1),
                                                       1.0)


def _one(params):
    return cm.tree_map(lambda p: p[None], params)


def encode(params, x, cfg: AEConfig):
    """x: (B, H, W, C) -> (B, latent)."""
    return encode_stacked(_one(params), x[None], cfg)[0]


def recon_loss(params, x, cfg: AEConfig):
    """Mean-squared reconstruction error, the paper's L(phi, D)."""
    return recon_loss_stacked(_one(params), x[None], cfg)[0]
