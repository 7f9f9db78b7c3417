"""Synthetic class-structured image datasets (mirrors
``repro.data.synthetic``), drawn with a ``torch.Generator`` on the target
device.

Each class has a smooth low-frequency prototype; a sample is prototype +
smooth per-sample deformation + pixel noise, squashed into (0, 1). The
reference upsamples its noise grids with ``jax.image.resize(..., "bicubic")``
and this module with ``F.interpolate(mode="bicubic")``, whose kernels differ:
the two generators give the same kind of data, not the same arrays. Parity
tests feed the reference's arrays to both sides.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class ImageDataset(NamedTuple):
    images: torch.Tensor   # (n, H, W, C) in [0, 1]
    labels: torch.Tensor   # (n,) int64


def _smooth(generator, n, h, w, c, grid=4):
    """(n, h, w, c) smooth noise: a (grid x grid) normal field upsampled."""
    low = torch.randn((n, c, grid, grid), generator=generator,
                      device=generator.device)
    return F.interpolate(low, size=(h, w), mode="bicubic",
                         align_corners=False).permute(0, 2, 3, 1)


def make_image_dataset(generator: torch.Generator, *, n_classes=10,
                       n_per_class=200, height=28, width=28, channels=1,
                       proto_strength=2.5, proto_grid=12, deform=0.4,
                       noise=0.08) -> ImageDataset:
    """See ``repro.data.synthetic.make_image_dataset`` for the knobs."""
    dev = generator.device
    protos = _smooth(generator, n_classes, height, width, channels,
                     grid=proto_grid) * proto_strength
    n = n_classes * n_per_class
    labels = torch.arange(n_classes, device=dev).repeat_interleave(
        n_per_class)
    imgs = protos[labels] + _smooth(generator, n, height, width, channels,
                                    grid=6) * deform
    imgs += torch.randn((n, height, width, channels), generator=generator,
                        device=dev) * noise
    imgs = torch.sigmoid(imgs)
    perm = torch.randperm(n, generator=generator, device=dev)
    return ImageDataset(imgs[perm], labels[perm])


def make_split_dataset(generator: torch.Generator, *, n_train_per_class,
                       n_eval_per_class, n_classes=10, **kw
                       ) -> tuple[ImageDataset, ImageDataset]:
    """Train/eval split drawn from the same class prototypes."""
    ds = make_image_dataset(generator, n_classes=n_classes,
                            n_per_class=n_train_per_class + n_eval_per_class,
                            **kw)
    cut = n_train_per_class * n_classes
    return (ImageDataset(ds.images[:cut], ds.labels[:cut]),
            ImageDataset(ds.images[cut:], ds.labels[cut:]))


def fmnist_like(generator: torch.Generator, n_per_class=200) -> ImageDataset:
    return make_image_dataset(generator, height=28, width=28, channels=1,
                              n_per_class=n_per_class)


def fmnist_like_split(generator: torch.Generator, n_train_per_class=200,
                      n_eval_per_class=30):
    return make_split_dataset(generator, n_train_per_class=n_train_per_class,
                              n_eval_per_class=n_eval_per_class,
                              height=28, width=28, channels=1)


def cifar_like(generator: torch.Generator, n_per_class=200) -> ImageDataset:
    return make_image_dataset(generator, height=32, width=32, channels=3,
                              n_per_class=n_per_class)


def cifar_like_split(generator: torch.Generator, n_train_per_class=200,
                     n_eval_per_class=30):
    return make_split_dataset(generator, n_train_per_class=n_train_per_class,
                              n_eval_per_class=n_eval_per_class,
                              height=32, width=32, channels=3)
