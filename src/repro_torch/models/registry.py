"""Model registry: one handle over the ported architectures (mirrors
``repro.models.registry``; the training step waits for the training path,
ROADMAP Queue 1).

``build_model(cfg)`` returns a :class:`Model` bundling init and spec trees
and the prefill / decode entry points used by the launcher. The JAX
package's ``make_prefill_step`` / ``make_decode_step`` wrappers and
``Model.init_cache`` have no caller here: ``launch.serve`` calls
``Model.prefill(..., use_flash=True)`` and ``Model.decode`` directly, and the
prefill allocates its own cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    specs: Any

    # ---- params ----
    def init(self, generator: torch.Generator, device="cuda"):
        """Parameters drawn from ``generator`` (on its own device, leaf by
        leaf in flatten order) and placed on ``device``."""
        return cm.init_params(generator, self.specs, self.cfg.p_dtype,
                              device=resolve_device(device),
                              n_layers=self.cfg.n_layers)

    def param_shapes(self):
        """The parameter tree as meta tensors (shape and dtype, no data)."""
        return cm.tree_map(lambda s: torch.empty(s.shape, dtype=self.cfg.p_dtype,
                                                 device="meta"), self.specs)

    def n_params(self) -> int:
        return sum(math.prod(s.shape) for s in cm.tree_leaves(self.specs))

    # ---- forwards ----
    def prefill(self, params, batch, *, max_len=None, use_flash=False):
        return tf.forward_prefill(params, batch, self.cfg, max_len=max_len,
                                  use_flash=use_flash)

    def decode(self, params, cache, batch):
        return tf.forward_decode(params, cache, batch, self.cfg)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, specs=tf.model_specs(cfg))

