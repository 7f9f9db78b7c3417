"""Model registry: one handle over the ported architectures (mirrors
``repro.models.registry``).

``build_model(cfg)`` returns a :class:`Model` bundling init and spec trees
and the train / prefill / decode entry points; ``make_train_step(model,
tc)`` is the training step the launcher and the federated-LLM example call.
``make_prefill_step`` and ``make_decode_step`` are the reference's
wrappers of ``Model.prefill`` and ``Model.decode`` (``launch.serve`` calls
the entry points directly, with ``use_flash=True``); the prefill allocates
its own cache, and ``Model.init_cache`` builds one on its own for
``launch.dryrun``'s decode step.

Each entry point takes ``rules=`` (a ``sharding.ShardingRules`` over a
(data, model) mesh): the parameters, moments, batch and cache are then
this rank's shards (``sharding.place_params``) and the step runs the model
plane (``models.transformer``). A batch whose rows the data axes do not
divide is replicated there (``launch.specs.place_batch``). Above one data
rank a caller passes ``global_batch=`` (the whole batch's rows), which
tells a split batch from a replicated one (the MoE's capacity groups
differ); an entry point without it raises there.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import optim, resolve_device
from repro_torch import sharding as sh
from repro_torch.configs.base import ModelConfig, TrainConfig
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

    def param_shapes(self, rules=None):
        """The parameter tree as meta tensors (shape and dtype, no data):
        one rank's shards under ``rules``."""
        return cm.param_shapes(self.specs, self.cfg.p_dtype, rules)

    def param_logical(self):
        """Each parameter's logical axes (``sharding.ShardingRules.spec``)."""
        return cm.param_logical(self.specs)

    def n_params(self) -> int:
        return sum(math.prod(s.shape) for s in cm.tree_leaves(self.specs))

    def n_active_params(self) -> int:
        """Active parameters per token. MoE: a leaf under a ``moe`` key
        counts k / E of its size (integer division), except under
        ``shared`` or ``router``; the other families: all of them."""
        cfg = self.cfg
        if not cfg.is_moe:
            return self.n_params()
        total = 0
        for path, s in cm.spec_paths(self.specs):
            size = math.prod(s.shape)
            if "moe" in path and "shared" not in path and "router" not in path:
                size = size * cfg.experts_per_token // cfg.n_experts
            total += size
        return total

    # ---- forwards ----
    def loss_fn(self, params, batch, *, remat=False, use_flash=False,
                rules=None, global_batch=None):
        return tf.forward_train(params, batch, self.cfg, remat=remat,
                                use_flash=use_flash, rules=rules,
                                global_batch=global_batch)

    def prefill(self, params, batch, *, max_len=None, use_flash=False,
                rules=None, global_batch=None):
        return tf.forward_prefill(params, batch, self.cfg, max_len=max_len,
                                  use_flash=use_flash, rules=rules,
                                  global_batch=global_batch)

    def decode(self, params, cache, batch, *, rules=None, global_batch=None):
        return tf.forward_decode(params, cache, batch, self.cfg, rules=rules,
                                 global_batch=global_batch)

    def init_cache(self, batch: int, seq_len: int, device="cuda",
                   rules=None):
        """The empty cache of capacity ``seq_len`` that ``prefill`` fills,
        on ``device`` (``"meta"``: shapes and dtypes only); this rank's
        shards of it under ``rules``."""
        return tf.init_cache(self.cfg, batch, seq_len, self.cfg.act_dtype,
                             resolve_device(device), rules=rules)

    def cache_logical(self, seq_len: int, model_axis_size: int):
        """The cache's logical axes, for a model axis of that size."""
        return tf.cache_logical(self.cfg, seq_len, model_axis_size)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg=cfg, specs=tf.model_specs(cfg))


def make_train_step(model: Model, tc: TrainConfig, *,
                    donate: bool = False, rules=None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: gradients of the loss, clipped to ``tc.grad_clip`` by global
    norm, then one optimizer update at the cosine-warmup rate of the step
    count before it. ``metrics`` holds ``loss``, ``grad_norm`` (before
    clipping), ``lr``, ``ce`` and ``aux`` as device scalars.

    The inputs are not written to, unless ``donate``: then the gradients
    are clipped in place and the update writes the new parameters and
    moments into the given trees leaf by leaf (the reference's
    ``donate_argnums=(0, 1)``), so the step holds parameters, gradients and
    moments once (16 bytes a float32 parameter under AdamW) and one leaf's
    temporaries. The results are bit for bit those of the plain step.

    Under ``rules`` the trees and the batch are this rank's shards
    (``global_batch``, the whole batch's rows, as ``Model.loss_fn`` takes
    it: required above one data rank). The
    gradients of leaves stored split over the data axes come out of the
    FSDP gathers' backward reduce-scattered (summed over the data axes);
    the others are all-reduced here over the axes
    ``transformer.grad_sum_axes`` names, one buffer per axis set; the
    global norm sums each shard once (a leaf stored whole on an axis counts
    on that axis's first rank) in one all-reduce over every mesh axis; the
    update is shard-local."""
    remat = tc.remat != "none"
    hyper = ({"beta1": tc.beta1, "beta2": tc.beta2, "eps": tc.eps,
              "weight_decay": tc.weight_decay}
             if tc.optimizer == "adamw" else {})
    plane = None if rules is None or not tf.plane_supported(model.cfg) \
        else sh.ModelPlane(rules)

    def train_step(params, opt_state, batch, global_batch=None):
        parts = {}

        def lf(p):
            loss, metrics = model.loss_fn(p, batch, remat=remat, rules=rules,
                                          global_batch=global_batch)
            parts.update((k, v.detach()) for k, v in metrics.items())
            return loss
        loss, grads = cm.value_and_grad(lf, params)
        norm_kw = {}
        if plane is not None:
            grads, norm_kw = _plane_grads(model, plane, grads,
                                          tf.batch_rows_len(batch)[1])
        grads, gnorm = optim.clip_by_global_norm(grads, tc.grad_clip,
                                                 donate=donate, **norm_kw)
        lr = optim.cosine_warmup(opt_state.step, base_lr=tc.learning_rate,
                                 warmup_steps=tc.warmup_steps,
                                 total_steps=tc.total_steps)
        params, opt_state = optim.opt_update(tc.optimizer, params, grads,
                                             opt_state, lr, donate=donate,
                                             **hyper)
        return params, opt_state, dict(parts, loss=loss, grad_norm=gnorm,
                                       lr=lr)

    return train_step


def _plane_grads(model, plane, grads, seq_len: int):
    """The gradients summed over the axes each leaf needs (one all-reduce
    per axis set), and the global norm's arguments: which leaves this
    rank's shard counts in the norm and the norm's all-reduce."""
    cfg = model.cfg
    leaves = cm.tree_leaves(grads)
    sums = tf.grad_sum_axes(cfg, plane.rules, seq_len)
    for axes in sorted(set(sums) - {()}):
        idx = [i for i, a in enumerate(sums) if a == axes]
        axis = axes[0] if len(axes) == 1 else "all"
        flat = plane.all_reduce(torch.cat([leaves[i].reshape(-1)
                                           for i in idx]), axis)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            leaves[i] = flat[off:off + n].reshape(leaves[i].shape)
            off += n
    counted = []
    for spec in cm.tree_leaves(model.specs):
        entries = plane.spec(spec.logical, spec.shape)
        used = {a for e in entries if e is not None for a in sh._axes(e)}
        counted.append(all(plane.entry_rank(a) == 0
                           for a in plane.axes["all"] if a not in used))
    return cm.tree_unflatten(grads, leaves), {
        "counted": counted,
        "reduce": lambda t: plane.all_reduce(t, "all")}


def make_prefill_step(model: Model, *, rules=None,
                      global_batch=None) -> Callable:
    """``prefill_step(params, batch) -> (last_token_logits, cache)``:
    ``Model.prefill`` with ``rules`` and ``global_batch`` bound."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, rules=rules,
                             global_batch=global_batch)
    return prefill_step


def make_decode_step(model: Model, *, rules=None,
                     global_batch=None) -> Callable:
    """``decode_step(params, cache, batch) -> (logits, cache)``:
    ``Model.decode`` with ``rules`` and ``global_batch`` bound."""
    def decode_step(params, cache, batch):
        return model.decode(params, cache, batch, rules=rules,
                            global_batch=global_batch)
    return decode_step
