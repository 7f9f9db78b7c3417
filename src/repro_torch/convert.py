"""Carries the JAX package's state across to the port.

Each function takes the reference's values as numpy arrays (nested dicts in
the reference's layout; ``np.asarray`` of a JAX array is one) and returns
the port's tensors on ``device``. The port keeps the reference's layout at
its public functions (NHWC images, (kh, kw, C, F) conv weights), so the
conversion is a copy, not a transpose.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.qlearning import RLState
from repro_torch.dynamics import runstate as _rs
from repro_torch.dynamics.environment import EnvState
from repro_torch.fl.trainer import FLCarry
from repro_torch.models.common import tree_map
from repro_torch.optim import OptState


def _tensor(a, device):
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":   # numpy's bf16 extension type: widen
        return torch.as_tensor(a.astype(np.float32),    # exactly, then narrow
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(a, device=device)


def lm_params(tree, device="cpu", *, rules=None, logical=None) -> dict:
    """A transformer's parameter tree ({"embed", "scan": (...), "tail":
    (...), "final_norm", "head"}), attention and recurrent blocks alike;
    the layouts match, so this is a copy. An MoE block's ``moe`` sub-tree
    (router, the stacked experts' wi_gate / wi_up / wo, and ``shared``)
    comes across the same way, and so do the frontends' leaves: the vision
    stub's projector ``embed.proj`` (frontend_dim, D) and the audio
    codec's stacked codebook table ``embed.tok`` (nq, V, D) with its head
    (D, nq * V).

    With ``rules`` and the tree's ``logical`` axes (``Model.param_logical``)
    it returns this rank's shards (``sharding.place_params``), so every
    rank of a mesh computes the model the JAX parameters describe."""
    whole = tree_map(lambda a: _tensor(a, device), tree)
    if rules is None:
        return whole
    from repro_torch.sharding import place_params
    return place_params(whole, logical, rules)


def lm_cache(cache, device="cpu") -> dict:
    """A prefill/decode cache {"pos", "scan", "tail"}: K/V ring buffers and
    recurrent states (rglru h, conv; mlstm C, n, m, conv; slstm c, n, m, h)
    in their own dtypes; ``pos`` becomes a Python int."""
    return {"pos": int(np.asarray(cache["pos"])),
            "scan": tree_map(lambda a: _tensor(a, device), cache["scan"]),
            "tail": tree_map(lambda a: _tensor(a, device), cache["tail"])}


def opt_state(state, device="cpu") -> OptState:
    """An optimizer ``OptState`` (step, mu, nu): the moments are trees in
    the parameters' layout (``()`` where the optimizer keeps none) and the
    step an int32 scalar."""
    step, mu, nu = state
    return OptState(_tensor(step, device).to(torch.int32),
                    tree_map(lambda a: _tensor(a, device), mu),
                    tree_map(lambda a: _tensor(a, device), nu))


def ae_params(tree, device="cpu") -> dict:
    """AE parameters, single or stacked with a leading client axis."""
    return tree_map(lambda a: _tensor(a, device), tree)


def fl_carry(carry, device="cpu") -> FLCarry:
    """An ``FLCarry`` (client_params, global_params, mu, nu, step)."""
    cp, gp, mu, nu, step = carry
    return FLCarry(ae_params(cp, device), ae_params(gp, device),
                   ae_params(mu, device), ae_params(nu, device),
                   _tensor(step, device).to(torch.float32))


def rl_state(state, device="cpu") -> RLState:
    """An ``RLState`` (q, counts, buf_actions, buf_rewards, buf_local,
    r_net_prev, t)."""
    q, counts, buf_a, buf_r, buf_l, r_net_prev, t = state
    f32 = torch.float32
    return RLState(_tensor(q, device).to(f32), _tensor(counts, device).to(f32),
                   _tensor(buf_a, device).to(torch.int32),
                   _tensor(buf_r, device).to(f32),
                   _tensor(buf_l, device).to(f32),
                   _tensor(r_net_prev, device).to(f32),
                   _tensor(t, device).to(torch.int32))


def env_state(env, device="cpu") -> EnvState:
    """An ``EnvState`` (positions, fading, rss, available, t)."""
    pos, fade, rss, avail, t = env
    f32 = torch.float32
    return EnvState(_tensor(pos, device).to(f32), _tensor(fade, device).to(f32),
                    _tensor(rss, device).to(f32),
                    _tensor(avail, device).to(torch.bool),
                    _tensor(t, device).to(torch.int32))


def run_state(path: str, ae_cfg, n_segments: int, iters_per_segment: int,
              device="cpu") -> _rs.RunState:
    """A run-state checkpoint written by the JAX package's orchestrator, as
    the port's ``RunState`` (``run_orchestrator(..., resume_from=...)``
    takes it). The archives share one layout, so this is the port's own
    loader, which casts each array to the port's dtype."""
    return _rs.load_run_state(path, ae_cfg, n_segments, iters_per_segment,
                              device=device)
