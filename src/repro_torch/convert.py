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
from repro_torch.fl.trainer import FLCarry
from repro_torch.models.common import tree_map


def _tensor(a, device):
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":   # numpy's bf16 extension type: widen
        return torch.as_tensor(a.astype(np.float32),    # exactly, then narrow
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(a, device=device)


def lm_params(tree, device="cpu") -> dict:
    """A transformer's parameter tree ({"embed", "scan": (...), "tail":
    (...), "final_norm", "head"}); the layouts match, so this is a copy."""
    return tree_map(lambda a: _tensor(a, device), tree)


def lm_cache(cache, device="cpu") -> dict:
    """A prefill/decode cache {"pos", "scan", "tail"} with its K/V ring
    buffers; ``pos`` becomes a Python int."""
    return {"pos": int(np.asarray(cache["pos"])),
            "scan": tree_map(lambda a: _tensor(a, device), cache["scan"]),
            "tail": tree_map(lambda a: _tensor(a, device), cache["tail"])}


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
