"""Orchestrator run-state checkpointing (mirrors ``repro.dynamics.runstate``;
the archives have the same key set, so one written by the JAX package loads
here, see ``convert.run_state``).

One :class:`RunState` captures the full cross-segment state of
``run_orchestrator`` at a segment boundary: the draw source's identity (the
``key``), the environment, the client data stack, trust, the graph (current
and previous edge), the warm RL state, the FL carry, the retry queue, and
every completed segment's metrics (dev values materialised).
:func:`save_run_state` lays it out as one flat atomic npz through
:mod:`repro_torch.checkpoint.store`; :func:`load_run_state` rebuilds it on
the run's device.

A run killed at a segment boundary and resumed from its checkpoint ends
bit-identical to the uninterrupted run: every draw is derived from the
source's identity and a (site, index), never from a stateful generator;
every stored array is f32/int/bool, which npz round-trips exactly; and the
completed segments' metrics are stored already materialised.

Array shapes are run-time quantities (data cap, eval-curve lengths, retry
queue depth), so loading reads the whole archive with
:func:`~repro_torch.checkpoint.store.load_flat`; only the parameter trees,
whose structure follows from ``AEConfig``, go through the shape-checked
:func:`~repro_torch.checkpoint.store.restore_subtree`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import (load_flat, restore_subtree,
                                          save_pytree)
from repro_torch.core import qlearning as ql
from repro_torch.core.batching import ClientData
from repro_torch.dynamics.environment import EnvState
from repro_torch.dynamics.metrics import PendingSegment
from repro_torch.faults.retry import RetryQueue
from repro_torch.fl.trainer import FLCarry
from repro_torch.models import autoencoder as ae
from repro_torch.models.common import tree_map

_VERSION = 1

# the deferred metrics every segment carries (PendingSegment.dev); fixed so
# checkpoints have a stable, checkable key set
DEV_KEYS = ("eval_loss", "in_edge", "link_churn", "mean_pfail",
            "expected_delivery", "n_available", "moved", "realized",
            "eval_curve", "n_live", "n_failed")

# the port's dtype of each state array (a JAX-written archive stores int32
# where the port indexes with int64)
_ENV_DTYPES = {"positions": torch.float32, "fading": torch.float32,
               "rss": torch.float32, "available": torch.bool,
               "t": torch.int32}
_RL_DTYPES = {"q": torch.float32, "counts": torch.float32,
              "buf_actions": torch.int32, "buf_rewards": torch.float32,
              "buf_local": torch.float32, "r_net_prev": torch.float32,
              "t": torch.int32}


@dataclasses.dataclass
class RunState:
    """Cross-segment orchestrator state at the end of segment ``segment``."""
    segment: int                     # last completed segment
    key: np.ndarray                  # the draw source's identity
    env: EnvState
    cd: ClientData
    trust: torch.Tensor              # (N_tx, N_rx, k) int8
    in_edge: torch.Tensor
    prev_edge: Optional[torch.Tensor]
    p_fail: torch.Tensor
    rl_state: Optional[ql.RLState]
    carry: FLCarry
    retry: RetryQueue
    pending: List[PendingSegment]


def save_run_state(path: str, rs: RunState, n_segments: int,
                   iters_per_segment: int) -> None:
    """Atomically persist ``rs`` with the run geometry, so a resume under
    another config fails loudly instead of diverging silently."""
    tree = {
        "meta": {
            "version": _VERSION,
            "segment": rs.segment,
            "n_segments": n_segments,
            "iters_per_segment": iters_per_segment,
            "n_trust": len(rs.trust),
            "n_pending": len(rs.pending),
            "has_labels": int(rs.cd.labels is not None),
            "has_prev_edge": int(rs.prev_edge is not None),
            "has_rl": int(rs.rl_state is not None),
        },
        "key": np.asarray(rs.key),
        "env": dict(zip(EnvState._fields, rs.env)),
        "cd": {"data": rs.cd.data, "sizes": rs.cd.sizes},
        "trust": {str(i): t for i, t in enumerate(rs.trust)},
        "in_edge": rs.in_edge,
        "p_fail": rs.p_fail,
        "carry": dict(zip(FLCarry._fields, rs.carry)),
        "retry": rs.retry.to_array(),
        "pending": {str(i): _pending_tree(p)
                    for i, p in enumerate(rs.pending)},
    }
    if rs.cd.labels is not None:
        tree["cd"]["labels"] = rs.cd.labels
    if rs.prev_edge is not None:
        tree["prev_edge"] = rs.prev_edge
    if rs.rl_state is not None:
        tree["rl"] = dict(zip(ql.RLState._fields, rs.rl_state))
    save_pytree(path, tree)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _pending_tree(p: PendingSegment) -> dict:
    return {
        "segment": p.segment,
        "rediscovered": int(p.rediscovered),
        "sampled": int(p.sampled),
        # NaN = None (a realized rate is in [0, 1], NaN is unreachable)
        "host_realized": np.float64(np.nan if p.host_realized is None
                                    else p.host_realized),
        "eval_iters": np.asarray(p.eval_iters),
        "retried": p.retried,
        "retry_delivered": p.retry_delivered,
        "dev": {k: _host(p.dev[k]) for k in DEV_KEYS},
    }


def _params_like(ae_cfg, n: int):
    """Meta-tensor references for the FL carry's parameter trees: global
    (one model) and client-stacked (leading N axis)."""
    specs = ae.ae_specs(ae_cfg)
    g = tree_map(lambda s: torch.empty(s.shape, device="meta"), specs)
    stacked = tree_map(lambda s: torch.empty((n,) + tuple(s.shape),
                                             device="meta"), specs)
    return g, stacked


def load_run_state(path: str, ae_cfg, n_segments: int,
                   iters_per_segment: int, device="cpu") -> RunState:
    """Rebuild a :class:`RunState` on ``device`` from
    :func:`save_run_state`'s archive (or the JAX package's).

    Raises ``ValueError`` on a corrupt or truncated archive, on a
    checkpoint from another run geometry and on parameter-shape drift
    against ``ae_cfg``."""
    flat = load_flat(path)
    version = int(flat["meta/version"])
    if version != _VERSION:
        raise ValueError(f"checkpoint {path!r} has version {version}, "
                         f"this runtime reads version {_VERSION}")
    for name, want in (("n_segments", n_segments),
                       ("iters_per_segment", iters_per_segment)):
        got = int(flat[f"meta/{name}"])
        if got != want:
            raise ValueError(
                f"checkpoint {path!r} was written by a run with "
                f"{name}={got}, resuming with {name}={want} would diverge")

    def t(key, dtype=None):
        out = torch.as_tensor(np.array(flat[key], copy=True), device=device)
        return out if dtype is None else out.to(dtype)

    env = EnvState(*(t(f"env/{f}", _ENV_DTYPES[f])
                     for f in EnvState._fields))
    labels = t("cd/labels") if int(flat["meta/has_labels"]) else None
    cd = ClientData(t("cd/data", torch.float32), t("cd/sizes", torch.int64),
                    labels)
    trust = torch.stack([t(f"trust/{i}", torch.int8)
                         for i in range(int(flat["meta/n_trust"]))])

    rl_state = None
    if int(flat["meta/has_rl"]):
        rl_state = ql.RLState(*(t(f"rl/{f}", _RL_DTYPES[f])
                                for f in ql.RLState._fields))

    g_like, c_like = _params_like(ae_cfg, cd.n_clients)
    carry = FLCarry(
        client_params=restore_subtree(flat, "carry/client_params", c_like,
                                      device),
        global_params=restore_subtree(flat, "carry/global_params", g_like,
                                      device),
        mu=restore_subtree(flat, "carry/mu", c_like, device),
        nu=restore_subtree(flat, "carry/nu", c_like, device),
        step=t("carry/step", torch.float32))

    pending = []
    for i in range(int(flat["meta/n_pending"])):
        pre = f"pending/{i}"
        hr = float(flat[f"{pre}/host_realized"])
        pending.append(PendingSegment(
            segment=int(flat[f"{pre}/segment"]),
            rediscovered=bool(int(flat[f"{pre}/rediscovered"])),
            sampled=bool(int(flat[f"{pre}/sampled"])),
            host_realized=None if np.isnan(hr) else hr,
            eval_iters=flat[f"{pre}/eval_iters"],
            # host values: the final metrics read passes them through
            # unchanged, replaying the completed segments' records
            dev={k: flat[f"{pre}/dev/{k}"] for k in DEV_KEYS},
            retried=int(flat[f"{pre}/retried"]),
            retry_delivered=int(flat[f"{pre}/retry_delivered"])))

    return RunState(
        segment=int(flat["meta/segment"]),
        key=flat["key"],
        env=env, cd=cd, trust=trust,
        in_edge=t("in_edge", torch.int64),
        prev_edge=(t("prev_edge", torch.int64)
                   if int(flat["meta/has_prev_edge"]) else None),
        p_fail=t("p_fail", torch.float32),
        rl_state=rl_state, carry=carry,
        retry=RetryQueue.from_array(flat["retry"]),
        pending=pending)
