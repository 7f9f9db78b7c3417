"""Meshes (mirrors ``repro.launch.mesh``).

Functions, not module constants, so importing this module initialises no
process group. The production meshes are the reference's TPU pod layouts,
kept as shapes for specs and the dry run: (data=16, model=16) for one pod,
(pod=2, data=16, model=16) for two. The client plane runs on a live
``DeviceMesh`` with one "data" dimension over the process group's ranks.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The reference's production mesh as a shape (``ShardingRules`` takes
    it for specs; nothing is placed on it)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def _ensure_group(size: int, device) -> torch.device:
    """The default process group, made here as a one-rank group over a
    ``HashStore`` when none exists and ``size`` is 1 (no port, no network):
    NCCL on the card, gloo only when the caller asks for the CPU. Returns
    the device type's torch device."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a {size}-rank mesh needs a process group; call "
                "torch.distributed.init_process_group first")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    backend = dist.get_backend()
    if dev.type == "cuda" and "nccl" not in backend:
        raise RuntimeError(f"a card mesh needs NCCL; the group is {backend}")
    if dev.type == "cpu" and "gloo" not in backend:
        raise RuntimeError(f"a host mesh needs gloo; the group is {backend}")
    return dev


def make_client_mesh(data=None, device="cuda"):
    """1-D ("data",) mesh for the federation path, over ``data`` ranks
    (default: the process group's size). On the card unless ``device``
    says otherwise; without a card it raises, and it never falls back to
    gloo on the host."""
    from torch.distributed.device_mesh import init_device_mesh
    size = data if data is not None else \
        (dist.get_world_size() if dist.is_initialized() else 1)
    dev = _ensure_group(size, device)
    if dist.get_world_size() != size:
        raise ValueError(f"a {size}-rank mesh on a "
                         f"{dist.get_world_size()}-rank process group")
    return init_device_mesh(dev.type, (size,), mesh_dim_names=("data",))


def make_host_mesh(model: int = 1, device="cuda"):
    """(data, model) mesh over the process group's ranks, ``model`` of them
    on the model axis; a one-rank group is made as for
    :func:`make_client_mesh`."""
    from torch.distributed.device_mesh import init_device_mesh
    size = dist.get_world_size() if dist.is_initialized() else 1
    dev = _ensure_group(size, device)
    return init_device_mesh(dev.type, (size // model, model),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def host_rules(device="cuda"):
    """``ShardingRules.default`` over :func:`make_host_mesh` (the launchers'
    mesh, as the reference's ``make_host_mesh`` plus
    ``ShardingRules.default``). A one-rank group made here is destroyed on
    exit; a group the caller made stays."""
    from repro_torch.sharding import ShardingRules
    made = not dist.is_initialized()
    try:
        yield ShardingRules.default(make_host_mesh(device=device))
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
