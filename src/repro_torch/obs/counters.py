"""The port's counters: kernel-library loads and host transfers, observable.

The same three numbers as the JAX package's counters, so a manifest has the
same fields on both sides (:func:`snapshot` returns ``(compiles,
transfers, bytes_fetched)``):

**Transfers.** :func:`device_get` is the port's one counted device-to-host
copy: it returns ``tensor.cpu().numpy()`` and, while tracing is on, adds
one call and the bytes that crossed. The online orchestrator reads every
segment's deferred metrics through it exactly once per run
(``dynamics/orchestrator._read_all``), so "one host transfer per run" is a
regression test. Scope, as in the reference: only this entry point is
counted. Other host reads (``.cpu()``, ``int()`` or ``bool()`` of a device
scalar: the host reserve selector's cluster ids, the failed-link mask, the
scan engine's boundary reads) are separate sync points and deliberately out
of scope, because the contract under test is about the metrics transfer.
``_read_all`` packs every metric into one float64 vector before the copy,
so its ``bytes_fetched`` is 8 bytes per value, where the reference counts
each array in its own dtype (4 bytes for its float32 and int32 values).

**Compiles.** The port has no ``jit``: what it builds or loads at first
use is its kernel libraries (``kernels/_build.CudaKernel.function``: an
``nvcc`` build when the library is not cached, then a ``ctypes`` load).
Each library's first load in a process counts as one compile
(:func:`count_compile`). CUDA-graph captures and ``torch.compile`` will
count here once the compiled-steps work adds them; nothing else does.

Both counters only count while :func:`set_active` is on (the tracer turns
it on and off), so a run that never enables observability pays one flag
check per library load and per ``device_get``. Unlike the reference, which
wraps ``jax.device_get`` and registers a monitoring listener at the first
trace, the port has nothing to install: the counted entry points are its
own, so neither importing nor tracing touches global torch state.
"""
from __future__ import annotations

import gc
from typing import Tuple

import numpy as np
import torch

__all__ = ["set_active", "snapshot", "live_memory", "device_get",
           "count_compile"]

_active = False
_n_compiles = 0
_n_transfers = 0
_bytes_fetched = 0


def set_active(on: bool) -> None:
    global _active
    _active = bool(on)


def snapshot() -> Tuple[int, int, int]:
    """(n_compiles, n_transfers, bytes_fetched) since the process started
    counting: deltas between snapshots attribute the counts to a window
    (a span)."""
    return _n_compiles, _n_transfers, _bytes_fetched


def device_get(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` on the host as a numpy array: one counted transfer of
    ``tensor.nbytes`` bytes while counting is on."""
    global _n_transfers, _bytes_fetched
    if _active:
        _n_transfers += 1
        _bytes_fetched += tensor.numel() * tensor.element_size()
    return tensor.cpu().numpy()


def count_compile() -> None:
    """One kernel library loaded for the first time in this process."""
    global _n_compiles
    if _active:
        _n_compiles += 1


def live_memory() -> Tuple[int, int]:
    """(count, bytes) of live device memory. On the card, the caching
    allocator's active blocks and allocated bytes; without one, a walk of
    the live tensors (O(objects), so the tracer only calls it when
    ``REPRO_OBS_MEM`` opts in; diagnosis only)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        return (int(stats.get("active.all.current", 0)),
                int(stats.get("allocated_bytes.all.current", 0)))
    tensors = [o for o in gc.get_objects() if _is_tensor(o)]
    return len(tensors), sum(t.numel() * t.element_size() for t in tensors)


def _is_tensor(obj) -> bool:
    try:
        return isinstance(obj, torch.Tensor)
    except ReferenceError:        # a weak proxy whose referent is gone
        return False
