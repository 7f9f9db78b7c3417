"""The stacked, mask-padded client plane (mirrors ``repro.core.batching``).

Per-client arrays are ragged (client i holds n_i samples). The port's unit of
client data is one :class:`ClientData`: a dense ``(N, cap, ...)`` tensor
padded by cyclic tiling, the true ``sizes`` and, optionally, padded labels.
It is built once at the API boundary (:func:`as_client_data`) with one host
to device copy, and every stage works on the stack.

Every stacker takes an optional ``rules`` (:class:`repro_torch.sharding
.ShardingRules`): the stack's data and labels are then placed with their
client axis sharded over the mesh (replicated when N does not divide it),
and ``sizes`` stays whole on every rank (see ``repro_torch.sharding``).
Every rank builds the whole stack from the same lists and keeps its own
rows, so each pads to the global cap, the largest client of all.
``rules=None`` is the single-device identity.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import sharding as sh
from repro_torch.models.common import tree_map


class ClientData(NamedTuple):
    """data:   (N, cap, ...) samples padded to ``cap`` rows by cyclic tiling
               (every padding row is a real sample).
    sizes:  (N,) int64 true per-client sample counts.
    labels: optional (N, cap) labels padded alongside ``data``.

    Rows beyond ``sizes`` are unspecified after an exchange; only
    ``data[i, :sizes[i]]`` is meaningful, which is what :meth:`data_list`
    returns."""
    data: torch.Tensor
    sizes: torch.Tensor
    labels: Optional[torch.Tensor] = None

    @property
    def n_clients(self) -> int:
        return self.data.shape[0]

    @property
    def cap(self) -> int:
        return self.data.shape[1]

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """(N, cap) {0,1} mask selecting each client's real samples."""
        return valid_mask(self.sizes, self.cap, dtype)

    def data_list(self) -> list:
        """Back to the ragged per-client list (exact round trip; a placed
        stack is gathered first)."""
        data = sh.full_tensor(self.data)
        sizes = self.sizes.tolist()
        return [data[i, :sizes[i]] for i in range(self.n_clients)]

    def label_list(self) -> Optional[list]:
        if self.labels is None:
            return None
        labels = sh.full_tensor(self.labels)
        sizes = self.sizes.tolist()
        return [labels[i, :sizes[i]] for i in range(self.n_clients)]

    def to(self, device) -> "ClientData":
        if sh.is_dtensor(self.data):
            if self.data.device_mesh.device_type != torch.device(device).type:
                raise ValueError("a placed ClientData stays on its mesh's "
                                 "device")
            return self
        return ClientData(self.data.to(device), self.sizes.to(device),
                          None if self.labels is None
                          else self.labels.to(device))

    def whole(self, rules=None) -> "ClientData":
        """The stack whole on every rank: a placed stack's data and labels
        gathered in one all-gather (``sharding.gather_clients``); a plain
        stack as it is."""
        return sh.gather_clients(self, rules)


def shard_client_data(cd: ClientData, rules) -> ClientData:
    """Place ``cd``'s data and labels per ``rules``; ``sizes`` stays
    whole. ``rules=None`` is the identity."""
    if rules is None:
        return cd
    return ClientData(sh.shard_clients(cd.data, rules), cd.sizes,
                      sh.shard_clients(cd.labels, rules))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tile_to(arr: np.ndarray, cap: int) -> np.ndarray:
    reps = -(-cap // arr.shape[0])
    return np.tile(arr, (reps,) + (1,) * (arr.ndim - 1))[:cap]


def client_data_from_lists(datasets: Sequence, labels: Optional[Sequence]
                           = None, cap: Optional[int] = None,
                           device="cpu", rules=None) -> ClientData:
    """Build a :class:`ClientData` from ragged per-client arrays (numpy or
    tensors). ``cap`` defaults to the largest client; assembly happens on
    the host, then one copy to ``device``. With ``rules`` each rank tiles
    and copies only its own clients' rows (padded to the global cap)."""
    sizes_np = np.asarray([d.shape[0] for d in datasets], np.int64)
    cap = int(sizes_np.max()) if cap is None else int(cap)
    if cap < int(sizes_np.max()):
        raise ValueError(f"cap={cap} < largest client ({int(sizes_np.max())})")
    part = sh.ClientSlice(rules, len(datasets))
    mine = range(part.lo, part.hi)
    data = np.stack([_tile_to(_host(datasets[i]), cap) for i in mine])
    lab = None
    if labels is not None:
        lab = torch.as_tensor(
            np.stack([_tile_to(_host(labels[i]), cap) for i in mine]),
            device=device)
    return ClientData(part.place(torch.as_tensor(data, device=device)),
                      torch.as_tensor(sizes_np, device=device),
                      part.place(lab))


def as_client_data(datasets, labels=None, cap: Optional[int] = None,
                   device="cpu", rules=None) -> ClientData:
    """The API-boundary conversion: a :class:`ClientData` passes through
    (moved to ``device`` and placed per ``rules``; ``labels``/``cap`` must
    then be unset), a ragged list converts exactly once."""
    if isinstance(datasets, ClientData):
        if labels is not None or cap is not None:
            raise ValueError("labels/cap only apply when converting lists; "
                             "a ClientData already carries both")
        return shard_client_data(datasets.to(device), rules)
    return client_data_from_lists(datasets, labels, cap, device, rules)


def stack_clients(datasets: Sequence, device="cpu", rules=None):
    """Pad per-client arrays to a common length by cyclic tiling; returns
    ``(data, sizes)`` (the reference's lower-level stacker)."""
    cd = client_data_from_lists(datasets, device=device, rules=rules)
    return cd.data, cd.sizes


def valid_mask(sizes, max_n: int, dtype=torch.float32,
               rules=None) -> torch.Tensor:
    """(N,) sizes -> (N, max_n) mask selecting each client's real samples,
    placed per ``rules``."""
    sizes = torch.as_tensor(sizes)
    mask = (torch.arange(max_n, device=sizes.device)[None, :]
            < sizes[:, None]).to(dtype)
    return sh.shard_clients(mask, rules)


def stack_pytrees(trees: Sequence, rules=None):
    """[tree_0, ..., tree_{N-1}] -> one tree with a leading client axis,
    placed per ``rules``."""
    return sh.shard_clients(tree_map(lambda *xs: torch.stack(xs), *trees),
                            rules)


def unstack_pytree(tree, n: int) -> list:
    """Inverse of :func:`stack_pytrees`."""
    return [tree_map(lambda x: x[i], tree) for i in range(n)]
