"""The stacked, mask-padded client plane (mirrors ``repro.core.batching``).

Per-client arrays are ragged (client i holds n_i samples). The port's unit of
client data is one :class:`ClientData`: a dense ``(N, cap, ...)`` tensor
padded by cyclic tiling, the true ``sizes`` and, optionally, padded labels.
It is built once at the API boundary (:func:`as_client_data`) with one host
to device copy, and every stage works on the stack.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

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
        """Back to the ragged per-client list (exact round trip)."""
        sizes = self.sizes.tolist()
        return [self.data[i, :sizes[i]] for i in range(self.n_clients)]

    def label_list(self) -> Optional[list]:
        if self.labels is None:
            return None
        sizes = self.sizes.tolist()
        return [self.labels[i, :sizes[i]] for i in range(self.n_clients)]

    def to(self, device) -> "ClientData":
        return ClientData(self.data.to(device), self.sizes.to(device),
                          None if self.labels is None
                          else self.labels.to(device))


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _tile_to(arr: np.ndarray, cap: int) -> np.ndarray:
    reps = -(-cap // arr.shape[0])
    return np.tile(arr, (reps,) + (1,) * (arr.ndim - 1))[:cap]


def client_data_from_lists(datasets: Sequence, labels: Optional[Sequence]
                           = None, cap: Optional[int] = None,
                           device="cpu") -> ClientData:
    """Build a :class:`ClientData` from ragged per-client arrays (numpy or
    tensors). ``cap`` defaults to the largest client; assembly happens on
    the host, then one copy to ``device``."""
    sizes_np = np.asarray([d.shape[0] for d in datasets], np.int64)
    cap = int(sizes_np.max()) if cap is None else int(cap)
    if cap < int(sizes_np.max()):
        raise ValueError(f"cap={cap} < largest client ({int(sizes_np.max())})")
    data = np.stack([_tile_to(_host(d), cap) for d in datasets])
    lab = None
    if labels is not None:
        lab = torch.as_tensor(
            np.stack([_tile_to(_host(l), cap) for l in labels]),
            device=device)
    return ClientData(torch.as_tensor(data, device=device),
                      torch.as_tensor(sizes_np, device=device), lab)


def as_client_data(datasets, labels=None, cap: Optional[int] = None,
                   device="cpu") -> ClientData:
    """The API-boundary conversion: a :class:`ClientData` passes through
    (moved to ``device``; ``labels``/``cap`` must then be unset), a ragged
    list converts exactly once."""
    if isinstance(datasets, ClientData):
        if labels is not None or cap is not None:
            raise ValueError("labels/cap only apply when converting lists; "
                             "a ClientData already carries both")
        return datasets.to(device)
    return client_data_from_lists(datasets, labels, cap, device)


def valid_mask(sizes, max_n: int, dtype=torch.float32) -> torch.Tensor:
    """(N,) sizes -> (N, max_n) mask selecting each client's real samples."""
    sizes = torch.as_tensor(sizes)
    return (torch.arange(max_n, device=sizes.device)[None, :]
            < sizes[:, None]).to(dtype)


def stack_pytrees(trees: Sequence):
    """[tree_0, ..., tree_{N-1}] -> one tree with a leading client axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_pytree(tree, n: int) -> list:
    """Inverse of :func:`stack_pytrees`."""
    return [tree_map(lambda x: x[i], tree) for i in range(n)]
