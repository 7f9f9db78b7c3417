"""Structured JSONL run manifests: one event per line, machine-diffable.

A manifest is the durable form of one traced run, landing under ``runs/``
(``chip_smoke.py`` writes ``runs/obs/``). Line protocol (schema
``obs-manifest/v1``, the JAX package's, so each side's reader reads the
other side's files):

  * ``{"type": "run", ...}``   header: schema, wall-clock timestamp, torch
    version, backend (the device type, ``"cuda"`` or ``"cpu"``), device
    count, the card's name when there is one, the mesh shape of the
    ``rules`` the run was traced under (``null`` without) and
    caller-supplied ``meta``.
  * ``{"type": "span", ...}``  one per closed span, streamed as the run
    progresses (a crashed run keeps every span closed before the crash);
    fields as in :class:`repro_torch.obs.tracer.SpanEvent.to_dict`.
  * ``{"type": "mark", ...}``  an annotation (``obs.mark``).
  * ``{"type": "end", ...}``   totals: wall seconds, compiles, transfers,
    bytes fetched.

:mod:`repro_torch.obs.report` renders a per-phase table from a manifest;
``read_manifest`` here is the parsing half it builds on.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.sharding import _mesh_shape

SCHEMA = "obs-manifest/v1"

__all__ = ["SCHEMA", "ManifestWriter", "read_manifest"]


def _mesh_desc(rules) -> Optional[dict]:
    """{axis: size} of a ``ShardingRules``' mesh (or of a ``DeviceMesh`` or
    shape mapping given directly), as the reference's header has it."""
    mesh = getattr(rules, "mesh", rules)
    if mesh is None:
        return None
    return _mesh_shape(mesh) or None


class ManifestWriter:
    """Streams one run's events to a JSONL file; close writes the totals."""

    def __init__(self, path: str, meta: Optional[dict] = None, rules=None):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._t0 = time.perf_counter()
        self._compiles = 0
        self._transfers = 0
        self._bytes = 0
        self._f = open(path, "w")
        cuda = torch.cuda.is_available()
        header = {
            "type": "run",
            "schema": SCHEMA,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "torch_version": torch.__version__,
            "backend": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 1,
            "mesh": _mesh_desc(rules),
            "meta": meta or {},
        }
        if cuda:
            header["device_name"] = torch.cuda.get_device_name()
        self._emit(header)

    def _emit(self, obj: Dict[str, Any]) -> None:
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def on_span(self, ev) -> None:
        """Tracer close hook: append one span line and fold the totals.
        Only top-level spans fold in: a parent's counters already include
        its children, so counting every depth would double-count."""
        if ev.depth == 0:
            self._compiles += ev.compiles
            self._transfers += ev.transfers
            self._bytes += ev.bytes_fetched
        self._emit(ev.to_dict())

    def mark(self, name: str, **fields) -> None:
        """A non-span annotation line (e.g. a retry outcome)."""
        self._emit({"type": "mark", "name": name, **fields})

    def close(self) -> None:
        if self._f.closed:
            return
        self._emit({
            "type": "end",
            "wall": time.perf_counter() - self._t0,
            "compiles": self._compiles,
            "transfers": self._transfers,
            "bytes_fetched": self._bytes,
        })
        self._f.close()


def read_manifest(path: str) -> Dict[str, Any]:
    """Parse a manifest: ``{"run": header, "spans": [...], "marks": [...],
    "end": totals-or-None}``. Raises on a missing or invalid header so
    callers fail loudly on a file that is not a manifest."""
    run = None
    spans: List[dict] = []
    marks: List[dict] = []
    end = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            t = obj.get("type")
            if t == "run":
                if obj.get("schema") != SCHEMA:
                    raise ValueError(
                        f"{path}: unsupported manifest schema "
                        f"{obj.get('schema')!r} (expected {SCHEMA})")
                run = obj
            elif t == "span":
                spans.append(obj)
            elif t == "mark":
                marks.append(obj)
            elif t == "end":
                end = obj
    if run is None:
        raise ValueError(f"{path}: no run header: not an obs manifest")
    return {"run": run, "spans": spans, "marks": marks, "end": end}
