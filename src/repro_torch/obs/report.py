"""Per-phase breakdown of an obs run manifest (the port's reader; the JAX
package's ``tools/trace_report.py`` reads the same files).

    PYTHONPATH=src python -m repro_torch.obs.report runs/obs/chip_online.jsonl

Reads an ``obs-manifest/v1`` JSONL (see :mod:`repro_torch.obs.manifest`),
written by either package, and prints one row per span name: call count,
total / mean wall time, *self* time (total minus time inside named child
spans: the number that sums cleanly across the tree), share of the run's
wall clock, and the compile and transfer counts attributed to the phase.

Span events carry (close order, depth) instead of parent indices: children
close before their parent, so the parent of event ``i`` is the nearest
*later* event with a smaller depth; :func:`assign_parents` rebuilds the
tree from that invariant.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

from repro_torch.obs.manifest import read_manifest


def assign_parents(spans: List[dict]) -> List[Optional[int]]:
    """Parent index per span (events in manifest/close order), rebuilt from
    the close-order + depth invariant; None for top-level spans."""
    parents: List[Optional[int]] = [None] * len(spans)
    # A stack sweep in reverse order: walking backwards, a parent precedes
    # its children, so the nearest previous-in-reverse event with a smaller
    # depth is the parent (the nearest later event, read forwards).
    stack: List[int] = []   # indices with strictly increasing depth
    for i in range(len(spans) - 1, -1, -1):
        d = spans[i]["depth"]
        while stack and spans[stack[-1]]["depth"] >= d:
            stack.pop()
        parents[i] = stack[-1] if stack else None
        stack.append(i)
    return parents


def self_times(spans: List[dict], parents: List[Optional[int]]) -> List[float]:
    """dur minus the dur of *direct* children: exclusive per-span time."""
    self_t = [s["dur"] for s in spans]
    for i, p in enumerate(parents):
        if p is not None:
            self_t[p] -= spans[i]["dur"]
    return self_t


def phase_table(spans: List[dict]) -> List[dict]:
    """Aggregate spans by name into report rows (sorted by total desc)."""
    parents = assign_parents(spans)
    self_t = self_times(spans, parents)
    rows = {}
    for s, st in zip(spans, self_t):
        r = rows.setdefault(s["name"], {
            "phase": s["name"], "count": 0, "total": 0.0, "self": 0.0,
            "compiles": 0, "transfers": 0})
        r["count"] += 1
        r["total"] += s["dur"]
        r["self"] += st
        r["compiles"] += s["compiles"]
        r["transfers"] += s["transfers"]
    out = sorted(rows.values(), key=lambda r: -r["total"])
    for r in out:
        r["mean"] = r["total"] / r["count"]
    return out


def run_wall(man: dict) -> float:
    """Run duration: the end line's wall clock, else the span envelope."""
    if man["end"] is not None:
        return float(man["end"]["wall"])
    spans = man["spans"]
    if not spans:
        return 0.0
    return max(s["t0"] + s["dur"] for s in spans) - \
        min(s["t0"] for s in spans)


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if abs(b) < 1024 or unit == "GB":
            return f"{b:.1f} {unit}" if unit != "B" else f"{int(b)} B"
        b /= 1024
    return f"{b:.1f} GB"


def _runtime(hdr: dict) -> str:
    """The header's framework and device, from either package's header."""
    if "torch_version" in hdr:
        dev = hdr.get("device_name") or hdr.get("backend")
        return (f"torch {hdr['torch_version']} {hdr.get('backend')} "
                f"x{hdr.get('device_count')} ({dev})")
    return (f"jax {hdr.get('jax_version')} {hdr.get('backend')} "
            f"x{hdr.get('device_count')}")


def report(path: str, top: Optional[int] = None) -> str:
    man = read_manifest(path)
    hdr = man["run"]
    wall = run_wall(man)
    lines = [f"manifest: {path}"]
    mesh = hdr.get("mesh")
    lines.append(f"run: {hdr.get('timestamp')}  {_runtime(hdr)}"
                 + (f"  mesh={mesh}" if mesh else ""))
    if hdr.get("meta"):
        lines.append("meta: " + json.dumps(hdr["meta"], sort_keys=True))
    lines.append("")

    rows = phase_table(man["spans"])
    if top:
        rows = rows[:top]
    n_chunks = sum(1 for s in man["spans"] if s["name"] == "scan-chunk")
    if n_chunks:
        lines.append(
            f"scan run: {n_chunks} scan-chunk span(s) run the segments "
            "after the first in chunks with no named span inside; the "
            "per-phase rows below attribute only the eager segment 0 and "
            "the chunk-boundary host work, and everything inside a chunk "
            "lands in its scan-chunk row.")
        lines.append("")
    head = (f"{'phase':<24}{'count':>6}{'total_s':>10}{'mean_ms':>10}"
            f"{'self_s':>9}{'%run':>7}{'compiles':>9}{'transfers':>10}")
    lines.append(head)
    lines.append("-" * len(head))
    for r in rows:
        pct = 100.0 * r["total"] / wall if wall > 0 else 0.0
        lines.append(
            f"{r['phase']:<24}{r['count']:>6}{r['total']:>10.3f}"
            f"{r['mean'] * 1e3:>10.1f}{r['self']:>9.3f}{pct:>7.1f}"
            f"{r['compiles']:>9}{r['transfers']:>10}")
    lines.append("")
    end = man["end"]
    if end is not None:
        lines.append(
            f"run wall: {wall:.3f} s; compiles {end['compiles']}; "
            f"transfers {end['transfers']} "
            f"({_fmt_bytes(end['bytes_fetched'])})")
    else:
        lines.append(f"span envelope: {wall:.3f} s (no end line: "
                     "the run did not finalise)")
    for m in man["marks"]:
        lines.append("mark: " + json.dumps(m, sort_keys=True))
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="per-phase breakdown of an obs run manifest")
    ap.add_argument("manifest", help="path to a *.jsonl obs manifest")
    ap.add_argument("--top", type=int, default=None,
                    help="show only the N most expensive phases")
    args = ap.parse_args(argv)
    print(report(args.manifest, top=args.top))


if __name__ == "__main__":
    main()
