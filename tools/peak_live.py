#!/usr/bin/env python3
"""Which storages are live at a step's counted peak (``launch.dryrun``'s
``StepCounter`` on meta tensors, no card needed), grouped by the op that
made each.

    PYTHONPATH=src python3 tools/peak_live.py --arch llama3.2-1b \\
        --kind train --batch 4 --seq 2048 [--mesh h100] [--top 12]

Without ``--mesh`` the step runs with ``rules=None``; with ``--mesh`` under
``dryrun.mesh_rules`` of that mesh (``h100`` is the launchers' one-rank
rules). Prints the arguments' bytes, the peak of live bytes above them and
the op that reached it, then the ``--top`` groups of live storages at that
moment: bytes, count, and the making op with its output's shape and dtype.
"""
from __future__ import annotations

import argparse
import collections

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as dr


class PeakProbe(dr.StepCounter):
    """A ``StepCounter`` that notes each storage's making op and keeps the
    live set each time the peak rises."""

    def __init__(self, args):
        super().__init__(args)
        self.origin = {}
        self.op = None
        self.at_peak = {}
        self.peak_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.op = str(func)
        return super().__torch_dispatch__(func, types, args, kwargs)

    def track(self, t) -> None:
        key = dr._storage_key(t)
        if key not in self.live and key not in self.arg_keys:
            self.origin[key] = (self.op, tuple(t.shape),
                                str(t.dtype).split(".")[-1])
        before = self.peak_bytes
        super().track(t)
        if self.peak_bytes > before:
            self.at_peak = {k: (v[0], self.origin.get(k))
                            for k, v in self.live.items()}
            self.peak_op = self.op


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--kind", default="train",
                    choices=("train", "prefill", "decode"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--mesh", default=None, choices=tuple(dr.MESHES))
    ap.add_argument("--top", type=int, default=12)
    a = ap.parse_args(argv)
    shape = InputShape(a.kind, a.seq, a.batch, a.kind)
    rules = dr.mesh_rules(a.mesh) if a.mesh else None
    fn, args = dr.build_step(get_config(a.arch), shape, rules=rules)
    probe = PeakProbe(args)
    with probe:
        out = fn(*args)
    del out
    gib = 2 ** 30
    print(f"{a.arch} {a.kind} {a.batch} x {a.seq}, mesh {a.mesh}: arguments "
          f"{dr.tree_bytes(args) / gib:.3f} GiB, peak {probe.peak_bytes / gib:.3f}"
          f" GiB above them, reached at {probe.peak_op}")
    size, count = collections.Counter(), collections.Counter()
    for nbytes, origin in probe.at_peak.values():
        size[origin] += nbytes
        count[origin] += 1
    for origin, nbytes in size.most_common(a.top):
        print(f"  {nbytes / gib:8.3f} GiB  x{count[origin]:<3d} {origin}")


if __name__ == "__main__":
    main()
