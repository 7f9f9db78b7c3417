#!/usr/bin/env python3
"""Times one checkout's ``kmeans_assign`` kernel on the card at four shapes.

    python3 tools/kmeans_assign_bench.py [CHECKOUT]

CHECKOUT is the root of a checkout of this repository (default: the one
holding this script); its ``src/repro_torch`` is imported, so two commits
are compared by running the script once on each, in turns, on one card
(parent, change, change, parent). The shapes:

  (a) x (30, 1998, 32), c (30, 3, 32): the main path's Lloyd step
  (b) x (20000, 128), c (10, 128): ``benchmarks/kernel_bench.py``'s shape
  (c) x (30, 1998, 4), c (30, 3, 4): d = n_pca = 4
  (d) x (2, 4096, 1024), c (2, 256, 1024): the Pallas docstring's budget

Each shape is first held against the plain version by this checkout's
``chip_smoke.check_kmeans`` (which raises on a mismatch), then timed with
its ``graph_ms`` three times warm (the same inputs every call, so they sit
in the 50 MB L2) and with its ``cold_graph_ms`` once cold. A shape the
checkout's wrapper refuses is reported as refused. The first line gives the
card's name and power limit and the graph launch floor (a captured
1-element ``zero_()``).
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = {"a": ((30, 1998, 32), (30, 3, 32)), "b": ((20000, 128), (10, 128)),
          "c": ((30, 1998, 4), (30, 3, 4)),
          "d": ((2, 4096, 1024), (2, 256, 1024))}


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(HERE, ".."))
    import torch
    if not torch.cuda.is_available():
        print("kmeans_assign_bench: no CUDA device", file=sys.stderr)
        return 1
    # the timing helpers of this checkout's smoke; the kernel of `root`'s
    sys.path.insert(0, os.path.join(HERE, ".."))
    import chip_smoke as cs
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import kmeans_assign as km
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = os.path.basename(root)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    z = torch.zeros(1, device=dev)
    print(f"{name} [{smi}] graph launch floor {cs.graph_ms(z.zero_):.5f} ms",
          flush=True)
    g = torch.Generator(device=dev).manual_seed(1)
    for label, (xs, cs_) in SHAPES.items():
        x = torch.randn(xs, generator=g, device=dev)
        c = torch.randn(cs_, generator=g, device=dev)
        try:
            cs.check_kmeans(ops, ref, x, c, f"{name} ({label})")
        except ValueError as e:
            print(f"{name} ({label}): refused ({e})", flush=True)
            continue
        warm = [cs.graph_ms(lambda: km.kmeans_assign_cuda(x, c))
                for _ in range(3)]
        cold = cs.cold_graph_ms(km.kmeans_assign_cuda, x, c)
        print(f"{name} ({label}) x {xs} c {cs_}: warm "
              f"{' '.join(f'{w:.5f}' for w in warm)} ms, cold {cold:.5f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
