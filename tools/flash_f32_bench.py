#!/usr/bin/env python3
"""Times builds of the float32 flash kernel (``flash_attention.cu``) on one
GPU at the float32 prefills' attention shapes.

    python3 tools/flash_f32_bench.py [--source PATH ...]

Each ``--source`` is a ``flash_attention.cu`` (default: the repository's,
``src/repro_torch/csrc/flash_attention.cu``); all are built at once with the
port's nvcc flags into ``build/flash_f32_bench/``. To compare a change with
its parent on one card, write the parent's source into the git-ignored
``build/`` first and pass both, parent first:

    git show HEAD:src/repro_torch/csrc/flash_attention.cu > build/parent.cu
    python3 tools/flash_f32_bench.py --source build/parent.cu \\
        --source src/repro_torch/csrc/flash_attention.cu

Prints ptxas's registers and spills for each build, dtype and head_dim,
then the card's name and power limit, then one JSON line per shape: each
build's max abs error against the plain version (``kernels/ref``) and its
device milliseconds per call (``chip_smoke.graph_ms``: calls captured in a
CUDA graph and replayed), timed in turns (A B ... B A), beside two bounds,
max(bytes / 3.35 TB/s, flops / 67 TFLOP/s) on the CUDA cores and
max(bytes / 3.35 TB/s, 3 flops / 495 TFLOP/s) in 3xTF32 on the tensor
cores. The shapes (float32, causal; the flops count the keys each query
sees):

  * llama-3.2-1b (1, 2048, 32/8, 64): phase 5's f32 serve;
  * musicgen (1, 1500, 24, 64): phase 12's f32 route;
  * qwen2-moe (4, 2048, 16, 128): phase 11's f32 route;
  * qwen2-vl (1, 2048, 64/8, 128): phase 12's f32 route;
  * recurrentgemma (4, 4096, 10/1, 256), window 2,048: phase 10's.

They are ``chip_smoke.F32_FLASH``, the shapes phase 2 times; ``--shapes``
picks some of them by name (``--shapes`` with no name times none).

``--scales 1 2 4 8`` then draws q x each scale, so that scores grow (the
tensor cores cut each mma's sum toward zero, a drift that grows with |S|),
at (1, 2048, 8/2, hd) for hd 64, 128 and 256 and at recurrentgemma's
(1, 4096, 10/1, 256) with window 2,048, and prints one JSON line per shape
and scale: the largest |score|, and each build's and the plain version's
largest error as a share of the float32 tolerance 2e-5 + 2e-5 |want|,
against the plain version and against float64 attention
(``chip_smoke.attention_f64``). Needs nvcc and a card; imports nothing of
JAX.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/csrc/flash_attention.cu"
OUT = ROOT / "build/flash_f32_bench"

sys.path.insert(0, str(ROOT))
from chip_smoke import F32_FLASH  # noqa: E402

# name (the label's first word): b, s, h, kv, hd, window (causal, L = S)
SHAPES = {label.split()[0].lower(): shape for label, _, *shape in F32_FLASH}


def ptxas_lines(log):
    """'<dtype> hd N: R registers, <spill line>' per instantiation."""
    out, key, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"flash_attention_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      line)
        if "Compiling entry" in line and m:
            key = ("f32" if m.group(1) == "f" else "bf16") + f" hd {m.group(2)}"
        elif "spill stores" in line and key:
            spill = line.strip()
        elif "Used" in line and key:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{key}: {regs} registers, {spill}")
            key = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a flash_attention.cu to build (repeatable)")
    ap.add_argument("--shapes", nargs="*", choices=list(SHAPES),
                    default=list(SHAPES))
    ap.add_argument("--scales", nargs="*", type=float, default=[],
                    help="q scales for the error study (none by default)")
    args = ap.parse_args()
    sources = args.source or [SOURCE]
    import torch
    if not torch.cuda.is_available():
        print("flash_f32_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False

    OUT.mkdir(parents=True, exist_ok=True)
    names = [f"{i}:{p.name}" for i, p in enumerate(sources)]
    procs = {}
    for name, src in zip(names, sources):
        lib = OUT / f"{name.replace(':', '_')}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    launch = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"{name}: " + "; ".join(ptxas_lines(log)), flush=True)
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.argtypes = fa.KERNEL.argtypes
        fn.restype = ctypes.c_int
        launch[name] = fn

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call(fn, q, k, v, out, window):
        b, s, h, hd = q.shape
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  0, hd, b, s, k.shape[1], h, k.shape[2], *q.stride()[:3],
                  *k.stride()[:3], *v.stride()[:3], 1,
                  -1 if window is None else window, 0, hd ** -0.5, 1,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    for label in args.shapes:
        b, s, h, kv, hd, window = SHAPES[label]
        q = torch.randn((b, s, h, hd), generator=gen, device=dev)
        k, v = (torch.randn((b, s, kv, hd), generator=gen, device=dev)
                for _ in range(2))
        out = torch.empty_like(q)
        want = ref.flash_attention_ref(q, k, v, window=window)
        err = {}
        for name, fn in launch.items():
            out.fill_(float("nan"))
            call(fn, q, k, v, out, window)
            torch.cuda.synchronize()
            err[name] = float((out - want).abs().max())
        del want
        slow = hd == 256
        times = {name: [] for name in launch}
        for name in names + names[::-1]:
            times[name].append(cs.graph_ms(
                lambda: call(launch[name], q, k, v, out, window),
                iters=3 if slow else 10, replays=2 if slow else 3))
        flops, moved = cs.flash_work(b, s, h, kv, hd, window, 4)
        f32_ms, _ = cs.bound(moved, flops, cs.F32_FLOPS_PER_S)
        tf32_ms, _ = cs.bound(moved, 3 * flops, cs.TF32_FLOPS_PER_S)
        print(json.dumps({
            "shape": f"{label} ({b},{s},{h}/{kv},{hd})"
                     + (f" window {window}" if window else ""),
            "gflop": flops / 1e9, "mb": moved / 1e6,
            "bound_f32_ms": f32_ms, "bound_3xtf32_ms": tf32_ms,
            "max_abs_err": err, "ms": times}), flush=True)

    def share(got, want):
        """The largest error as a share of 2e-5 + 2e-5 |want|."""
        return float(((got.double() - want.double()).abs()
                      / (2e-5 + 2e-5 * want.double().abs())).max())

    for b, s, h, kv, hd, window in ((1, 2048, 8, 2, 64, None),
                                    (1, 2048, 8, 2, 128, None),
                                    (1, 2048, 8, 2, 256, None),
                                    (1, 4096, 10, 1, 256, 2048)):
        q0 = torch.randn((b, s, h, hd), generator=gen, device=dev)
        k, v = (torch.randn((b, s, kv, hd), generator=gen, device=dev)
                for _ in range(2))
        out = torch.empty_like(q0)
        for scale in args.scales:
            q = q0 * scale
            plain = ref.flash_attention_ref(q, k, v, window=window)
            truth, top = cs.attention_f64(q, k, v, window)
            shares = {"plain": {"f64": share(plain, truth)}}
            for name, fn in launch.items():
                call(fn, q, k, v, out, window)
                shares[name] = {"plain": share(out, plain),
                                "f64": share(out, truth)}
            print(json.dumps({
                "shape": f"({b},{s},{h}/{kv},{hd})"
                         + (f" window {window}" if window else ""),
                "q_scale": scale, "max_abs_score": top,
                "share_of_tolerance": shares}), flush=True)
            del plain, truth
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
