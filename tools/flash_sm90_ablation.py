#!/usr/bin/env python3
"""Where the time of the tensor-core flash kernel goes, on one GPU.

    python3 tools/flash_sm90_ablation.py

Builds ``src/repro_torch/csrc/flash_attention_sm90.cu`` as it is and in
variants that each take one piece of work out of it, then times them in
turns (A B ... B A, CUDA events, 30 calls each) at the served prefill's
shape and at a Llama-3.2-3B-like head_dim-128 shape. Only ``kernel`` is
correct; the others are timing probes whose output is garbage:

  * ``no_p_lo``: one P.V product on bf16(p) instead of two (p_hi + p_lo);
  * ``no_exp2``: the softmax without its exp2 (the SFU's share);
  * ``no_softmax``: no softmax at all, S is packed to bf16 and fed to P.V
    (the share of the softmax's ALU work, which waits on and is waited on
    by the wgmmas of its warpgroup);
  * ``stages_3``: a K/V ring of 3 stages instead of 2.

Prints the card's name and power limit, then one JSON line per shape with
each variant's milliseconds per call. Needs nvcc and a card; imports nothing
of JAX.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/csrc/flash_attention_sm90.cu"
OUT = ROOT / "build/ablation"

SOFTMAX_EXP = ("    const float e0 = ex2(fmaf(s[i], scale_log2, -mx[r]));\n"
               "    const float e1 = ex2(fmaf(s[i + 1], scale_log2, -mx[r]));")
SOFTMAX_BODY_START = "  float mx[2] = {-INFINITY, -INFINITY};\n"
SOFTMAX_END = "\n}\n\n// One consumer warpgroup:"


def variants(src):
    """The source and its ablations; each replacement must match once."""
    def sub(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"ablation anchor not found once: {old[:60]!r}")
        return text.replace(old, new)

    start = src.index(SOFTMAX_BODY_START)
    end = src.index(SOFTMAX_END)
    no_softmax = (src[:start] + "  alpha[0] = alpha[1] = 1.f;\n"
                  "#pragma unroll\n  for (int i = 0; i < NS; i += 2)\n"
                  "    p_hi[i / 2] = p_lo[i / 2] = pack_bf16(s[i], s[i + 1]);"
                  + src[end:])
    return {
        "kernel": src,
        "no_p_lo": sub(src, "        mma_pv<HD>(o, a_lo, db);\n", ""),
        "no_exp2": sub(src, SOFTMAX_EXP, SOFTMAX_EXP.replace("ex2(", "(")),
        "no_softmax": no_softmax,
        "stages_3": sub(src, "constexpr int kStages = 2;",
                        "constexpr int kStages = 3;"),
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_sm90_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(SOURCE.read_text()).items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    launch = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_sm90_launch
        fn.argtypes = fa.KERNEL_SM90.argtypes
        fn.restype = ctypes.c_int
        launch[name] = fn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call(fn, q, k, v, out):
        b, s, h, hd = q.shape
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  hd, b, s, k.shape[1], h, k.shape[2], *q.stride()[:3],
                  *k.stride()[:3], *v.stride()[:3], 1, -1, 0,
                  hd ** -0.5, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")

    def ms(fn, args, iters=30):
        for _ in range(3):
            call(fn, *args)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call(fn, *args)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    shapes = {"served (4,2048,32,64) Kv 8": (4, 2048, 32, 8, 64),
              "3B-like (1,2048,24,128) Kv 8": (1, 2048, 24, 8, 128)}
    for label, (b, s, h, kv, hd) in shapes.items():
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, s, kv, hd), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        args = (q, k, v, torch.empty_like(q))
        order = list(launch) + list(reversed(list(launch)))
        times = {name: [] for name in launch}
        for name in order:
            times[name].append(ms(launch[name], args))
        print(json.dumps({"shape": label, "causal": True, "ms": times}),
              flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
