#!/usr/bin/env python3
"""Where the time of the tensor-core flash kernel goes, on one GPU.

    python3 tools/flash_sm90_ablation.py

Builds ``src/repro_torch/csrc/flash_attention_sm90.cu`` as it is and in
variants that each take one piece of work out of it, then times them in
turns (A B ... B A, CUDA events, 30 calls each) at the served prefill's
shape, at a Llama-3.2-3B-like head_dim-128 shape and at recurrentgemma-2b's
local attention (head_dim 256, MQA, window 2,048). Only ``kernel`` is
correct; the others are timing probes whose output is garbage:

  * ``no_p_lo``: one P.V product on bf16(p) instead of two (p_hi + p_lo);
  * ``no_exp2``: the softmax without its exp2 (the SFU's share);
  * ``no_softmax``: no softmax at all, S is packed to bf16 and fed to P.V
    (the share of the softmax's ALU work, which waits on and is waited on
    by the wgmmas of its warpgroup);
  * ``stages_3``: a K/V ring of 3 stages instead of 2 (not at head_dim
    256, whose 3 stages would not fit in shared memory);
  * ``loads_only``: every KV tile loaded and released, none computed (the
    time the TMA ring alone takes: L2 and device-memory traffic);
  * ``producer_warp``: head_dim 256 with the producer warp of head_dim 64
    and 128 (288 threads) instead of consumer refills (256 threads);
  * ``setmaxnreg``: a producer warpgroup (384 threads) that gives its
    registers to the consumers with setmaxnreg (24 and 240 a thread);
  * ``consumer_refill``: head_dim 64 and 128 without the producer warp,
    refilled by the consumers as head_dim 256 is.

The last three are correct; the tool prints each variant's registers,
spills and C75 warnings per head_dim before the times.

Prints the card's name and power limit, then one JSON line per shape with
each variant's milliseconds per call. Needs nvcc and a card; imports nothing
of JAX.
"""
import ctypes
import json
import os
import re
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
PRODUCER_OFF = "kProducerWarp = HD != 256;"
PRODUCER_ON = "kProducerWarp = true;"
PRODUCER_BRANCH = "      // the producer warp: one thread issues every load\n"
CONSUMER_CALL = "  consume<HD>(p, base, &tm_k, &tm_v,"
DEC = '      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");\n'
INC = '  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");\n'


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
        "loads_only": sub(src, "    if (visible) {\n", "    if (false) {\n"),
        "producer_warp": sub(src, PRODUCER_OFF, PRODUCER_ON),
        "consumer_refill": sub(src, PRODUCER_OFF, "kProducerWarp = false;"),
        "setmaxnreg": sub(sub(sub(sub(
            src, PRODUCER_OFF, PRODUCER_ON),
            "kConsumers + (kProducerWarp ? 32 : 0)",
            "kConsumers + (kProducerWarp ? 128 : 0)"),
            PRODUCER_BRANCH, DEC + PRODUCER_BRANCH),
            CONSUMER_CALL, INC + CONSUMER_CALL),
    }


def ptxas_lines(log):
    """'hd N: registers, spills[, C75 warnings]' per instantiation."""
    out, warn, hd = [], {}, None
    for line in log.splitlines():
        m = re.search(r"kernelILi(\d+)E", line)
        if "C75" in line and m:
            warn[m.group(1)] = re.search(r"\(C75\d+\)", line).group(0)
        elif "Compiling entry" in line and m:
            hd = m.group(1)
        elif "spill stores" in line and hd:
            spill = line.strip()
        elif "Used" in line and hd:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"hd {hd} {regs} registers, {spill}"
                       + (f", {warn[hd]}" if hd in warn else ""))
            hd = None
    return out


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
        print(f"{name}: " + "; ".join(ptxas_lines(log)), flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_sm90_launch
        fn.argtypes = fa.KERNEL_SM90.argtypes
        fn.restype = ctypes.c_int
        launch[name] = fn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def call(fn, q, k, v, out, window):
        b, s, h, hd = q.shape
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  hd, b, s, k.shape[1], h, k.shape[2], *q.stride()[:3],
                  *k.stride()[:3], *v.stride()[:3], 1, window, 0,
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
    shapes = {"served (4,2048,32,64) Kv 8": (4, 2048, 32, 8, 64, -1),
              "3B-like (1,2048,24,128) Kv 8": (1, 2048, 24, 8, 128, -1),
              "recurrentgemma (4,4096,10,256) Kv 1 window 2048":
                  (4, 4096, 10, 1, 256, 2048)}
    for label, (b, s, h, kv, hd, window) in shapes.items():
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, s, kv, hd), generator=gen,
                            device=dev).bfloat16() for _ in range(2))
        args = (q, k, v, torch.empty_like(q), window)
        names = [n for n in launch if hd != 256 or n != "stages_3"]
        order = names + names[::-1]
        times = {name: [] for name in names}
        for name in order:
            times[name].append(ms(launch[name], args))
        print(json.dumps({"shape": label, "causal": True, "window": window,
                          "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
