#!/usr/bin/env python3
"""How the tensor cores add up one tf32 ``mma.sync.m16n8k8``, checked on a
GPU against :func:`mma_tf32`, the model that the CPU emulation of the
float32 flash kernel (``tests/test_torch_flash_tf32.py``) runs.

    python3 tools/mma_tf32_probe.py

The model, for d = c + sum_k a_k b_k over the k-step's 8 products: every
product is exact; the nine terms (c and the products) are aligned to the
largest nominal exponent E among them (a product's is the sum of its
factors' exponents, floor(log2 |a|) + floor(log2 |b|)), each is cut toward
zero to a multiple of 2^(E - 25), the cut terms are added exactly, and the
sum is cut toward zero to float32. So each mma rounds toward zero at the
magnitude of its largest term, accumulator included: a long sum in one
accumulator drifts toward zero by about a float32 ulp of the running sum an
mma, where a float32 sum's roundings to nearest cancel.

The probe builds a one-mma kernel (one warp a trial, operands in the
fragment layouts of the PTX ISA), runs it on random tf32 operands and f32
accumulators of five kinds (wide exponents and signs; positive terms; c = 0;
scores-like randn; operands with their 13 low bits set, which the card must
ignore), and prints, for each kind, the share of outputs that the model, a
float32 sum rounded to nearest and one cut toward zero give bit for bit,
then the card's name and power limit. Exits 1 if the model misses any
output. Needs nvcc and a card; imports nothing of JAX.
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build/mma_tf32_probe"

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Warp w: D[w] = A[w] (16 x 8, row-major) . B[w] (8 x 8, [k][n]) + C[w].
__global__ void probe(const uint32_t* A, const uint32_t* B, const float* C,
                      float* D, int n) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  if (w >= n) return;
  const uint32_t* a = A + w * 128;
  const uint32_t* b = B + w * 64;
  const float* c = C + w * 128;
  float* d = D + w * 128;
  float d0 = c[g * 8 + 2 * t], d1 = c[g * 8 + 2 * t + 1],
        d2 = c[(g + 8) * 8 + 2 * t], d3 = c[(g + 8) * 8 + 2 * t + 1];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[g * 8 + t]), "r"(a[(g + 8) * 8 + t]), "r"(a[g * 8 + t + 4]),
        "r"(a[(g + 8) * 8 + t + 4]), "r"(b[t * 8 + g]), "r"(b[(t + 4) * 8 + g]));
  d[g * 8 + 2 * t] = d0;
  d[g * 8 + 2 * t + 1] = d1;
  d[(g + 8) * 8 + 2 * t] = d2;
  d[(g + 8) * 8 + 2 * t + 1] = d3;
}
extern "C" int probe_launch(const void* A, const void* B, const void* C,
                            void* D, int n) {
  probe<<<(n + 3) / 4, 128>>>((const uint32_t*)A, (const uint32_t*)B,
                              (const float*)C, (float*)D, n);
  return (int)cudaDeviceSynchronize();
}
"""


def _floor_log2(x):
    """floor(log2 |x|) of float64 x; a large negative number for 0."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.full_like(e, -10_000), e - 1)


def _to_f32_toward_zero(x):
    """float64 -> float32, rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_tf32(c, a, b):
    """One k-step of the tensor cores' tf32 product, as the card adds it
    (see the module's docstring): float32 c (..., M, N) plus a (..., M, 8)
    times b (..., 8, N), whose values are tf32 (10 mantissa bits)."""
    a, b, c = a.double(), b.double(), c.double()
    bt = b.transpose(-1, -2)[..., None, :, :]
    prods = a[..., :, None, :] * bt                          # (..., M, N, 8)
    nominal = _floor_log2(a)[..., :, None, :] + _floor_log2(bt)
    nominal = torch.where(prods == 0, torch.full_like(nominal, -10_000),
                          nominal)
    top = torch.maximum(nominal.amax(-1), _floor_log2(c)).clamp(min=-1000)
    quantum = torch.ldexp(torch.ones_like(c), top - 25)[..., None]
    terms = torch.cat([c[..., None], prods], -1) / quantum
    return _to_f32_toward_zero((torch.trunc(terms) * quantum).sum(-1))


def _values(gen, shape, lo, hi, bits):
    """Random floats with ``bits`` mantissa bits, exponents in [lo, hi] and
    random signs."""
    mant = 1 + torch.randint(0, 2 ** bits, shape, generator=gen) / 2.0 ** bits
    exp = torch.randint(lo, hi + 1, shape, generator=gen)
    sign = torch.randint(0, 2, shape, generator=gen) * 2 - 1
    return (sign * torch.ldexp(mant.double(), exp)).float()


def _tf32(x):
    """cvt.rna.tf32.f32 on the bits."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _kinds(gen, n):
    a, b = (n, 16, 8), (n, 8, 8)
    return {
        "wide exponents": (_values(gen, a, -6, 6, 10),
                           _values(gen, b, -6, 6, 10),
                           _values(gen, a, -4, 8, 23)),
        "positive terms": (_values(gen, a, -2, 2, 10).abs(),
                           _values(gen, b, -2, 2, 10).abs(),
                           _values(gen, a, 0, 6, 23).abs()),
        "c = 0": (_values(gen, a, -3, 3, 10), _values(gen, b, -3, 3, 10),
                  torch.zeros(a)),
        "scores-like": (_tf32(torch.randn(a, generator=gen)),
                        _tf32(torch.randn(b, generator=gen)),
                        torch.randn(a, generator=gen) * 20),
        "13 low bits set": (_values(gen, a, -3, 3, 23),
                            _values(gen, b, -3, 3, 23),
                            _values(gen, a, -2, 4, 23)),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tf32_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "probe.cu").write_text(SOURCE)
    lib = OUT / "probe.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(OUT / "probe.cu")], check=True, capture_output=True)
    launch = ctypes.CDLL(str(lib)).probe_launch
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    dev = torch.device("cuda", 0)

    def card(a, b, c):
        a, b, c = (x.contiguous().to(dev) for x in (a, b, c))
        d = torch.empty_like(c)
        if launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
                  a.shape[0]):
            raise RuntimeError("the probe kernel failed")
        return d.cpu()

    gen = torch.Generator().manual_seed(0)
    missed = 0
    for kind, (a, b, c) in _kinds(gen, 8192).items():
        d = card(a, b, c)
        ta, tb = (x.view(torch.int32).__and__(~0x1FFF).view(torch.float32)
                  for x in (a, b))
        exact = c.double() + ta.double() @ tb.double()
        model = mma_tf32(c, ta, tb)
        same = {"model": model, "f32 to nearest": exact.float(),
                "f32 toward zero": _to_f32_toward_zero(exact)}
        shares = {k: float((v.view(torch.int32) == d.view(torch.int32))
                           .double().mean()) for k, v in same.items()}
        missed += int((model.view(torch.int32) != d.view(torch.int32)).sum())
        print(f"{kind}: {d.numel()} outputs, bit for bit: {shares}",
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"model missed {missed} outputs")
    return 1 if missed else 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
