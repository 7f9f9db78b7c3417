// Masked reconstruction-MSE gate score for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `recon_gate_pallas`
// (src/repro/kernels/recon_gate.py, body `_kernel`). For reconstructions y and
// targets x (G, R, P) and a sample mask (G, R):
//
//   per[g, r] = inv_p * sum_p (y[g, r, p] - x[g, r, p])^2
//   out[g]    = sum_r per[g, r] * mask[g, r] / max(sum_r mask[g, r], 1)
//
// The (G, R, P) residual is never stored.
//
// What bounds it: memory. Every element of y and x is read once for three
// flops, so the kernel is a streaming read of 8*G*R*P bytes (376 MB for the
// pipeline's base score: G=30 clients, R=1998 samples, P=784 pixels).
//
// Design: two deterministic passes, no atomics, so the result does not depend
// on the order blocks run in.
//   1. `recon_gate_rows`: a grid over (row tiles, groups); one warp owns one
//      sample row, streams it as float4 loads where P % 4 == 0, squares the
//      difference, reduces across the warp and writes one float per sample.
//      The TPU kernel's one-program-per-group grid would give the base score
//      30 blocks of 12.5 MB each on a 132-SM card; a warp per row puts
//      thousands of rows in flight.
//   2. `recon_gate_groups`: one block per group folds its R per-sample scores
//      and mask into the masked mean in a fixed tree order.
// Ragged R and P are masked in the kernels: no x8/x128 padding is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // sample rows per block in pass 1
constexpr int kReduceThreads = 256;  // threads per group in pass 2

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
recon_gate_rows(const float* __restrict__ y, const float* __restrict__ x,
                float* __restrict__ per, int rows, int pixels, float inv_p) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // r is warp-uniform: whole warps leave together
  const size_t row = static_cast<size_t>(blockIdx.y) * rows + r;
  const float* yr = y + row * pixels;
  const float* xr = x + row * pixels;
  float s = 0.f;
  if (kVec4) {
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int t = lane; t < pixels / 4; t += 32) {
      const float4 a = __ldg(y4 + t);
      const float4 b = __ldg(x4 + t);
      float e = a.x - b.x;
      s = fmaf(e, e, s);
      e = a.y - b.y;
      s = fmaf(e, e, s);
      e = a.z - b.z;
      s = fmaf(e, e, s);
      e = a.w - b.w;
      s = fmaf(e, e, s);
    }
  } else {
    for (int t = lane; t < pixels; t += 32) {
      const float e = __ldg(yr + t) - __ldg(xr + t);
      s = fmaf(e, e, s);
    }
  }
  s = warp_sum(s);
  if (lane == 0) per[row] = s * inv_p;
}

__global__ void __launch_bounds__(kReduceThreads)
recon_gate_groups(const float* __restrict__ per, const float* __restrict__ mask,
                  float* __restrict__ out, int rows) {
  __shared__ float s_num[kReduceThreads / 32];
  __shared__ float s_cnt[kReduceThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * rows;
  float num = 0.f;
  float cnt = 0.f;
  for (int r = threadIdx.x; r < rows; r += kReduceThreads) {
    const float m = mask[base + r];
    num = fmaf(per[base + r], m, num);
    cnt += m;
  }
  num = warp_sum(num);
  cnt = warp_sum(cnt);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_num[warp] = num;
    s_cnt[warp] = cnt;
  }
  __syncthreads();
  if (warp == 0) {
    num = lane < kReduceThreads / 32 ? s_num[lane] : 0.f;
    cnt = lane < kReduceThreads / 32 ? s_cnt[lane] : 0.f;
    num = warp_sum(num);
    cnt = warp_sum(cnt);
    if (lane == 0) out[blockIdx.x] = num / fmaxf(cnt, 1.f);
  }
}

}  // namespace

// y, x (groups, rows, pixels) and mask (groups, rows) float32, contiguous;
// per (groups, rows) is scratch, out (groups,) the result. vec4 != 0 promises
// pixels % 4 == 0 and 16-byte aligned y and x. Returns the CUDA error code.
extern "C" int recon_gate_launch(const float* y, const float* x,
                                 const float* mask, float* per, float* out,
                                 int groups, int rows, int pixels, float inv_p,
                                 int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    const dim3 grid((rows + kWarps - 1) / kWarps, groups);
    if (vec4) {
      recon_gate_rows<true><<<grid, kWarps * 32, 0, s>>>(y, x, per, rows,
                                                         pixels, inv_p);
    } else {
      recon_gate_rows<false><<<grid, kWarps * 32, 0, s>>>(y, x, per, rows,
                                                          pixels, inv_p);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  recon_gate_groups<<<groups, kReduceThreads, 0, s>>>(per, mask, out, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* recon_gate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
