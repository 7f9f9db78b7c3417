// Fused K-means assignment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kmeans_assign_pallas`
// (src/repro/kernels/kmeans_assign.py, body `_kernel`). For every client b and
// every row i of x (N, n, d) against that client's centroids c (N, k, d):
//
//   d2[j]        = ||x_i||^2 - 2 x_i.c_j + ||c_j||^2   (the reference's expansion)
//   assign[b, i] = first argmin_j d2[j]                (ascending j, strict <)
//   min_d2[b, i] = max(min_j d2[j], 0)
//
// The (n, k) distance matrix never leaves registers.
//
// What bounds it: memory. A row costs 4*d bytes in and 8 bytes out for
// ~2*d*(k+1) flops: at the pipeline's d = 32, k = 3 about 2 flops per byte,
// far below the ~20 flops per byte at which the card's float32 rate would
// overtake its memory rate. So the kernel reads x exactly once and writes
// only the two (n,) results; at the pipeline's ~8 MB per call the launch
// costs about as much as the traffic.
//
// Design: one launch for all clients. The grid is (row tiles, clients); a
// block stages its client's k*d centroids and their squared norms in shared
// memory (read back as broadcasts). kTPR = 8 neighbouring threads share a
// row: each reads every 8th float4 of it (one float4 each at d = 32), so a
// warp reads four whole rows as 512 contiguous bytes, and the card has ~8x
// more threads in flight than with a thread per row. The partial ||x||^2 and
// x.c_j are summed across the 8 threads with register shuffles. Centroids
// are scored in register groups of kGroup; k > kGroup re-reads the row from
// L1. Ragged n and d are masked per thread: no padding of n, d or k.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTPR = 8;                      // threads per row
constexpr int kRowsPerBlock = kThreads / kTPR;
constexpr int kGroup = 8;                    // centroids per register pass

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kTPR / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, kTPR);
  return v;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int32_t* __restrict__ assign, float* __restrict__ min_d2,
                     int n, int d, int k) {
  extern __shared__ float smem[];
  float* cs = smem;          // (k, d): this client's centroids
  float* c2 = smem + k * d;  // (k,):   their squared norms
  const int b = blockIdx.y;
  const float* cb = c + static_cast<size_t>(b) * k * d;
  for (int t = threadIdx.x; t < k * d; t += blockDim.x) cs[t] = cb[t];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < d; ++t) s = fmaf(cs[j * d + t], cs[j * d + t], s);
    c2[j] = s;
  }
  __syncthreads();

  // every thread stays to the end: the row sums shuffle across all lanes
  const int sub = threadIdx.x % kTPR;
  const int i = blockIdx.x * kRowsPerBlock + threadIdx.x / kTPR;
  const bool live = i < n;
  const size_t row = static_cast<size_t>(b) * n + (live ? i : 0);
  const float* xr = x + row * d;

  float x2 = 0.f;
  float best = 0.f;
  int best_j = 0;
  for (int j0 = 0; j0 < k; j0 += kGroup) {
    const bool first_pass = j0 == 0;
    float acc[kGroup];
#pragma unroll
    for (int jj = 0; jj < kGroup; ++jj) acc[jj] = 0.f;
    if (kVec4) {
      const float4* xr4 = reinterpret_cast<const float4*>(xr);
      for (int t4 = sub; live && t4 < d / 4; t4 += kTPR) {
        const float4 v = __ldg(xr4 + t4);
        const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = 4 * t4 + q;
          if (first_pass) x2 = fmaf(xv[q], xv[q], x2);
#pragma unroll
          for (int jj = 0; jj < kGroup; ++jj)
            if (j0 + jj < k) acc[jj] = fmaf(xv[q], cs[(j0 + jj) * d + t], acc[jj]);
        }
      }
    } else {
      for (int t = sub; live && t < d; t += kTPR) {
        const float xv = __ldg(xr + t);
        if (first_pass) x2 = fmaf(xv, xv, x2);
#pragma unroll
        for (int jj = 0; jj < kGroup; ++jj)
          if (j0 + jj < k) acc[jj] = fmaf(xv, cs[(j0 + jj) * d + t], acc[jj]);
      }
    }
    if (first_pass) x2 = row_sum(x2);
#pragma unroll
    for (int jj = 0; jj < kGroup; ++jj) {
      const int j = j0 + jj;
      if (j < k) {  // k is block-uniform: all lanes shuffle together
        const float cross = row_sum(acc[jj]);
        const float d2 = x2 - 2.f * cross + c2[j];
        if (j == 0 || d2 < best) {
          best = d2;
          best_j = j;
        }
      }
    }
  }
  if (live && sub == 0) {
    assign[row] = best_j;
    min_d2[row] = fmaxf(best, 0.f);
  }
}

template <bool kVec4>
cudaError_t launch(const float* x, const float* c, int32_t* assign,
                   float* min_d2, int batch, int n, int d, int k,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(k) * d + k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kmeans_assign_kernel<kVec4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  kmeans_assign_kernel<kVec4><<<grid, kThreads, smem, stream>>>(
      x, c, assign, min_d2, n, d, k);
  return cudaGetLastError();
}

}  // namespace

// x (batch, n, d), c (batch, k, d) float32, contiguous; assign (batch, n)
// int32 and min_d2 (batch, n) float32 are written. vec4 != 0 promises that
// d % 4 == 0 and that x is 16-byte aligned. Returns the CUDA error code.
extern "C" int kmeans_assign_launch(const float* x, const float* c,
                                    int32_t* assign, float* min_d2, int batch,
                                    int n, int d, int k, int vec4,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      vec4 ? launch<true>(x, c, assign, min_d2, batch, n, d, k, s)
           : launch<false>(x, c, assign, min_d2, batch, n, d, k, s);
  return static_cast<int>(e);
}

extern "C" const char* kmeans_assign_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
