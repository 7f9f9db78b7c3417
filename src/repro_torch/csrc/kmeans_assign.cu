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
// The (n, k) distance matrix never leaves registers. Sums are float32 FMAs on
// the CUDA cores (no TF32, no tensor cores).
//
// What bounds it: memory at the main path's d = 32, k = 3. A row costs 4*d
// bytes in and 8 bytes out for ~2*d*(k+1) flops, about 2 flops per byte, far
// below the ~20 at which the card's float32 rate would overtake its memory
// rate. At ~8 MB per call the kernel is short enough that its launch and the
// latency of its first loads are a large share of its time, so the design is
// about getting every byte of x requested at once, early, by blocks that all
// fit on the card. Large k * d (the Pallas docstring budgets d = 1024,
// k = 256) is bound by the CUDA cores instead; that case is only made to run.
//
// - One launch, a persistent grid. The wrapper's `launch_plan` splits each
//   client's rows into `parts` contiguous spans so that batch * parts blocks
//   fill the card's resident block slots about once (SMs x the occupancy the
//   runtime reports). A block stages its client's centroids once and walks
//   its span in tiles; at the main shape each of 480 blocks owns one tile of
//   128 rows.
// - Threads per row (TPR) follow d: a power of two near d/4, at most 32, so a
//   lane owns four columns of a row (one float4 when d % 4 == 0 and the
//   pointers are 16-byte aligned; else four strided floats, still coalesced).
//   d = 4 gives a row to every lane, d = 32 eight lanes, d >= 128 a warp.
// - A row group of TPR lanes holds kRows = 4 rows in registers: four
//   independent 16-byte loads in flight per lane, issued before the block
//   stages its centroids, so their latency overlaps that prologue. On the
//   short path a tile's successor is loaded as soon as the tile's rows are
//   summed in, while its sums are reduced and scored.
// - Each lane sums x.c_j and ||x||^2 over its own columns; the row group then
//   adds its partials with a butterfly whose first levels scatter the rows
//   (`group_sum`): a row group of 8 lanes at d = 32 spends 16 shuffles per
//   centroid group of 4 rows x 4 centroids, where a butterfly per sum would
//   spend 48, and at d = 128 (32 lanes, 8 centroids) 48 where it would spend
//   160. Each lane then scores whole rows against ascending j.
// - ||c_j||^2 is computed once per staged chunk, a warp per centroid with its
//   lanes over the columns, into shared memory beside the chunk.
// - Centroids go to shared memory in chunks of kc centroids x dc columns (at
//   most 32 KB, and their norms), so any k and d run without opting into more
//   shared memory. j runs in ascending order across chunks with strict <, and
//   every j's sums are taken over the same lanes, columns and tree, so an
//   exact tie goes to the lower index even across a chunk boundary.
//   Centroids are scored KG (4 or 8) at a time in registers.
// - Two paths, chosen by the plan: the short one (`kSimple`) when a row fits
//   one slice of 4 * TPR columns and one chunk holds every centroid, as at
//   every shape of the main path; the general loop nest over chunks, column
//   chunks and slices otherwise. They share every step but the loops, and
//   the short one keeps few enough registers for 4 blocks an SM.
// - Ragged n and d are masked per lane and the chunk's columns past d are
//   zero-filled: no padding of n, d or k.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;   // rows a row group holds in registers

// Sums v[r][g] over the TPR lanes of a row group, in place. The first
// log2(min(TPR, kRows)) levels of the butterfly scatter rows: a lane keeps
// half of its rows, sends the other half to its partner and adds what the
// partner sends. Afterwards a lane holds kHeld = max(1, kRows / TPR) rows,
// rows (sub / kCopies) * kHeld + h in v[h], h < kHeld; the levels left add
// across the kCopies = max(1, TPR / kRows) lanes that hold the same rows.
// Every (r, g) is summed over the same tree of lane pairs (an add is
// commutative), so equal inputs give bit-equal sums whatever r and g are.
template <int O, int kHeldNow, int G>
__device__ __forceinline__ void group_sum(float (&v)[kRows][G], int sub) {
  if constexpr (O > 0) {
    if constexpr (kHeldNow > 1) {
      constexpr int half = kHeldNow / 2;
      const bool upper = (sub & O) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float send = upper ? v[i][g] : v[i + half][g];
          const float keep = upper ? v[i + half][g] : v[i][g];
          v[i][g] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
      group_sum<O / 2, half, G>(v, sub);
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[0][g] += __shfl_xor_sync(0xffffffffu, v[0][g], O);
      group_sum<O / 2, 1, G>(v, sub);
    }
  }
}

// Registers a thread may use. The short path's state fits 64 at KG = 4 and
// 80 at KG = 8, so 4 or 3 blocks of 256 threads share an SM; a lane of
// TPR = 1 scores four rows and needs more at KG = 8, as does the general
// path's loop nest: 128 (2 blocks). ptxas then spills nothing.
template <int TPR, bool kSimple, int KG>
constexpr int max_registers() {
  if (!kSimple) return 128;
  if (KG == 4) return 64;
  return TPR == 1 ? 128 : 80;
}

// kSimple: the short path (a row fits one slice, one chunk holds every
// centroid); otherwise the general loop nest.
template <int TPR, bool kVec4, int KG, bool kSimple>
__global__ void __launch_bounds__(
    kThreads, 65536 / (kThreads * max_registers<TPR, kSimple, KG>()))
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int32_t* __restrict__ assign, float* __restrict__ min_d2,
                     int n, int d, int k, int parts, int span, int kc, int dc) {
  constexpr int kGroups = kThreads / TPR;  // row groups in the block
  constexpr int kWidth = 4 * TPR;          // columns of one slice
  constexpr int kTile = kGroups * kRows;   // rows of one tile
  constexpr int kHeld = kRows > TPR ? kRows / TPR : 1;
  constexpr int kCopies = TPR > kRows ? TPR / kRows : 1;
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // (kc, dc) chunk of centroids
  float* c2s = cs + kc * dc;                     // (kc,) their squared norms

  const int b = blockIdx.x / parts;
  const int row_begin = (blockIdx.x % parts) * span;
  const int row_end = min(n, row_begin + span);
  const int sub = threadIdx.x % TPR;
  const int grp = threadIdx.x / TPR;
  const float* xb = x + static_cast<size_t>(b) * n * d;
  const float* cb = c + static_cast<size_t>(b) * k * d;

  // the column of slice s that holds this lane's q-th value: a row group's
  // float4 loads read 16 * TPR contiguous bytes
  auto col = [&](int s, int q) {
    return s * kWidth + (kVec4 ? 4 * sub + q : sub + TPR * q);
  };

  float xv[kRows][4];  // this lane's columns of one slice of its rows
  auto load = [&](int row0, int s) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = row0 + r * kGroups + grp;
      const float* xr = xb + static_cast<size_t>(i) * d;
      if (kVec4) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < row_end && col(s, 0) < d)
          t = __ldg(reinterpret_cast<const float4*>(xr + col(s, 0)));
        xv[r][0] = t.x;
        xv[r][1] = t.y;
        xv[r][2] = t.z;
        xv[r][3] = t.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[r][q] = (i < row_end && col(s, q) < d) ? __ldg(xr + col(s, q))
                                                    : 0.f;
      }
    }
  };

  // Stages centroids [jc, jc + kc) x columns [tc, tc + dc), zero past k and
  // d, and adds the chunk's part of each ||c_j||^2 to c2s: a warp per
  // centroid, its lanes over the columns, then the warp's butterfly.
  auto stage = [&](int jc, int tc) {
    __syncthreads();  // nobody still reads the previous chunk
    if (kVec4) {
      const int dc4 = dc / 4;
      for (int t = threadIdx.x; t < kc * dc4; t += kThreads) {
        const int j = jc + t / dc4;
        const int tt = tc + 4 * (t % dc4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < k && tt < d)
          v = __ldg(reinterpret_cast<const float4*>(
              cb + static_cast<size_t>(j) * d + tt));
        smem4[t] = v;
      }
    } else {
      for (int t = threadIdx.x; t < kc * dc; t += kThreads) {
        const int j = jc + t / dc;
        const int tt = tc + t % dc;
        cs[t] = (j < k && tt < d) ? __ldg(cb + static_cast<size_t>(j) * d + tt)
                                  : 0.f;
      }
    }
    __syncthreads();
    const int lane = threadIdx.x % 32;
    for (int jj = threadIdx.x / 32; jj < kc; jj += kThreads / 32) {
      float s = 0.f;
      for (int t = lane; t < dc; t += 32)
        s = fmaf(cs[jj * dc + t], cs[jj * dc + t], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) c2s[jj] = (tc == 0 ? 0.f : c2s[jj]) + s;
    }
    __syncthreads();
  };

  float x2[kRows][1], acc[kRows][KG], best[kHeld];
  int best_j[kHeld];

  // adds slice s of the rows to ||x||^2 (first group only) and to x.c_j for
  // the KG centroids from jg, of the chunk staged at (jc, tc)
  auto accumulate = [&](int jg, int jc, int tc, int s) {
    if (jg == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x2[r][0] = fmaf(xv[r][q], xv[r][q], x2[r][0]);
    }
    const float* cj = cs + (jg - jc) * dc + (s * kWidth - tc);
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      float cv[4];
      if (kVec4) {
        const float4 t = *reinterpret_cast<const float4*>(cj + g * dc + col(0, 0));
        cv[0] = t.x;
        cv[1] = t.y;
        cv[2] = t.z;
        cv[3] = t.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) cv[q] = cj[g * dc + col(0, q)];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r][g] = fmaf(xv[r][q], cv[q], acc[r][g]);
    }
  };

  auto zero_acc = [&]() {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < KG; ++g) acc[r][g] = 0.f;
  };

  auto start_tile = [&]() {
#pragma unroll
    for (int r = 0; r < kRows; ++r) x2[r][0] = 0.f;
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      best[h] = 0.f;
      best_j[h] = 0;
    }
  };

  // sums the group's partials across the row group and scores its
  // centroids, in ascending j with strict <, against the rows this lane holds
  auto score = [&](int jg, int jc) {
    if (jg == 0) group_sum<TPR / 2, kRows, 1>(x2, sub);
    group_sum<TPR / 2, kRows, KG>(acc, sub);
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      const int j = jg + g;
      if (j < k) {
        const float c2 = c2s[j - jc];
#pragma unroll
        for (int h = 0; h < kHeld; ++h) {
          const float d2 = x2[h][0] - 2.f * acc[h][g] + c2;
          if (j == 0 || d2 < best[h]) {
            best[h] = d2;
            best_j[h] = j;
          }
        }
      }
    }
  };

  // each of the kCopies lanes that hold a row agrees on it; the first writes
  auto write = [&](int row0) {
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int i = row0 + ((sub / kCopies) * kHeld + h) * kGroups + grp;
      if (i < row_end && sub % kCopies == 0) {
        const size_t o = static_cast<size_t>(b) * n + i;
        assign[o] = best_j[h];
        min_d2[o] = fmaxf(best[h], 0.f);
      }
    }
  };

  load(row_begin, 0);  // in flight while the centroids are staged
  if constexpr (kSimple) {
    stage(0, 0);
    for (int row0 = row_begin; row0 < row_end; row0 += kTile) {
      start_tile();
      for (int jg = 0; jg < k; jg += KG) {
        zero_acc();
        accumulate(jg, 0, 0, 0);
        // the rows are summed in: the next tile's rows load during scoring
        if (jg + KG >= k && row0 + kTile < row_end) load(row0 + kTile, 0);
        score(jg, 0);
      }
      write(row0);
    }
  } else {
    const bool whole = kc >= k && dc >= d;  // stage once for the block
    bool staged = false;
    for (int row0 = row_begin; row0 < row_end; row0 += kTile) {
      if (row0 != row_begin) load(row0, 0);
      int held = 0;  // the slice xv holds
      start_tile();
      for (int jc = 0; jc < k; jc += kc) {
        for (int tc = 0; tc < d; tc += dc) {
          if (!(whole && staged)) {
            stage(jc, tc);
            staged = true;
          }
          const int s_end = (min(tc + dc, d) + kWidth - 1) / kWidth;
          // a chunk narrower than d holds one group (the plan's invariant),
          // whose sums carry over from one column chunk to the next
          for (int jg = jc; jg < min(jc + kc, k); jg += KG) {
            if (tc == 0) zero_acc();
            for (int s = tc / kWidth; s < s_end; ++s) {
              if (s != held) {
                load(row0, s);
                held = s;
              }
              accumulate(jg, jc, tc, s);
            }
            if (tc + dc >= d) score(jg, jc);
          }
        }
      }
      write(row0);
    }
  }
}

struct Args {
  const float* x;
  const float* c;
  int32_t* assign;
  float* min_d2;
  int batch, n, d, k, tpr, vec4, kg, simple, parts, span, kc, dc, smem;
  cudaStream_t stream;
  int* blocks_per_sm;  // non-null: report occupancy instead of launching
};

template <int TPR, bool kVec4, int KG, bool kSimple>
cudaError_t run(const Args& a) {
  if (a.blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks_per_sm, kmeans_assign_kernel<TPR, kVec4, KG, kSimple>,
        kThreads, a.smem);
  kmeans_assign_kernel<TPR, kVec4, KG, kSimple>
      <<<a.batch * a.parts, kThreads, a.smem, a.stream>>>(
      a.x, a.c, a.assign, a.min_d2, a.n, a.d, a.k, a.parts, a.span, a.kc,
      a.dc);
  return cudaGetLastError();
}

template <int TPR, bool kVec4, int KG>
cudaError_t by_path(const Args& a) {
  return a.simple ? run<TPR, kVec4, KG, true>(a)
                  : run<TPR, kVec4, KG, false>(a);
}

template <int TPR, bool kVec4>
cudaError_t by_group(const Args& a) {
  if (a.kg == 4) return by_path<TPR, kVec4, 4>(a);
  if (a.kg == 8) return by_path<TPR, kVec4, 8>(a);
  return cudaErrorInvalidValue;
}

template <int TPR>
cudaError_t by_vec(const Args& a) {
  return a.vec4 ? by_group<TPR, true>(a) : by_group<TPR, false>(a);
}

cudaError_t dispatch(const Args& a) {
  switch (a.tpr) {
    case 1: return by_vec<1>(a);
    case 2: return by_vec<2>(a);
    case 4: return by_vec<4>(a);
    case 8: return by_vec<8>(a);
    case 16: return by_vec<16>(a);
    case 32: return by_vec<32>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (batch, n, d), c (batch, k, d) float32, contiguous; assign (batch, n)
// int32 and min_d2 (batch, n) float32 are written. The geometry (threads per
// row, centroids per register group, which path, the (kc, dc) chunk and its
// shared bytes, parts per client and the rows of a part) comes from the
// wrapper's `launch_plan`. vec4 != 0 promises d % 4 == 0 and 16-byte aligned
// x and c. Returns the CUDA error code.
extern "C" int kmeans_assign_launch(const float* x, const float* c,
                                    int32_t* assign, float* min_d2, int batch,
                                    int n, int d, int k, int tpr, int vec4,
                                    int kg, int simple, int parts, int span,
                                    int kc, int dc, int smem, void* stream) {
  const Args a{x, c, assign, min_d2, batch, n, d, k, tpr, vec4, kg, simple,
               parts, span, kc, dc, smem, static_cast<cudaStream_t>(stream),
               nullptr};
  return static_cast<int>(dispatch(a));
}

// Blocks of the (tpr, vec4, kg, simple) kernel that one SM holds at `smem`
// dynamic shared bytes, written to *blocks. Returns the CUDA error code.
extern "C" int kmeans_assign_occupancy(int tpr, int vec4, int kg, int simple,
                                       int smem, int* blocks) {
  Args a{};
  a.tpr = tpr;
  a.vec4 = vec4;
  a.kg = kg;
  a.simple = simple;
  a.smem = smem;
  a.blocks_per_sm = blocks;
  return static_cast<int>(dispatch(a));
}

extern "C" const char* kmeans_assign_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
