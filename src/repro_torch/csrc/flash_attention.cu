// Flash attention (online softmax) for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_make_kernel`). For q
// (B, S, H, hd) and k, v (B, L, Kv, hd), with query head h reading KV head
// h / (H / Kv):
//
//   out[b, i, h] = sum_j p_ij v[b, j, kvh] / max(sum_j p_ij, 1e-30)
//   p_ij         = mask_ij ? exp(s_ij - max_j' s_ij') : 0
//   s_ij         = hd^-0.5 q[b, i, h] . k[b, j, kvh]
//   mask_ij      = j < L, (causal: i + q_offset >= j),
//                  (window: i + q_offset - j < window)
//
// Loads are bf16 or f32; every product, the running max, the running sum and
// the accumulator are f32, as in the Pallas body. Masked scores take the
// -1e30 sentinel and masked probabilities are 0, so a row with no visible key
// comes out 0 and never NaN.
//
// What bounds it: operations. Causal prefill at the served shape (B 4, S = L
// 2,048, H 32, Kv 8, hd 64, bf16) needs 4*B*H*hd*S*(S+1)/2 = 68.7 GFLOP on
// 84 MB of q, k, v and out: 0.0695 ms at the tensor cores' 989 TFLOP/s and
// 0.025 ms at 3.35 TB/s. This kernel multiplies on the CUDA cores in f32, so
// 67 TFLOP/s holds it to ~1 ms at best; wgmma on bf16 tiles is later work.
//
// Design: one block per (query tile of 64 rows, head, batch row); a loop
// inside the block over KV tiles of 64 keys takes the place of the TPU's
// sequential ("arbitrary") KV grid axis. q^T and each k^T / v tile are staged
// in shared memory as f32; 256 threads form a 16 x 16 grid in which thread
// (tr, tc) owns query rows 4tr..4tr+3 and, per tile, keys 4tc..4tc+3, so both
// products read float4s from shared memory (2 loads per 16 FMAs). The 16
// threads of a row sit in one half-warp and reduce its max and sum with
// shuffles; m, l and the accumulator (4 rows x hd/16 columns) stay in
// registers. KV tiles that the causal or window mask hides from every row of
// the block are skipped: in the Pallas body such a tile leaves m, l and acc
// unchanged. Query tiles are issued longest-first to even out the causal
// triangle. The kernel reads q, k, v through their strides and masks ragged S
// and L itself: nothing is transposed or padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kThreads = 256;    // 16 x 16 thread grid
constexpr int kLdP = kBQ + 4;    // p^T row stride (keeps float4 alignment)
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int seq_q, seq_k, heads, group;           // S, L, H, H / Kv
  long long q_sb, q_ss, q_sh;               // strides in elements
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  int causal, window, q_offset, vec;        // window < 0: none
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Reads 16 bytes' worth of T at p as floats: one 16-byte load when vec (p
// aligned), element by element otherwise; zeros when !valid.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, bool valid, bool vec,
                                           float* out) {
  constexpr int kVec = 16 / sizeof(T);
  if (!valid) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = 0.f;
  } else if (vec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = to_f32(vals[e]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = to_f32(p[e]);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (HD * kBQ + HD * kBK + kBK * HD + kBK * kLdP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int kChunks = HD / kVec;     // chunks per row of hd
  constexpr int kTD = HD / 16;           // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                      // [HD][kBQ]  q^T, pre-scaled
  float* kt = qt + HD * kBQ;             // [HD][kBK]  k^T
  float* vs = kt + HD * kBK;             // [kBK][HD]  v
  float* pt = vs + kBK * HD;             // [kBK][kLdP] p^T

  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const bool vec = p.vec != 0;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // q tile -> q^T, scaled as the Pallas body scales q; rows past S are 0.
  for (int idx = tid; idx < kBQ * kChunks; idx += kThreads) {
    const int r = idx % kBQ;
    const int c = idx / kBQ;
    float e[kVec];
    load_chunk(qg + (q0 + r) * p.q_ss + c * kVec, q0 + r < p.seq_q, vec, e);
#pragma unroll
    for (int i = 0; i < kVec; ++i) qt[(c * kVec + i) * kBQ + r] = e[i] * p.scale;
  }

  // The keys some row of this block can see: [k_begin, k_end).
  const int pos_lo = q0 + p.q_offset;
  const int pos_hi = min(q0 + kBQ, p.seq_q) - 1 + p.q_offset;
  const int k_end = p.causal ? min(p.seq_k, pos_hi + 1) : p.seq_k;
  const int k_begin = p.window >= 0 ? max(0, pos_lo - p.window + 1) : 0;

  float m[4], l[4], acc[4][kTD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < kTD; ++d) acc[i][d] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
      const int c = idx % kBK;
      const int ch = idx / kBK;
      float e[kVec];
      load_chunk(kg + (k0 + c) * p.k_sl + ch * kVec, k0 + c < p.seq_k, vec, e);
#pragma unroll
      for (int i = 0; i < kVec; ++i) kt[(ch * kVec + i) * kBK + c] = e[i];
    }
    for (int idx = tid; idx < kBK * kChunks; idx += kThreads) {
      const int ch = idx % kChunks;
      const int c = idx / kChunks;
      float e[kVec];
      load_chunk(vg + (k0 + c) * p.v_sl + ch * kVec, k0 + c < p.seq_k, vec, e);
#pragma unroll
      for (int i = 0; i < kVec; i += 4)
        *reinterpret_cast<float4*>(vs + c * HD + ch * kVec + i) =
            make_float4(e[i], e[i + 1], e[i + 2], e[i + 3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kBQ + tr * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * kBK + tc * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // Mask, then the online-softmax update of each of this thread's rows.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr * 4 + i;
      const int pos = qi + p.q_offset;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc * 4 + j;
        ok[j] = qi < p.seq_q && kj < p.seq_k && (!p.causal || pos >= kj) &&
                (p.window < 0 || pos - kj < p.window);
        s[i][j] = ok[j] ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? __expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      const float alpha = __expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < kTD; ++d) acc[i][d] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tc * 4 + j) * kLdP + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p v over this tile's keys.
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(pt + c * kLdP + tr * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vr = vs + c * HD + tc * kTD;
      float vv[kTD];
      if constexpr (kTD % 4 == 0) {
#pragma unroll
        for (int d = 0; d < kTD; d += 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr + d);
          vv[d] = t.x;
          vv[d + 1] = t.y;
          vv[d + 2] = t.z;
          vv[d + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int d = 0; d < kTD; d += 2) {
          const float2 t = *reinterpret_cast<const float2*>(vr + d);
          vv[d] = t.x;
          vv[d + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < kTD; ++d) acc[i][d] = fmaf(pr[i], vv[d], acc[i][d]);
    }
  }

  // out (B, S, H, hd), contiguous.
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + tr * 4 + i;
    if (qi >= p.seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = og + ((static_cast<long long>(b) * p.seq_q + qi) * p.heads + h) * HD +
             tc * kTD;
#pragma unroll
    for (int d = 0; d < kTD; ++d) store(row + d, acc[i][d] / denom);
  }
}

template <typename T, int HD>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.seq_q + kBQ - 1) / kBQ, p.heads, batch);
  flash_attention_kernel<T, HD><<<grid, kThreads, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& p, int head_dim, int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, S, H, hd), k and v (B, L, Kv, hd) with unit stride along hd and the
// other strides given in elements; out (B, S, H, hd) contiguous. dtype 0 is
// float32, 1 bfloat16; head_dim is 32, 64, 128 or 256; window < 0 means no
// window. vec != 0 promises 16-byte aligned pointers and strides that are
// multiples of 16 bytes. Returns the CUDA error code of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int head_dim, int batch, int seq_q, int seq_k, int heads, int kv_heads,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, int causal, int window, int q_offset, float scale, int vec,
    void* stream) {
  Params p{q,    k,    v,    out,  seq_q,  seq_k,  heads,    heads / kv_heads,
           q_sb, q_ss, q_sh, k_sb, k_sl,   k_sh,   v_sb,     v_sl,
           v_sh, causal, window, q_offset, vec, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(p, head_dim, batch, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(p, head_dim, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
