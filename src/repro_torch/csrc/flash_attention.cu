// Flash attention (online softmax) for Hopper (sm_90a): float32 and the
// views the TMA kernel cannot take, with both products on the tensor cores
// in 3xTF32 through mma.sync.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_make_kernel`). For q
// (B, S, H, hd) and k, v (B, L, Kv, hd), with query head h reading KV head
// h / (H / Kv):
//
//   out[b, i, h] = sum_j p_ij v[b, j, kvh] / max(sum_j p_ij, 1e-30)
//   p_ij         = mask_ij ? exp(s_ij - max_j' s_ij') : 0
//   s_ij         = (hd^-0.5 q[b, i, h]) . k[b, j, kvh]
//   mask_ij      = j < L, (causal: i + q_offset >= j),
//                  (window: i + q_offset - j < window)
//
// Loads are bf16 or f32; the running max, the running sum and the
// accumulator are f32, as in the Pallas body. Masked scores take the -1e30
// sentinel and masked probabilities are 0, so a row with no visible key
// comes out 0 and never NaN.
//
// Arithmetic: 3xTF32. Each f32 operand x splits into hi = tf32(x) and
// lo = tf32(x - hi), rounding as cvt.rna.tf32.f32 does, and each product
// a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, small terms first,
// by mma.sync.m16n8k8 (tf32 products are exact). The dropped a_lo.b_lo
// term is ~2^-22 of a.b; one TF32 pass would miss the f32 tolerance by
// ~50x. The tensor cores add an mma's eight products and its accumulator
// with every term cut toward zero at 2^-25 of the largest and the sum cut
// toward zero to f32 (tools/mma_tf32_probe.py holds this model to the
// card bit for bit), so a long sum in one accumulator drifts toward zero
// by about an ulp of its magnitude an mma. Hence S's two small passes sum
// in an accumulator of their own (~2^-11 of S), its hi.hi pass in a fresh
// one each 8 k-steps joined to S in f32, and each KV tile's P.V in its own
// accumulator joined to O by one f32 FMA. At scores up to ~22 (q drawn x
// 4) at head_dim 256 that keeps 5.0e-6 of float64 attention, where the
// plain f32 version is 1.4e-5 off it and S in one accumulator missed the
// 2e-5 tolerance (tests/test_torch_flash_tf32.py emulates all of it on
// the CPU). bf16 values are exact in tf32, so a bf16 k or v has no lo part
// and its products take two passes, not three.
//
// What bounds it: operations. Causal prefill of Llama-3.2-1B's attention in
// f32 (1, 2,048, 32/8, 64) needs 4*B*H*hd*S*(S+1)/2 = 17.19 GFLOP on 41.9 MB:
// 0.0125 ms at 3.35 TB/s, 0.2565 ms at the CUDA cores' 67 TFLOP/s and
// 0.1042 ms as 3xTF32 (3 x 17.19 GFLOP at the tensor cores' 495 TFLOP/s),
// the least time for f32 products at f32 accuracy on this card. mma.sync
// reaches about half that rate on an H100, and each product costs integer
// and float instructions to split its operands, so the kernel is bound by
// instruction throughput and latency: 0.36 ms there on an H100 SXM at 700 W.
//
// Design (FlashAttention-2's on mma.sync): a 1-D grid of blocks, query tile
// slowest, counted from the last, so blocks start longest first over the
// whole grid (ordered per head, the causal triangle's longest tiles of the
// last heads started last: the global order is 35% faster at Llama's
// shape). A block is 4
// warps; each warp owns kM atoms of 16 query rows (2 at head_dim <= 64, 1
// above: O and P take the registers). A loop inside the block over KV
// tiles of 32 keys takes the place of the TPU's sequential ("arbitrary")
// KV grid axis. K and V tiles come through a 2-stage ring in shared memory,
// filled with 16-byte cp.async copies (zero-filled past L through the
// copy's source size) when the views are 16-byte aligned (vec), and by
// plain loads otherwise. q is read once, scaled by hd^-0.5 (before the
// product, as the Pallas body does) into shared memory. S = Q.K^T stays in
// mma accumulators: each thread holds rows g and g+8 of an atom (g = lane /
// 4, t = lane % 4), reduces their max over its quad with two shuffles, and
// keeps m, l (its quad's partial sum, reduced once at the end) and O in
// registers. Within a k-step, A columns t and t+4 take hd elements 2t and
// 2t+1 (a sum over hd does not depend on its order), so q's and K's
// fragments are 8-byte loads; K and q rows are padded to HD + 8 floats and V
// rows to HD + 4, which puts a warp's fragment reads in distinct banks. P
// goes to P.V without shared memory: the accumulator of S for 8 keys
// (columns 2t and 2t+1 of this thread) is P's A fragment once its keys are
// relabelled the same way, and V's B fragment is read at those keys, b0 =
// V[2t][g], b1 = V[2t+1][g]. Each K and V fragment is split once for the
// warp's atoms; at head_dim 128 each warp splits its q rows once, keeping hi
// in registers and lo in place of q (elsewhere q is split at each k-step:
// its hi and lo would not fit beside O). KV tiles the causal or window
// mask hides from every row of the block are not loaded, tiles hidden from
// a whole warp are not computed by it, and tiles every row of a warp sees
// in full skip the mask; in the Pallas body a hidden tile leaves m, l and
// acc unchanged. Shared memory for f32: 40 KB at head_dim 32, 73 KB at 64,
// 103 KB at 128 (two blocks an SM at 64 and 128, by registers and by
// shared memory), 202 KB at 256 (one). The kernel reads q, k, v through
// their strides and masks ragged S and L itself: nothing is transposed or
// padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct Tile {
  static constexpr int kM = HD <= 64 ? 2 : 1;           // 16-row atoms a warp
  static constexpr int kBQ = 16 * kM * kWarps;          // query rows a block
  static constexpr int kBK = 32;                        // keys a KV tile
  static constexpr int kStages = 2;                     // K/V ring depth
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kLdK = HD + 8;                   // K row, elements
  static constexpr int kLdV = HD + kVec;                // V row, elements
  static constexpr int kLdQ = HD + 8;                   // q row, floats
  static constexpr bool kQHiRegs = HD == 128;           // q's hi kept
  static constexpr int kQ = kBQ * kLdQ;                 // q or q's lo, floats
  static constexpr int kStage = kBK * (kLdK + kLdV);    // K + V, elements
  static constexpr int kSmem = static_cast<int>(
      sizeof(float) * kQ + sizeof(T) * kStages * kStage);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int seq_q, seq_k, heads, group;           // S, L, H, H / Kv
  int batch, q_tiles;                       // B, query tiles of S
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
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), tf32 rounding to
// nearest with ties away from zero (cvt.rna.tf32.f32) done on the bits: add
// half a tf32 ulp (0x1000) and drop the 13 low bits. hi needs them cleared
// (x - hi must be exact); lo keeps them, since the tensor cores read only a
// tf32 operand's top 19 bits. These run at the full integer and float rate;
// two cvt instructions a split made the kernel 16% slower.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// Two neighbouring elements: one 8-byte (f32) or 4-byte (bf16) load.
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p,
                                          __nv_bfloat16& a,
                                          __nv_bfloat16& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = v.x;
  b = v.y;
}

// A B fragment (b0 in row t, b1 in row t + 4 of the 8 x 8 B tile) split
// into tf32 parts; a bf16 value is exact in tf32, so its lo part is never
// read.
struct BFrag {
  uint32_t hi0, hi1, lo0, lo1;
};
template <typename T>
__device__ __forceinline__ BFrag b_frag(T b0, T b1) {
  BFrag f;
  if constexpr (sizeof(T) == 4) {
    split(to_f32(b0), f.hi0, f.lo0);
    split(to_f32(b1), f.hi1, f.lo1);
  } else {
    f.hi0 = __float_as_uint(to_f32(b0));
    f.hi1 = __float_as_uint(to_f32(b1));
    f.lo0 = f.lo1 = 0u;
  }
  return f;
}

// d += a . b on one m16n8k8 tile (A 16 x 8 row-major, B 8 x 8 col-major).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, small terms
// first; with a bf16 b (no lo part) a_lo.b + a_hi.b.
template <typename T>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     const BFrag& b) {
  mma(d, a_lo, b.hi0, b.hi1);
  if constexpr (sizeof(T) == 4) mma(d, a_hi, b.lo0, b.lo1);
  mma(d, a_hi, b.hi0, b.hi1);
}

// A fragment of S = Q.K^T from a row-major f32 q tile, split: rows g and
// g+8, and for the k-step's columns t and t+4 the hd elements 2t and 2t+1
// (a sum over hd does not depend on its order, so K's B fragment takes the
// same two: each pair is one 8-byte load).
__device__ __forceinline__ void a_frag(const float* p, int ld,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  float x0, x2, x1, x3;
  load_pair(p, x0, x2);
  load_pair(p + 8 * ld, x1, x3);
  split(x0, hi[0], lo[0]);
  split(x1, hi[1], lo[1]);
  split(x2, hi[2], lo[2]);
  split(x3, hi[3], lo[3]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copies keys [k0, k0 + kBK) of k and v into one ring stage: rows past L are
// zeros (masked keys meet p = 0, and 0 * garbage could be NaN).
template <typename T, int HD>
__device__ __forceinline__ void load_kv(const T* kg, const T* vg,
                                        const Params& p, int k0, T* stage,
                                        bool vec, int tid) {
  using C = Tile<T, HD>;
  // Thread tid copies 16-byte chunk tid % kChunks of rows tid / kChunks,
  // + kRowStep, + 2 kRowStep, ... of the tile.
  constexpr int kChunks = HD / C::kVec;
  constexpr int kRowStep = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0 && C::kBK % kRowStep == 0);
  const int r0 = tid / kChunks;
  const int c = (tid % kChunks) * C::kVec;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long sl = half ? p.v_sl : p.k_sl;
    const int ld = half ? C::kLdV : C::kLdK;
    const T* from = (half ? vg : kg) + (k0 + r0) * sl + c;
    T* to = stage + half * C::kBK * C::kLdK + r0 * ld + c;
#pragma unroll
    for (int r = r0; r < C::kBK; r += kRowStep) {
      const bool valid = k0 + r < p.seq_k;
      if (vec) {
        cp_async16(to, valid ? from : kg, valid ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < C::kVec; ++e)
          to[e] = valid ? from[e] : from_f32<T>(0.f);
      }
      from += kRowStep * sl;
      to += kRowStep * ld;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  using C = Tile<T, HD>;
  constexpr int kM = C::kM;
  constexpr int kBQ = C::kBQ;
  constexpr int kBK = C::kBK;
  constexpr int kStages = C::kStages;
  constexpr int kNT = kBK / 8;           // 8-key column tiles of S
  constexpr int kKS = HD / 8;            // k-steps of S, column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [kBQ][kLdQ]
  T* ring = reinterpret_cast<T*>(qs + C::kQ);              // kStages x K, V

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  // Blocks run longest first over the whole grid: the query tile is the
  // slowest index of blockIdx.x, counted from the last (causal: the most
  // keys), then the head, then the batch row.
  const int rows = p.heads * p.batch;
  const int q0 = (p.q_tiles - 1 - static_cast<int>(blockIdx.x) / rows) * kBQ;
  const int h = static_cast<int>(blockIdx.x) % p.heads;
  const int b = static_cast<int>(blockIdx.x) % rows / p.heads;
  const int kvh = h / p.group;
  const bool vec = p.vec != 0;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // The keys some row of this block can see: tiles [t_begin, t_end).
  const int pos_lo = q0 + p.q_offset;
  const int pos_hi = min(q0 + kBQ, p.seq_q) - 1 + p.q_offset;
  const int k_end = p.causal ? min(p.seq_k, pos_hi + 1) : p.seq_k;
  const int k_begin = p.window >= 0 ? max(0, pos_lo - p.window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int n_tiles = max(0, (k_end + kBK - 1) / kBK - t_begin);

  // Fill the ring's first stages while q is read.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles)
      load_kv<T, HD>(kg, vg, p, (t_begin + i) * kBK, ring + i * C::kStage,
                     vec, tid);
    cp_async_commit();
  }

  // q tile, scaled as the Pallas body scales q; rows past S are 0.
  {
    constexpr int kChunks = HD / C::kVec;
    for (int idx = tid; idx < kBQ * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = (idx % kChunks) * C::kVec;
      float e[C::kVec];
      load_chunk(qg + (q0 + r) * p.q_ss + c, q0 + r < p.seq_q, vec, e);
#pragma unroll
      for (int i = 0; i < C::kVec; i += 4)
        *reinterpret_cast<float4*>(qs + r * C::kLdQ + c + i) = make_float4(
            e[i] * p.scale, e[i + 1] * p.scale, e[i + 2] * p.scale,
            e[i + 3] * p.scale);
    }
  }
  __syncthreads();

  // This warp's rows: atom i holds rows 16 (kM warp + i) + g and + 8.
  const int qw = (16 * kM * warp + g) * C::kLdQ + 2 * t;
  // Where the registers allow, the warp splits its rows of q once: hi stays
  // in registers and lo replaces q in shared memory (each element is read
  // and written by the one thread whose fragment holds it).
  constexpr int kQK = C::kQHiRegs ? kKS : 1;
  uint32_t q_hi[kQK][4];
  if constexpr (C::kQHiRegs) {
    static_assert(kM == 1);
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t lo[4];
      float* at = qs + qw + 8 * kk;
      a_frag(at, C::kLdQ, q_hi[kk], lo);
      *reinterpret_cast<uint2*>(at) = make_uint2(lo[0], lo[2]);
      *reinterpret_cast<uint2*>(at + 8 * C::kLdQ) = make_uint2(lo[1], lo[3]);
    }
    __syncwarp();
  }

  // The keys row g + 8r of atom i sees, [vis_lo, vis_hi] ...
  const int pw = q0 + 16 * kM * warp + p.q_offset;  // the warp's first row
  int vis_lo[kM][2], vis_hi[kM][2];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = pw + 16 * i + g + 8 * r;
      vis_hi[i][r] = p.causal ? min(pos, p.seq_k - 1) : p.seq_k - 1;
      vis_lo[i][r] = p.window >= 0 ? pos - p.window + 1 : 0;
    }
  // ... and what every row of the warp sees at least / some row at most.
  const int w_last = pw + 16 * kM - 1;
  const int w_hi_min = p.causal ? min(pw, p.seq_k - 1) : p.seq_k - 1;
  const int w_hi_max = p.causal ? min(w_last, p.seq_k - 1) : p.seq_k - 1;
  const int w_lo_min = p.window >= 0 ? pw - p.window + 1 : 0;
  const int w_lo_max = p.window >= 0 ? w_last - p.window + 1 : 0;

  float m[kM][2], l[kM][2];              // l: this thread's share of the sum
  float o[kM][kKS][4];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < kKS; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][d][e] = 0.f;
  }

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int pre = it + kStages - 1;
    if (pre < n_tiles)
      load_kv<T, HD>(kg, vg, p, (t_begin + pre) * kBK,
                     ring + (pre % kStages) * C::kStage, vec, tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const int k0 = (t_begin + it) * kBK;
    const T* ks = ring + (it % kStages) * C::kStage;
    const T* vs = ks + kBK * C::kLdK;
    if (w_lo_min <= k0 + kBK - 1 && w_hi_max >= k0) {
      // S = Q.K^T: column tile n holds keys k0 + 8n .. k0 + 8n + 7; each K
      // fragment is split once for the warp's kM atoms.
      // The tensor cores cut each mma's sum toward zero at the magnitude of
      // its accumulator: summed in one accumulator, S's 3 x HD / 8 mmas
      // drift toward zero by ~1e-6 of |S|, which misses 2e-5 once scores
      // reach ~20. So the two small passes (q_lo.k_hi, q_hi.k_lo) sum in
      // an accumulator of their own (~2^-11 of S), and the hi.hi pass in a
      // fresh one for each kChunk k-steps, joined to S in f32.
      constexpr int kChunk = 8;
      float s[kM][kNT][4], s_lo[kM][kNT][4];
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][n][e] = s_lo[i][n][e] = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < kKS; k8 += kChunk) {
        float c[kM][kNT][4];
#pragma unroll
        for (int i = 0; i < kM; ++i)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[i][n][e] = 0.f;
#pragma unroll
        for (int kk = k8; kk < k8 + kChunk && kk < kKS; ++kk) {
          uint32_t a_hi[kM][4], a_lo[kM][4];
#pragma unroll
          for (int i = 0; i < kM; ++i) {
            const float* at = qs + qw + 16 * i * C::kLdQ + 8 * kk;
            if constexpr (C::kQHiRegs) {
              const uint2 l0 = *reinterpret_cast<const uint2*>(at);
              const uint2 l1 =
                  *reinterpret_cast<const uint2*>(at + 8 * C::kLdQ);
#pragma unroll
              for (int e = 0; e < 4; ++e) a_hi[i][e] = q_hi[kk][e];
              a_lo[i][0] = l0.x, a_lo[i][1] = l1.x;
              a_lo[i][2] = l0.y, a_lo[i][3] = l1.y;
            } else {
              a_frag(at, C::kLdQ, a_hi[i], a_lo[i]);
            }
          }
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            T kb0, kb1;
            load_pair(ks + (8 * n + g) * C::kLdK + 8 * kk + 2 * t, kb0, kb1);
            const BFrag bk = b_frag(kb0, kb1);
#pragma unroll
            for (int i = 0; i < kM; ++i) {
              mma(s_lo[i][n], a_lo[i], bk.hi0, bk.hi1);
              if constexpr (sizeof(T) == 4)
                mma(s_lo[i][n], a_hi[i], bk.lo0, bk.lo1);
              mma(c[i][n], a_hi[i], bk.hi0, bk.hi1);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kM; ++i)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[i][n][e] += c[i][n][e];
      }
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][n][e] += s_lo[i][n][e];

      // Mask (unless every row of the warp sees the whole tile), then the
      // online-softmax update of rows g (e = 0, 1) and g+8 (e = 2, 3).
      const bool full = w_hi_min >= k0 + kBK - 1 && w_lo_max <= k0;
      if (!full) {
#pragma unroll
        for (int i = 0; i < kM; ++i)
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0 + 8 * n + 2 * t + (e & 1);
              const int r = e >> 1;
              if (kj < vis_lo[i][r] || kj > vis_hi[i][r])
                s[i][n][e] = kNegInf;
            }
      }
      float alpha[kM][2];
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = kNegInf;
#pragma unroll
          for (int n = 0; n < kNT; ++n)
            mx = fmaxf(mx, fmaxf(s[i][n][2 * r], s[i][n][2 * r + 1]));
          const float m_new = fmaxf(m[i][r], quad_max(mx));
          const float m_log2 = m_new * kLog2e;
          alpha[i][r] = ex2((m[i][r] - m_new) * kLog2e);
          m[i][r] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              s[i][n][e] = s[i][n][e] == kNegInf
                               ? 0.f
                               : ex2(fmaf(s[i][n][e], kLog2e, -m_log2));
              sum += s[i][n][e];
            }
          l[i][r] = l[i][r] * alpha[i][r] + sum;
        }

      // P's A fragments: S's tile n is P's k-step n, with A column t = key
      // 2t and A column t+4 = key 2t+1, so a = (s0, s2, s1, s3).
      uint32_t p_hi[kM][kNT][4], p_lo[kM][kNT][4];
#pragma unroll
      for (int i = 0; i < kM; ++i)
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          split(s[i][n][0], p_hi[i][n][0], p_lo[i][n][0]);
          split(s[i][n][2], p_hi[i][n][1], p_lo[i][n][1]);
          split(s[i][n][1], p_hi[i][n][2], p_lo[i][n][2]);
          split(s[i][n][3], p_hi[i][n][3], p_lo[i][n][3]);
        }
      // O = alpha O + P.V, column tile d at a time: the tile's P.V sums in
      // its own accumulator (a few mma additions, which the tensor cores
      // round toward zero), then joins O in one f32 FMA.
#pragma unroll
      for (int d = 0; d < kKS; ++d) {
        float acc[kM][4];
#pragma unroll
        for (int i = 0; i < kM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          const T* vr = vs + (8 * n + 2 * t) * C::kLdV + 8 * d + g;
          const BFrag bv = b_frag(vr[0], vr[C::kLdV]);
#pragma unroll
          for (int i = 0; i < kM; ++i)
            mma3<T>(acc[i], p_hi[i][n], p_lo[i][n], bv);
        }
#pragma unroll
        for (int i = 0; i < kM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[i][d][e] = fmaf(o[i][d][e], alpha[i][e >> 1], acc[i][e]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }
  cp_async_wait<0>();

  // out (B, S, H, hd), contiguous: rows g and g+8 of each atom, columns
  // 8d + 2t and 8d + 2t + 1.
  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + 16 * (kM * warp + i) + g + 8 * r;
      const float denom = fmaxf(quad_sum(l[i][r]), 1e-30f);
      if (qi >= p.seq_q) continue;
      T* row = og + ((static_cast<long long>(b) * p.seq_q + qi) * p.heads +
                     h) * HD + 2 * t;
#pragma unroll
      for (int d = 0; d < kKS; ++d)
        store2(row + 8 * d, o[i][d][2 * r] / denom,
               o[i][d][2 * r + 1] / denom);
    }
}

template <typename T, int HD>
int launch(const Params& p, cudaStream_t stream) {
  using C = Tile<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params lp = p;
  lp.q_tiles = (p.seq_q + C::kBQ - 1) / C::kBQ;
  const long long blocks = static_cast<long long>(lp.q_tiles) * p.heads *
                           p.batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_kernel<T, HD><<<static_cast<unsigned>(blocks), kThreads,
                                  C::kSmem, stream>>>(lp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
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
  Params p{q,    k,    v,    out,   seq_q, seq_k, heads,  heads / kv_heads,
           batch, 0,    q_sb, q_ss, q_sh,  k_sb,  k_sl,  k_sh,   v_sb,
           v_sl, v_sh, causal, window, q_offset, vec, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(p, head_dim, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(p, head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
