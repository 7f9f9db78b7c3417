// Flash attention (online softmax) for Hopper (sm_90a) on the tensor cores:
// bf16 tiles moved by TMA into a shared-memory ring, multiplied by wgmma.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_make_kernel`) for bf16 q, k,
// v with head_dim 64, 128 or 256; csrc/flash_attention.cu stays the route
// for float32, head_dim 32 and views TMA cannot address. For q (B, S, H, hd)
// and k, v (B, L, Kv, hd), with query head h reading KV head h / (H / Kv):
//
//   out[b, i, h] = sum_j p_ij v[b, j, kvh] / max(sum_j p_ij, 1e-30)
//   p_ij         = mask_ij ? exp(s_ij - max_j' s_ij') : 0
//   s_ij         = hd^-0.5 q[b, i, h] . k[b, j, kvh]
//   mask_ij      = j < L, (causal: i + q_offset >= j),
//                  (window: i + q_offset - j < window)
//
// Numbers as in the Pallas body: S = Q.K^T is exact bf16 products summed in
// f32; the scale is applied to S in f32, folded with log2(e) into exp2 (the
// running max is kept in that domain, starting at the -1e30 sentinel);
// masked probabilities are 0; l is floored at 1e-30, so a row that sees no
// key comes out 0. p stays f32 in effect: it is split as
// p = p_hi + p_lo with p_hi = bf16(p), p_lo = bf16(p - p_hi), and P.V runs
// twice (residual ~2^-16 p), where one bf16 rounding of p would cost up to
// ~2e-3 |v| on rows that see few keys.
//
// What bounds it: operations. Causal prefill at the served shape (B 4,
// S = L 2,048, H 32, Kv 8, hd 64) needs 4*B*H*hd*S*(S+1)/2 = 68.7 GFLOP on
// 84 MB of q, k, v and out: 0.0695 ms at the tensor cores' 989 TFLOP/s,
// 0.025 ms at 3.35 TB/s. The hi/lo split makes the tensor-core work 1.5x
// that (103 GFLOP), plus one exp2 per visible score on the SFUs. The same
// holds at recurrentgemma-2b's local attention (B 4, S = L 4,096, H 10,
// Kv 1, hd 256, window 2,048): 258 GFLOP of visible keys on 185 MB.
//
// Design: one block of 2 consumer warpgroups (and at hd 64 and 128 a
// producer warp) per 128-row query tile of one (head, batch row). One
// thread loads the Q tile once and then K and V tiles of BK keys (128 at
// hd 64, 64 at hd 128 and 256) with cp.async.bulk.tensor into a ring of
// kStages stages under full mbarriers; the producer warp refills a stage
// when its empty mbarrier completes, and at hd 256 the last consumer warp
// to release it does (Tile). Each consumer warpgroup owns 64 query rows;
// its S, P and O registers fit the 168 a thread of the 288-thread block
// gets at hd 64 and 128 (ptxas: no spills), which is why hd 128 takes
// 64-key tiles; at hd 256 they take 213 of the 255 a thread of the
// 256-thread block may use. At hd 256 the Q tile (64 KB) and two stages
// of K and V (128 KB) take 192 KB of shared memory, so one block runs on
// an SM. Per KV tile a consumer runs
// S = Q.K^T as wgmma m64nBKk16 with both operands in shared memory (K in
// the model's (key, hd) layout is K-major for B), the online softmax on the
// accumulator registers, then O += P.V as wgmma m64nHDk16 with A = P from
// registers (the S accumulator's layout, packed to bf16 pairs, is the
// A-operand layout) and B = V through the instruction's transpose-B. Each
// warpgroup does these in order; the two warpgroups overlap only as the
// warp schedulers interleave them. The tensor maps are 4-D over the
// tensors' own (hd, H, S, B) strides with 128-byte swizzle, which the
// wgmma descriptors match; a row of hd 128 or 256 is two or four 64-column
// panels. TMA zero-fills the ragged S and L edges per (batch
// row, head); keys at or past L are still masked. KV tiles that the causal
// or window mask hides from all of a warpgroup's rows are not computed
// (they leave m, l and acc unchanged in the Pallas body); only tiles that
// cross the diagonal, the window's edge or L are masked elementwise. Query
// tiles are issued longest-first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBQ = 128;          // query rows per block, 64 per consumer
constexpr int kConsumers = 256;   // 2 consumer warpgroups (8 warps)
constexpr int kStages = 2;        // K/V ring depth
constexpr int kRowBytes = 128;    // one 128-byte swizzle row: 64 bf16
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 2000;   // + CUresult of cuTensorMapEncodeTiled

// Who refills the K/V ring, and so how many registers a consumer thread
// gets. At hd 64 and 128 a producer warp waits on each stage's empty
// barrier and reloads it; the consumers' S, P and O fit the 168 registers
// ptxas gives every thread of that 288-thread block. At hd 256 O alone is
// 128 f32 a thread, and ptxas holds a block of more than 256 threads to 168
// registers a thread whether or not setmaxnreg moves registers between its
// warpgroups: it spills and serializes the wgmmas (the producer_warp and
// setmaxnreg variants of tools/flash_sm90_ablation.py). So at hd 256
// there is no producer: the last of the 8 consumer warps to release a
// stage reloads it (a counter per stage), and the 256 threads get up to
// 255 registers.
template <int HD>
struct Tile {
  static constexpr int kBK = HD == 64 ? 128 : 64;     // keys per KV tile
  static constexpr int kPanels = HD / 64;             // 64-column panels
  static constexpr bool kProducerWarp = HD != 256;
  static constexpr int kThreads = kConsumers + (kProducerWarp ? 32 : 0);
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;       // one K or V tile
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  // barriers (q, full[kStages], empty[kStages]), then a release counter per
  // stage, and slack to align to 1024
  static constexpr int kCountOff = kBarOff + 8 * (1 + 2 * kStages);
  static constexpr int kSmem = kCountOff + 4 * kStages + 1024;
};

struct Params {
  __nv_bfloat16* out;
  int seq_q, seq_k, heads, group;     // S, L, H, H / Kv
  int causal, window, q_offset;       // window < 0: none
  float scale_log2;                   // hd^-0.5 * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits until the barrier's phase of the given parity has completed. A
// pipeline that never completes traps after ~2^34 cycles (~9 s), so a fault
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One TMA load of a (64, 1, rows, 1) box at (c0, c1, c2, c3) of a 4-D map.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// Adds 1 to a counter in shared memory and returns its old value; orders
// this thread's earlier accesses before the add, and the add before its
// later ones (acq_rel), so the thread that sees a stage's last release
// also sees every earlier release's reads done.
__device__ __forceinline__ uint32_t smem_count(uint32_t addr) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "r"(addr), "r"(1u) : "memory");
  return old;
}

// Loads the block's Q tile (128 rows of head h from row q0) and arms the
// Q barrier.
template <int HD>
__device__ __forceinline__ void load_q(uint32_t base, const CUtensorMap* tm_q,
                                       int h, int q0, int b) {
  const uint32_t bar_q = base + Tile<HD>::kBarOff;
  mbar_expect_tx(bar_q, Tile<HD>::kQBytes);
  for (int pn = 0; pn < Tile<HD>::kPanels; ++pn)
    tma_load(base + pn * kBQ * kRowBytes, tm_q, bar_q, 64 * pn, h, q0, b);
}

// Loads KV tile t of KV head kvh into ring stage `stage` and arms its full
// barrier.
template <int HD>
__device__ __forceinline__ void load_kv(uint32_t base, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int stage,
                                        int kvh, int t, int b) {
  using T = Tile<HD>;
  const uint32_t full = base + T::kBarOff + 8 * (1 + stage);
  const uint32_t k_tile = base + T::kKOff + stage * T::kKVBytes;
  const uint32_t v_tile = base + T::kVOff + stage * T::kKVBytes;
  mbar_expect_tx(full, 2 * T::kKVBytes);
  for (int pn = 0; pn < T::kPanels; ++pn) {
    tma_load(k_tile + pn * T::kBK * kRowBytes, tm_k, full, 64 * pn, kvh,
             t * T::kBK, b);
    tma_load(v_tile + pn * T::kBK * kRowBytes, tm_v, full, 64 * pn, kvh,
             t * T::kBK, b);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle. For a K-major operand
// (rows of 64 bf16 at 128 bytes) sbo is the 1024-byte step between 8-row
// groups and lbo is unused; for an MN-major one lbo steps to the next 64
// columns of N and sbo to the next 8 rows of K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of wgmma accumulators across the
// wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// d (64 x 128) = (accumulate ? d : 0) + a (64 x 16) . b (16 x 128), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = (accumulate ? d : 0) + a (64 x 16) . b (16 x 64), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += a (64 x 16, bf16 pairs in registers) . b (16 x 64,
// MN-major in shared memory: the instruction's transpose-B).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 128) += a (64 x 16, bf16 pairs in registers) . b (16 x 128,
// MN-major in shared memory: the instruction's transpose-B).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (64 x 256) += a (64 x 16, bf16 pairs in registers) . b (16 x 256,
// MN-major in shared memory: the instruction's transpose-B).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

template <int N>
__device__ __forceinline__ void mma_s(float (&d)[N / 2], uint64_t a,
                                      uint64_t b, int accumulate) {
  if constexpr (N == 128) wgmma_ss_n128(d, a, b, accumulate);
  else wgmma_ss_n64(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 256) wgmma_rs_n256(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n64(d, a, b);
}

// The online-softmax step on one tile's scores s (raw Q.K^T): masks those
// whose bit in seen is clear (when kMasked), updates the running max m (in
// the scaled log2 domain; the raw max is scaled once, as the scale is > 0)
// and this thread's share l of each row's sum, and returns each row's
// rescale factor alpha and p = exp2(s * scale - m) split into bf16 pairs
// p_hi + p_lo in the A-operand layout of the next wgmma. A masked score is
// -inf here, so exp2 gives its p = 0 exactly; the running max starts at the
// -1e30 sentinel, as in the Pallas body.
template <int NS, bool kMasked>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NS], uint64_t seen, float scale_log2, float (&m)[2],
    float (&l)[2], float (&alpha)[2], uint32_t (&p_hi)[NS / 2],
    uint32_t (&p_lo)[NS / 2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (kMasked && !((seen >> i) & 1)) s[i] = -INFINITY;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fmaxf(m[r], mx[r] * scale_log2);
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const int r = (i / 2) % 2;
    const float e0 = ex2(fmaf(s[i], scale_log2, -mx[r]));
    const float e1 = ex2(fmaf(s[i + 1], scale_log2, -mx[r]));
    l[r] += e0 + e1;
    p_hi[i / 2] = pack_bf16(e0, e1);
    const float2 hi = unpack_bf16(p_hi[i / 2]);
    p_lo[i / 2] = pack_bf16(e0 - hi.x, e1 - hi.y);
  }
}

// One consumer warpgroup: 64 query rows, rows r0 = first + lane / 4 and
// r0 + 8 per thread. Accumulator element i of a thread sits at row
// r0 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
// Without a producer warp (Tile::kProducerWarp false) the warp whose
// release of a stage is its 8th reloads it with tile t + kStages.
template <int HD>
__device__ __forceinline__ void consume(const Params& p, uint32_t base,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int wg,
                                        int q0, int h, int kvh, int b,
                                        int t_begin, int t_end) {
  using T = Tile<HD>;
  constexpr int BK = T::kBK;
  constexpr int NS = BK / 2;    // S floats per thread
  constexpr int NO = HD / 2;    // O floats per thread
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int c2 = 2 * (lane % 4);
  const int wr_lo = q0 + 64 * wg;                    // this warpgroup's rows
  const int wr_hi = min(wr_lo + 64, p.seq_q) - 1;    // last valid one
  const int r0 = wr_lo + 16 * warp + lane / 4;
  const uint32_t bar_q = base + T::kBarOff;
  const uint32_t q_rows = base + 64 * wg * kRowBytes;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};     // this thread's share of each row's sum

  mbar_wait(bar_q, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    const uint32_t full = bar_q + 8 * (1 + stage);
    const uint32_t empty = bar_q + 8 * (1 + kStages + stage);
    mbar_wait(full, phase);
    const bool visible =
        wr_hi >= wr_lo && (!p.causal || k0 <= wr_hi + p.q_offset) &&
        (p.window < 0 || wr_lo + p.q_offset - (k0 + BK - 1) < p.window);
    if (visible) {
      const uint32_t k_tile = base + T::kKOff + stage * T::kKVBytes;
      const uint32_t v_tile = base + T::kVOff + stage * T::kKVBytes;
      float s[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;   // 16 bf16 along hd
        const uint64_t da = sw128_desc(
            q_rows + (kk / 4) * kBQ * kRowBytes + col, 16, 1024);
        const uint64_t db = sw128_desc(
            k_tile + (kk / 4) * BK * kRowBytes + col, 16, 1024);
        mma_s<BK>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      const bool masked =
          k0 + BK > p.seq_k ||
          (p.causal && k0 + BK - 1 > wr_lo + p.q_offset) ||
          (p.window >= 0 && wr_hi + p.q_offset - k0 >= p.window);
      uint64_t seen = ~0ull;    // bit i: score i is visible
      if (masked) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int pos = r0 + 8 * ((i / 2) % 2) + p.q_offset;
          const int key = k0 + 8 * (i / 4) + c2 + i % 2;
          const bool ok = key < p.seq_k && (!p.causal || pos >= key) &&
                          (p.window < 0 || pos - key < p.window);
          if (!ok) seen &= ~(1ull << i);
        }
      }
      float alpha[2];
      uint32_t p_hi[NS / 2], p_lo[NS / 2];
      if (masked)
        softmax_tile<NS, true>(s, seen, p.scale_log2, m, l, alpha, p_hi, p_lo);
      else
        softmax_tile<NS, false>(s, seen, p.scale_log2, m, l, alpha, p_hi,
                                p_lo);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i / 2) % 2];

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // keys 16kk..16kk+15: two 8-row groups of V, 1024 bytes apart
        const uint64_t db = sw128_desc(v_tile + kk * 16 * kRowBytes,
                                       BK * kRowBytes, 1024);
        const uint32_t a_hi[4] = {p_hi[4 * kk], p_hi[4 * kk + 1],
                                  p_hi[4 * kk + 2], p_hi[4 * kk + 3]};
        const uint32_t a_lo[4] = {p_lo[4 * kk], p_lo[4 * kk + 1],
                                  p_lo[4 * kk + 2], p_lo[4 * kk + 3]};
        mma_pv<HD>(o, a_hi, db);
        mma_pv<HD>(o, a_lo, db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) {
      if constexpr (T::kProducerWarp) {
        mbar_arrive(empty);
      } else if (smem_count(base + T::kCountOff + 4 * stage) % 8 == 7 &&
                 t + kStages < t_end) {
        load_kv<HD>(base, tm_k, tm_v, stage, kvh, t + kStages, b);
      }
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // out (B, S, H, hd), contiguous
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = r0 + 8 * r;
    if (row >= p.seq_q) continue;
    __nv_bfloat16* dst =
        p.out + ((static_cast<long long>(b) * p.seq_q + row) * p.heads + h) *
                    HD + c2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <int HD>
__global__ void __launch_bounds__(Tile<HD>::kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const Params p) {
  using T = Tile<HD>;
  constexpr int BK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1024-byte line: the swizzle pattern's period
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_q = base + T::kBarOff;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // the KV tiles some row of this block can see
  const int pos_lo = q0 + p.q_offset;
  const int pos_hi = min(q0 + kBQ, p.seq_q) - 1 + p.q_offset;
  const int k_end = p.causal ? min(p.seq_k, pos_hi + 1) : p.seq_k;
  const int k_begin = p.window >= 0 ? max(0, pos_lo - p.window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_q + 8 * (1 + s), 1);               // full: one arrive
      mbar_init(bar_q + 8 * (1 + kStages + s), 8);     // empty: 8 warps
      asm volatile("st.shared::cta.u32 [%0], 0;\n"
                   ::"r"(base + T::kCountOff + 4 * s) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int kvh = h / p.group;
  if constexpr (T::kProducerWarp) {
    if (threadIdx.x >= kConsumers) {
      // the producer warp: one thread issues every load
      if (threadIdx.x == kConsumers) {
        load_q<HD>(base, &tm_q, h, q0, b);
        int stage = 0;
        uint32_t phase = 0;
        for (int t = t_begin; t < t_end; ++t) {
          mbar_wait(bar_q + 8 * (1 + kStages + stage), phase ^ 1);
          load_kv<HD>(base, &tm_k, &tm_v, stage, kvh, t, b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
  } else if (threadIdx.x == 0) {
    // the ring's first fill; the consumers refill it
    load_q<HD>(base, &tm_q, h, q0, b);
    for (int s = 0; s < kStages && t_begin + s < t_end; ++s)
      load_kv<HD>(base, &tm_k, &tm_v, s, kvh, t_begin + s, b);
  }
  consume<HD>(p, base, &tm_k, &tm_v, threadIdx.x / 128, q0, h, kvh, b,
              t_begin, t_end);
}

// cuTensorMapEncodeTiled, found through the runtime so that the build needs
// no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 4-D map over (hd, heads, seq, batch) with the given element strides,
// loading (64, 1, rows, 1) boxes with 128-byte swizzle; out-of-range rows
// read as zeros.
int encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int hd,
           int heads, int seq, int batch, long long s_h, long long s_s,
           long long s_b, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_s) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int batch, int kv_heads, const long long* st, cudaStream_t stream) {
  using T = Tile<HD>;
  EncodeTiled fn;
  cudaError_t e = encoder(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode(fn, &tm_q, q, HD, p.heads, p.seq_q, batch, st[2], st[1],
                   st[0], kBQ);
  if (!err)
    err = encode(fn, &tm_k, k, HD, kv_heads, p.seq_k, batch, st[5], st[4],
                 st[3], T::kBK);
  if (!err)
    err = encode(fn, &tm_v, v, HD, kv_heads, p.seq_k, batch, st[8], st[7],
                 st[6], T::kBK);
  if (err) return err;
  e = cudaFuncSetAttribute(flash_attention_sm90_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.seq_q + kBQ - 1) / kBQ, p.heads, batch);
  flash_attention_sm90_kernel<HD>
      <<<grid, T::kThreads, T::kSmem, stream>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, S, H, hd), k and v (B, L, Kv, hd), bfloat16, unit stride along hd,
// the other strides in elements: 16-byte aligned pointers and strides that
// are multiples of 16 bytes (8 elements). out (B, S, H, hd) bf16,
// contiguous. head_dim is 64, 128 or 256; window < 0 means no window.
// Returns the CUDA error code of the launch, or 2000 + the CUresult of a
// tensor map that could not be encoded.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, int head_dim,
    int batch, int seq_q, int seq_k, int heads, int kv_heads, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_sl,
    long long k_sh, long long v_sb, long long v_sl, long long v_sh,
    int causal, int window, int q_offset, float scale, void* stream) {
  const Params p{static_cast<__nv_bfloat16*>(out), seq_q, seq_k, heads,
                 heads / kv_heads, causal, window, q_offset,
                 scale * kLog2e};
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_sl, k_sh,
                           v_sb, v_sl, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(q, k, v, p, batch, kv_heads, st, s);
  if (head_dim == 128) return launch<128>(q, k, v, p, batch, kv_heads, st, s);
  if (head_dim == 256) return launch<256>(q, k, v, p, batch, kv_heads, st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_sm90_error_string(int err) {
  static char msg[96];
  if (err >= kEncodeError) {
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled failed, CUresult %d",
             err - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
