// Flash attention on Hopper's tensor cores (sm_90a): bf16 prefill.
//
// Replaces, for bf16 inputs with Sq > 16 and head dims (dk, dv) of (64, 64),
// (80, 80), (128, 128), (256, 256), (192, 192) or (192, 128), the Pallas TPU
// kernel src/repro/kernels/flash_attention.py, function `flash_attention`
// (:90, pallas_call :118, body `_kernel` :30): every bf16 prefill of the
// served configs (hd 128 gemma2-27b and olmoe-1b-7b, hd 256 gemma-2b, hd 80
// stablelm-3b and zamba2-2.7b's shared attention, hd 192 nemotron-4-340b's
// GQA, and MLA's naive path in deepseek-v3-671b, whose queries and
// keys are 192 wide, qk_nope 128 + rope 64, and its values 128; the Pallas
// kernel takes dk == dv only, so the reference runs that product in jnp).
// Decode steps (Sq <= 16) take flash_decode.cu; f32 prefill and bf16 at
// other head dims take the CUDA-core kernel in flash_attention.cu.  It
// computes what `_kernel` computes:
// out = softmax(mask(cap·tanh(q·kᵀ·scale / cap))) · v per (batch, query
// head), q aligned to the end of k (q_pos = i + Sk − Sq), a key valid when
// k_pos < Sk, k_pos <= q_pos or k_pos < prefix (causal; a prefix-LM's
// bidirectional prefix, which the Pallas kernel lacks: the reference's
// `mask_bias` in models/attention.py) and k_pos > q_pos − window, an
// online softmax with the reference's m_safe / alpha guards and its
// denominator clamped at 1e-30, query head h reading KV head h / (H / Kh),
// the output in q's dtype and layout.
//
// Numerics.  Q·Kᵀ and P·V take bf16 operands and sum in f32 on the tensor
// cores.  The one departure from `_kernel`, which keeps P in f32: P is
// rounded to bf16 before P·V (its row sums stay f32), a relative error of
// at most 2^-9 a weight.  The softcap's tanh is `tanh.approx.f32` (the
// SFU; relative error about 2^-11) and exp is `ex2.approx` on the scores
// pre-multiplied by log2(e).  Both stay inside the bf16 tolerance (3e-2).
//
// Bound on this card: operations.  A causal prefill does 2·(dk + dv) FLOP
// per (query, key) pair the mask keeps; at the serving path's global-layer
// prefill (B 2, H 32, Kh 16, S 4,608, hd 128, bf16) that is 3.48e11 FLOP,
// 0.35 ms at the 989 TFLOP/s bf16 tensor-core peak, against 0.23 GB of
// inputs and output (0.07 ms at 3.35 TB/s).  Besides the products, every
// score costs one ex2 and, with the softcap, one tanh on the SFU (16 a
// clock an SM): as many SM cycles as its share of the products.
//
// Design (right and simple first: no TMA, producer warp or persistent
// grid).  One block of one warpgroup (128 threads) per (64-row Q tile,
// query head, batch row), two blocks an SM.  Q is staged once in shared
// memory; K and V tiles of kBK keys (64; 32 at hd 256 and at (192, 192))
// go through a 2-stage ring filled by 16-byte `cp.async.cg` copies (one
// commit group a tile), so tile t+1's copies run under tile t's products
// and softmax.
// The two blocks of an SM run unsynchronised, so one's softmax overlaps
// the other's products; a block of two warpgroups that share each K/V
// tile (half the copies per row) kept both in step at every tile's
// barrier and was slower (hd 128).  Every tile sits in the 128-byte swizzle
// that the `wgmma` descriptors name: a 64-element bf16 row chunk is one
// 128-byte line, 8 lines make a 1,024-byte atom in which 16-byte unit u of
// line r is stored at unit u ^ (r % 8); a row spans ceil(d / 64) such
// chunks, stored one after the other (chunk-major), d the tile's head dim:
// dk for the Q and K tiles, dv for the V tiles (an instance <DK, DV> sizes
// each by its own).  At hd 80 the second
// chunk holds only units 0 and 1 of each line (elements 64-79); units 2-7
// are never written nor read, so every tile is sized by the padded width.
//   S = Q·Kᵀ: `wgmma.mma_async.m64n{kBK}k16` with A (Q) and B (K) both
//     read from shared memory K-major (dk contiguous), dk/16 k-steps, each
//     advancing the start address 32 bytes inside the swizzle atom and
//     every 4th moving to the next chunk (hd 80: step 4 at offset 0 of
//     chunk 1, which reads just its units 0 and 1).
//   Softmax in registers on the f32 accumulator fragment: thread t holds
//     rows 16·(t/32) + (t%32)/4 and that + 8, columns 8j + 2(t%4) +
//     {0, 1}; row max and sum are two xor shuffles inside the quad.  The
//     mask is evaluated only on tiles that cross the causal diagonal past
//     the prefix, the window's edge or Sk (a tile wholly inside the
//     prefix needs no causal mask); tiles outside the block's band, which
//     under a causal mask ends at the later of its last row's diagonal and
//     the prefix's end, are skipped, which is exact (a fully masked tile
//     leaves m, l and O unchanged).  O is rescaled only when a row max of the warp moved.
//   O += P·V: the S fragment, packed pairwise to bf16x2, is already the
//     A-from-registers fragment of `wgmma ... m64n{DV}k16` (RS form); V
//     (key, dv) is B read MN-major with the transpose bit, its 64-element
//     dv chunks LBO = kBK keys × 128 bytes apart, 8-key groups SBO = 1,024
//     bytes apart.  At hd 80 it is `m64n64k16` on chunk 0 and `m64n16k16`
//     on chunk 1 (whose fragment continues the first's), so no product
//     reads past a tile's live units.
// Registers and shared memory (`-Xptxas -v` prints the registers): O is
// dv / 2 f32 a thread, S kBK / 2.  At hd 256, O alone is 128 registers, so
// the K/V tiles shrink to 32 keys (S 16 registers): Q 32 KB + a 64 KB ring
// = 97 KB, still two blocks an SM as at hd 64 (41 KB), 80 and 128 (81 KB
// each, the hd 80 rows padded to 128 elements).  At (dk 192, dv 128), Q
// 24 KB + a ring of two 24 KB K and 16 KB V tiles + 1 KB of slack = 105 KB:
// two blocks an SM, with hd 128's registers (O 64, S 32).  Zero-padding V
// to 192 instead would do 1.5x the P·V products and write a wider output.
// At (192, 192), O is 96 registers, and P·V is `m64n128k16` on chunks 0-1
// then `m64n64k16` on chunk 2, whose fragment continues the first's (as hd
// 80's second product does).  Its K/V tiles are 32 keys: Q 24 KB + a ring
// of two 12 KB K and 12 KB V tiles + 1 KB = 73 KB, two blocks an SM,
// 178/180 registers, no spills.  At 64 keys (121 KB, one block an SM) it
// took 4.58 ms at nemotron's prefill against 3.73 at 32 keys (NVIDIA H100
// 80GB HBM3, 700 W; tools/tc_tile_ab.py times the two).
// Keys past Sk and Q rows past Sq are zero-filled by the copy's src-size 0
// form (0 × NaN would be NaN); such keys are masked and such rows are not
// stored.  Under a causal mask the heaviest (last) Q tiles launch first.
// Strided (b, h, s) views are taken as they are, as in flash_attention.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // one warpgroup
constexpr int kBQ = 64;        // query rows per block
constexpr int kStages = 2;     // K/V ring depth
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;

// a row of head dim D in whole 64-element chunks
template <int D>
__host__ __device__ constexpr int pad64() { return (D + 63) / 64 * 64; }

// the tile geometry of the instance for head dims DK (q, k) and DV (v)
template <int DK, int DV>
struct Geom {
  static constexpr int kBK =
      DK == 256 || DV == 256 || (DK == 192 && DV == 192) ? 32 : 64;
  static constexpr uint32_t kQBytes = kBQ * pad64<DK>() * 2;  // the Q tile
  static constexpr uint32_t kKBytes = kBK * pad64<DK>() * 2;  // one K tile
  static constexpr uint32_t kVBytes = kBK * pad64<DV>() * 2;  // one V tile
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, s)
  int B, H, Kh, Sq, Sk, hd, group;
  int causal, window;  // window 0: none
  int prefix;           // keys below it visible to every query (causal)
  float scale, softcap;  // softcap 0: none
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// makes the copies' shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products' issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)
#define R32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15}"
#define R64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define R128 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, " \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, " \
  "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"

// d (64 x N, f32; N = 64 or 32 keys) (+)= A (64 x 16) · B (N x 16)ᵀ, both
// K-major in shared memory; scale_d 0 overwrites d
template <int N, int M>
__device__ __forceinline__ void mma_ss(float (&d)[M], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(M == N / 2, "accumulator");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " R16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : F16(d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 64, "wgmma width");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : F16(d, 0), F16(d, 16)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d[OFF, OFF + N / 2) (64 x N, f32) += A (64 x 16, bf16x2 registers) ·
// B (16 x N) with B MN-major in shared memory (transpose bit set)
template <int N, int OFF = 0, int M>
__device__ __forceinline__ void mma_rs(float (&d)[M], const uint32_t (&a)[4],
                                       uint64_t db) {
  static_assert(OFF + N / 2 <= M, "accumulator");
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " R8
        ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : F4(d, OFF), F4(d, OFF + 4)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : F16(d, OFF), F16(d, OFF + 16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : F16(d, OFF), F16(d, OFF + 16), F16(d, OFF + 32), F16(d, OFF + 48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 256, "wgmma width");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " R128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : F16(d, OFF), F16(d, OFF + 16), F16(d, OFF + 32), F16(d, OFF + 48),
          F16(d, OFF + 64), F16(d, OFF + 80), F16(d, OFF + 96),
          F16(d, OFF + 112)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ROWS rows of HD bf16 from `g` (row stride `stride` elements), rows from
// `n_valid` on zero-filled, into the swizzled chunk-major tile at `dst`.
// A row has pad64(HD) / 8 16-byte unit slots (whole 128-byte lines);
// thread tid copies slot tid % slots of rows tid / slots + i · kStep, and
// slots past the row's HD / 8 units (hd 80: 10-15) are padding, never
// copied.  At hd 64, 80 and 128 kStep is a multiple of 8, so a thread's
// swizzle is the same in every row it copies.  At hd 192 (24 slots, which
// do not divide 128 threads) the threads walk the tile's units in turn.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g,
                                          long long stride, int n_valid,
                                          int tid) {
  constexpr int kSlots = pad64<HD>() / 8;
  if constexpr (kThreads % kSlots != 0) {
    static_assert(HD / 8 == kSlots && ROWS * kSlots % kThreads == 0,
                  "whole rows of live units");
#pragma unroll
    for (int i = 0; i < ROWS * kSlots / kThreads; ++i) {
      const int idx = tid + i * kThreads, r = idx / kSlots;
      const int u = idx - r * kSlots;
      const bool ok = r < n_valid;
      cp_async16(dst + (u >> 3) * (ROWS * 128) + r * 128 +
                     (((u & 7) ^ (r & 7)) << 4),
                 ok ? g + r * stride + u * 8 : g, ok ? 16 : 0);
    }
  } else {
    constexpr int kStep = kThreads / kSlots;
    static_assert(ROWS % kStep == 0, "tile split");
    const int row = tid / kSlots, u = tid % kSlots;
    if (u >= HD / 8) return;
    const uint32_t d0 = dst + (u >> 3) * (ROWS * 128) + row * 128;
    const __nv_bfloat16* g0 = g + row * stride + u * 8;
#pragma unroll
    for (int i = 0; i < ROWS / kStep; ++i) {
      const int r = row + i * kStep;
      const int sw = ((u & 7) ^ ((kStep % 8 == 0 ? row : r) & 7)) << 4;
      const bool ok = r < n_valid;
      cp_async16(d0 + i * kStep * 128 + sw,
                 ok ? g0 + i * kStep * stride : g, ok ? 16 : 0);
    }
  }
}

template <int DK, int DV>
constexpr size_t smem_bytes() {
  using G = Geom<DK, DV>;
  // 1 KB of slack to align the tiles to the 1,024-byte swizzle atom
  return 1024 + (size_t)G::kQBytes + kStages * (G::kKBytes + G::kVBytes);
}

// CAPPED: a logit softcap is given (the scores go through tanh)
template <int DK, int DV, bool CAPPED>
__global__ void __launch_bounds__(kThreads, 2)
    flash_tc_kernel(const Params p) {
  using G = Geom<DK, DV>;
  constexpr int kBK = G::kBK;
  constexpr uint32_t kQBytes = G::kQBytes, kKBytes = G::kKBytes;
  constexpr uint32_t kStage = G::kKBytes + G::kVBytes;  // one K + V tile
  constexpr int kNO = DV / 2;   // O accumulator floats a thread
  constexpr int kNS = kBK / 2;  // S accumulator floats a thread
  extern __shared__ uint8_t smem[];
  const uint32_t s_q = (smem_addr(smem) + 1023u) & ~1023u;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = (tid & 31) >> 2, c4 = tid & 3;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.group;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.qs[0] + h * p.qs[1];
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.ks[0] + kh * p.ks[1];
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.vs[0] + kh * p.vs[1];
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] +
                      h * p.os[1];
  const int off = p.Sk - p.Sq;

  // the band of keys the block's rows can see, in whole tiles (off < 0
  // when Sq > Sk: q_first and q_last may be negative)
  const int q_first = q0 + off, q_last = min(q0 + kBQ, p.Sq) - 1 + off;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, max(q_last + 1, p.prefix));
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q_first - p.window + 1);
  k_begin -= k_begin % kBK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  auto load_kv = [&](int tile) {
    const int kt = k_begin + tile * kBK, st = tile % kStages;
    const uint32_t s_k = s_q + kQBytes + st * kStage;
    load_tile<kBK, DK>(s_k, kb + kt * p.ks[2], p.ks[2], p.Sk - kt, tid);
    load_tile<kBK, DV>(s_k + kKBytes, vb + kt * p.vs[2], p.vs[2], p.Sk - kt,
                       tid);
  };
  load_tile<kBQ, DK>(s_q, qb + q0 * p.qs[2], p.qs[2], p.Sq - q0, tid);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  // this thread's two rows (absolute q positions)
  const int row_a = q0 + warp * 16 + g;
  const int qpos[2] = {row_a + off, row_a + 8 + off};
  // the causal mask's last key of each row: its own, or the prefix's last
  const int qlast[2] = {max(qpos[0], p.prefix - 1),
                        max(qpos[1], p.prefix - 1)};
  // a score s becomes x = mul·s, and its logit in log2 units is c·f(x),
  // f = tanh with the softcap (c = cap·log2 e, mul = scale / cap), else
  // the identity (c = 1, mul = scale·log2 e); c > 0, so the row max of
  // f(x) gives the row max of the logits
  const float mul = CAPPED ? p.scale / p.softcap : p.scale * kLog2e;
  const float c = CAPPED ? p.softcap * kLog2e : 1.f;
  // Q's descriptor, advanced per k-step
  const uint64_t dq = make_desc(s_q, 16, 1024);

  float o[kNO];
#pragma unroll
  for (int e = 0; e < kNO; ++e) o[e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and Q) have landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread; tile t - 1's stage is free
    if (t + kStages - 1 < n_tiles) load_kv(t + kStages - 1);
    cp_async_commit();

    const int kt = k_begin + t * kBK;
    const uint32_t s_k = s_q + kQBytes + (t % kStages) * kStage;

    // S = Q·Kᵀ over dk / 16 k-steps; a k-step is 32 bytes inside the
    // swizzle atom, and every 4th one moves to the next 64-element chunk
    float s[kNS];
#pragma unroll
    for (int e = 0; e < kNS; ++e) s[e] = 0.f;
    const uint64_t dk = make_desc(s_k, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks)
      mma_ss<kBK>(s,
                  dq + (((ks >> 2) * (kBQ * 128) + (ks & 3) * 32) >> 4),
                  dk + (((ks >> 2) * (kBK * 128) + (ks & 3) * 32) >> 4),
                  ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // f(x), masked to -1e30 where the tile crosses an edge of the band
#pragma unroll
    for (int e = 0; e < kNS; ++e)
      s[e] = CAPPED ? tanh_approx(s[e] * mul) : s[e] * mul;
    const bool need_mask =
        kt + kBK > p.Sk ||
        (p.causal && kt + kBK - 1 > q_first && kt + kBK > p.prefix) ||
        (p.window > 0 && kt <= q_last - p.window);
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < kNS; ++e) {
        const int k_pos = kt + (e >> 2) * 8 + 2 * c4 + (e & 1);
        const int q_pos = qpos[(e >> 1) & 1];
        bool valid = k_pos < p.Sk;
        if (p.causal) valid = valid && k_pos <= qlast[(e >> 1) & 1];
        if (p.window > 0) valid = valid && k_pos > q_pos - p.window;
        if (!valid) s[e] = kNegInf;
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int e = 0; e < kNS; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
    float m_safe[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a fully masked row gives c·(-1e30) <= -1e30: the guard holds
      const float m_new = fmaxf(m_r[i], c * mx[i]);
      m_safe[i] = m_new <= kNegInf ? 0.f : m_new;
      alpha[i] = m_r[i] <= kNegInf ? 0.f : exp2_approx(m_r[i] - m_safe[i]);
      m_r[i] = m_new;
    }
    // masked scores give exp2(<= -1e30) = 0 exactly
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int e = 0; e < kNS; e += 2) {
      const int i = (e >> 1) & 1;
      const float p0 = exp2_approx(fmaf(c, s[e], -m_safe[i]));
      const float p1 = exp2_approx(fmaf(c, s[e + 1], -m_safe[i]));
      rs[i] += p0 + p1;
      pa[e >> 3][(e >> 1) & 3] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = alpha[i] * l_r[i] + rs[i];
    // alpha is exactly 1 where a row's max did not move; most tiles past
    // the first few leave every row of the warp so
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int e = 0; e < kNO; ++e) o[e] *= alpha[(e >> 1) & 1];
    }

    // O += P·V over kBK / 16 k-steps of 16 keys (16 rows of 128 bytes
    // each); at hd 80 columns 64-79 are a second product on chunk 1
    const uint64_t dv = make_desc(s_k + kKBytes, kBK * 128, 1024);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dvk = dv + ((kk * 16 * 128) >> 4);
      if constexpr (DV == 80) {
        mma_rs<64>(o, pa[kk], dvk);
        mma_rs<16, 32>(o, pa[kk], dvk + ((kBK * 128) >> 4));
      } else if constexpr (DV == 192) {
        mma_rs<128>(o, pa[kk], dvk);
        mma_rs<64, 64>(o, pa[kk], dvk + ((2 * kBK * 128) >> 4));
      } else {
        mma_rs<DV>(o, pa[kk], dvk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  cp_async_wait<0>();  // with no tile in the band, Q's copy is still open

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const float inv[2] = {1.f / fmaxf(l_r[0], 1e-30f),
                        1.f / fmaxf(l_r[1], 1e-30f)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= p.Sq) continue;
    __nv_bfloat16* orow = ob + row * p.os[2] + 2 * c4;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = v2;
    }
  }
}

template <int DK, int DV, bool CAPPED>
int launch(const Params& p, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DK, DV>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DK, DV, CAPPED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + kBQ - 1) / kBQ), (unsigned)p.H,
                  (unsigned)p.B);
  flash_tc_kernel<DK, DV, CAPPED><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int launch_capped(const Params& p, cudaStream_t s) {
  return p.softcap > 0.f ? launch<DK, DV, true>(p, s)
                         : launch<DK, DV, false>(p, s);
}

}  // namespace

// The signature of repro_flash_attention (flash_attention.cu): q (B, H,
// Sq, hd), k (B, Kh, Sk, hd), v (B, Kh, Sk, dv), o (B, H, Sq, dv), as
// element strides of (b, h, s) in `strides` (q, k, v, o; 12 values) with
// unit stride on the head dim and 16-byte aligned rows; window 0, prefix 0
// and softcap 0 mean none.  Takes dtype 1 (bf16) and (hd, dv) of (64, 64),
// (80, 80), (128, 128), (192, 192), (256, 256) or (192, 128) only.  Returns the
// cudaError_t of the attribute call or the launch.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* o,
                                        const long long* strides, int B,
                                        int H, int Kh, int Sq, int Sk, int hd,
                                        int dv, int causal, int window,
                                        int prefix, float scale,
                                        float softcap, int dtype,
                                        void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  for (int e = 0; e < 3; ++e) {
    p.qs[e] = strides[e];
    p.ks[e] = strides[3 + e];
    p.vs[e] = strides[6 + e];
    p.os[e] = strides[9 + e];
  }
  p.B = B; p.H = H; p.Kh = Kh; p.Sq = Sq; p.Sk = Sk; p.hd = hd;
  p.group = H / Kh;
  p.causal = causal; p.window = window; p.prefix = prefix;
  p.scale = scale; p.softcap = softcap;
  if (dtype != 1 || Kh < 1 || H % Kh != 0 || Sq < 1 || Sk < 1 || prefix < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == dv) switch (hd) {
      case 64: return launch_capped<64, 64>(p, s);
      case 80: return launch_capped<80, 80>(p, s);
      case 128: return launch_capped<128, 128>(p, s);
      case 192: return launch_capped<192, 192>(p, s);
      case 256: return launch_capped<256, 256>(p, s);
      default: return (int)cudaErrorInvalidValue;
    }
  if (hd == 192 && dv == 128) return launch_capped<192, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}
