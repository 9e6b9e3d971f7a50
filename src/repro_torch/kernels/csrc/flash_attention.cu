// Flash attention (causal / sliding window / logit softcap, GQA) on Hopper
// (sm_90a), f32 arithmetic on the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function `flash_attention` (:90, pallas_call :118, body `_kernel` :30):
// out = softmax(mask(cap·tanh(q·kᵀ·scale / cap))) · v per (batch, query
// head), with q aligned to the end of k (q_pos = i + Sk − Sq), a key valid
// when k_pos < Sk, k_pos <= q_pos or k_pos < prefix (causal; a prefix-LM's
// bidirectional prefix, the reference's `mask_bias`) and k_pos > q_pos −
// window, an online softmax with the reference's guards for fully masked
// rows (m_safe, alpha) and its denominator clamped at 1e-30.  Query head h reads KV head
// h / (H / Kh); K and V are never broadcast.  q and k have head dim dk, v
// and the output their own head dim dv (MLA: dk = qk_nope + rope, dv =
// v_head_dim; the scale is the caller's, 1/√dk).  Inputs f32 or bf16, all
// arithmetic f32 (the tensor cores' TF32 cannot hold f32's 2e-5), output in
// q's dtype.
//
// Bound on this card: operations.  A causal prefill does 4·hd FLOP per
// (query, key) pair that the mask keeps and reads each input once; at the
// serving path's global-layer prefill (B 2, H 32, Kh 16, S 4,608, hd 128)
// that is 3.48e11 FLOP, 5.19 ms at the 67 TFLOP/s f32 rate outside the
// tensor cores, against 0.45 GB of f32 bytes (0.14 ms at 3.35 TB/s).
//
// Design: both products are register-tiled as in an SGEMM, so every float
// read from shared memory feeds 4 FMAs.  A block of 128 threads owns BQ
// query rows and walks the band of BK-key tiles:
//   - S = Q Kᵀ: the TPR threads of a row group share its 8 rows.  Thread
//     (cg, h) of a row group computes an 8 × 8 tile of S (8 rows, keys
//     cg + CG·j) over its part h of hd (NH parts, interleaved by 16-byte
//     chunk), reading float4s of its Q rows and K keys; then a
//     reduce-scatter over the NH parts (xor shuffles) leaves each thread
//     the full sums of 8 rows × 8/NH keys.
//   - Softmax: each row's max stays within the TPR lanes that own the row
//     (xor shuffles); e^(x − m) is 2^(x·log2 e − ml) with the difference
//     in one FMA, on the MUFU (ex2.approx, ~2^-22 relative), and ml =
//     m·log2 e rounded once for each new max and kept, so rescaling by
//     2^(ml_old − ml) lets no rounding of ml compound over the tiles; a
//     lane keeps its own share of the row sum, and the shares are summed
//     once, after the last tile; O is rescaled only when the row max moved.
//     P goes to shared memory, row-major.
//   - O += P V: the same thread owns the same 8 rows × 8 output columns
//     (16-byte chunks t and t + TPR), reading float4s of P along keys and
//     of V along hd.
// Geometry (Geom below), by HDM, max(dk, dv) padded to 64, 128 or 256:
// HDM 64: 128 rows × 64 keys; 128: 64 × 64; 256: 32 × 32.  Q and K tiles
// hold dk of HDM columns, V tiles dv (the rest zero-filled: a padded V
// column adds 0 to an output column that is never stored); the output
// register tile spans HDM columns, and columns past dv are not stored.
// Shared memory: Q (BQ × HDM), two slots (BK × HDM) and P (BQ × BK), f32,
// unpadded: 96, 112 and 100 KB, so two blocks fit an SM
// (8 warps; 254 registers a thread, no spills).  The slots are a ring that
// alternates K and V: V_j loads during S_j, and K_{j+1} during P_j V_j,
// through cp.async (16 bytes, zero-filled past Sk and past dk or dv; a thread
// copies one fixed chunk of every (NT / C)-th row) for f32; bf16 is
// converted to f32 on its way to shared memory through registers
// (synchronous; no config serves bf16 on this kernel).  Two barriers a
// tile: one after K_j's wait, one after V_j's.  K and V rows are stored
// with their 16-byte chunks permuted (chunk c of key r at
// c ^ ((r & SWM)·NH)), so the 8 lanes of a quarter-warp read 8 different
// bank groups; Q and P reads are broadcasts within a quarter-warp and
// need none.  The K loop starts and ends at the causal/window band of the
// tile's rows (under a causal mask it ends at the later of the last row's
// diagonal and the prefix's end); skipping the tiles outside it is exact,
// since a fully masked tile leaves m, l and acc unchanged.  The q tiles run in reverse
// order, so the heaviest causal tiles start first.  Keys past Sk are
// zero-filled and masked, query rows past Sq are computed and not stored,
// and a warp whose rows all lie past Sq skips the arithmetic.  The softcap
// is cap · tanhf(x · (scale / cap)) with the precise tanhf (tanh.approx
// misses 2e-5).  Strided (b, h, s) views are taken as they are (the model
// passes (B, S, H, hd) tensors and slices of the (B, C, Kh, hd) cache), so
// no transpose or copy precedes a launch.  No atomics: the result is the
// same from call to call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;           // query rows a thread (both products)
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, s)
  int B, H, Kh, Sq, Sk, hd, dv, group;  // hd: dk, of q and k
  int causal, window;  // window 0: none
  int prefix;           // keys below it visible to every query (causal)
  float scale, softcap;  // softcap 0: none
};

// query rows and keys a tile, per padded head_dim
template <int HDM>
struct Geom;
template <>
struct Geom<64> { static constexpr int BQ = 128, BK = 64; };
template <>
struct Geom<128> { static constexpr int BQ = 64, BK = 64; };
template <>
struct Geom<256> { static constexpr int BQ = 32, BK = 32; };

template <int HDM>
struct Tile {
  static constexpr int BQ = Geom<HDM>::BQ, BK = Geom<HDM>::BK;
  static constexpr int NT = kThreads, RPT = kRows;
  static constexpr int C = HDM / 4;            // 16-byte chunks a row
  static constexpr int RG = BQ / RPT;          // row groups
  static constexpr int TPR = NT / RG;          // threads a row group
  static constexpr int CG = BK / 8;            // key groups of S
  static constexpr int NH = TPR / CG;          // parts of hd in S
  static constexpr int KPT = 8 / NH;           // keys a thread keeps
  static constexpr int SWM = 8 / NH - 1;       // chunk permutation mask
  static constexpr int ROWS_PER_WARP = 32 / TPR * RPT;
  static_assert(C == 2 * TPR, "two output chunks a thread");
  static_assert(NH >= 1 && NH <= 8 && CG * NH == TPR, "thread layout");
  static constexpr size_t smem =
      sizeof(float) * ((size_t)BQ * HDM + 2 * (size_t)BK * HDM +
                       (size_t)BQ * BK);
};

// 2^x on the MUFU (relative error ~2^-22; results below 2^-126 flush to
// 0, weights that no sum can see)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  // rows [row0, row0 + ROWS) of a (s, hd) view with row stride `stride`
  // into dst (ROWS × HDM), chunk c of row r at c ^ perm(r); rows at or
  // past `limit` and chunks past hd are zero-filled
  template <int HDM, int ROWS, int SWM, int NH, int NT>
  __device__ static void tile(float* dst, const float* src, long long stride,
                              int row0, int limit, int hd) {
    constexpr int C = HDM / 4;
    static_assert(NT % C == 0 && ROWS % (NT / C) == 0, "whole rows a pass");
    // thread t copies chunk t % C of rows t / C + (NT / C)·it
    const int c = threadIdx.x % C;
#pragma unroll
    for (int it = 0; it < ROWS / (NT / C); ++it) {
      const int r = threadIdx.x / C + (NT / C) * it;
      const bool ok = row0 + r < limit && 4 * c < hd;
      const float* g = ok ? src + (long long)(row0 + r) * stride + 4 * c : src;
      cp_async16(dst + r * HDM + 4 * (c ^ ((r & SWM) * NH)), g, ok);
    }
  }
  __device__ static void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Io<__nv_bfloat16> {
  template <int HDM, int ROWS, int SWM, int NH, int NT>
  __device__ static void tile(float* dst, const __nv_bfloat16* src,
                              long long stride, int row0, int limit, int hd) {
    constexpr int U = HDM / 8;  // 8-element units a row
    static_assert(NT % U == 0 && ROWS % (NT / U) == 0, "whole rows a pass");
    const int u = threadIdx.x % U;
#pragma unroll 4
    for (int it = 0; it < ROWS / (NT / U); ++it) {
      const int r = threadIdx.x / U + (NT / U) * it;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < limit && 8 * u < hd)
        raw = *reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * stride + 8 * u);
      const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float f[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(b[e]);
        f[2 * e] = x.x;
        f[2 * e + 1] = x.y;
      }
      const int perm = (r & SWM) * NH;
      *reinterpret_cast<float4*>(dst + r * HDM + 4 * ((2 * u) ^ perm)) =
          make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(dst + r * HDM + 4 * ((2 * u + 1) ^ perm)) =
          make_float4(f[4], f[5], f[6], f[7]);
    }
  }
  __device__ static void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    memcpy(&raw.x, &lo, sizeof(lo));
    memcpy(&raw.y, &hi, sizeof(hi));
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename T, int HDM>
__global__ void __launch_bounds__(Tile<HDM>::NT, 2)
    flash_kernel(const Params p) {
  using G = Tile<HDM>;
  constexpr int BQ = G::BQ, BK = G::BK, C = G::C, TPR = G::TPR, CG = G::CG,
                NH = G::NH, KPT = G::KPT, SWM = G::SWM, NT = G::NT,
                RPT = G::RPT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * HDM;  // slot A: K tiles
  float* Vs = Ks + BK * HDM;  // slot B: V tiles
  float* Ps = Vs + BK * HDM;

  const int tid = threadIdx.x;
  const int rg = tid / TPR, t = tid % TPR, cg = t / NH, h = t % NH;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int kh = hq / p.group;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + hq * p.qs[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kh * p.ks[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kh * p.vs[1];
  T* ob = static_cast<T*>(p.o) + b * p.os[0] + hq * p.os[1];

  // the band of keys this tile's rows can see (off < 0 when Sq > Sk)
  const int off = p.Sk - p.Sq;
  int k_end = p.Sk;
  if (p.causal)
    k_end = min(k_end, max(min(q0 + BQ, p.Sq) - 1 + off + 1, p.prefix));
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 + off - p.window + 1);
  k_begin -= k_begin % BK;
  const bool live = q0 + (tid >> 5) * G::ROWS_PER_WARP < p.Sq;

  // per row: the max so far, m·log2 e as the exponents used (ml), this
  // lane's share of the sum, and the output columns
  float m_i[RPT], ml_i[RPT], l_i[RPT], acc[RPT][8];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m_i[r] = kNegInf;
    ml_i[r] = 0.f;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }

  if (k_begin < k_end) {
    Io<T>::template tile<HDM, BQ, 0, 1, NT>(Qs, qb, p.qs[2], q0, p.Sq, p.hd);
    Io<T>::template tile<HDM, BK, SWM, NH, NT>(Ks, kb, p.ks[2], k_begin,
                                               p.Sk, p.hd);
  }
  cp_async_commit();

  // this thread's K rows (keys cg + CG·j) share one chunk permutation
  const int kperm = (cg & SWM) * NH;
  const float* qrow = Qs + rg * RPT * HDM + 4 * h;
  const float* krow = Ks + cg * HDM;
  float* prow = Ps + rg * RPT * BK;
  // cap · tanh(x · scale / cap) with scale / cap folded once
  const float cap_scale = p.softcap > 0.f ? p.scale / p.softcap : 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    cp_async_wait_all();
    __syncthreads();  // K_j (and Q) landed; P_{j-1} V_{j-1} is done
    Io<T>::template tile<HDM, BK, SWM, NH, NT>(Vs, vb, p.vs[2], kt, p.Sk,
                                               p.dv);
    cp_async_commit();

    if (live) {
      float s[RPT][8];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[r][j] = 0.f;
#pragma unroll 2
      for (int i = 0; i < C / NH; ++i) {
        // chunk NH·i + h of hd; its place in K rows is permuted
        const int kc = 4 * ((NH * i + h) ^ kperm);
        float4 kv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kv[j] = *reinterpret_cast<const float4*>(krow + j * CG * HDM + kc);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qrow + r * HDM + 4 * NH * i);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[r][j] = fmaf(qv.x, kv[j].x, s[r][j]);
            s[r][j] = fmaf(qv.y, kv[j].y, s[r][j]);
            s[r][j] = fmaf(qv.z, kv[j].z, s[r][j]);
            s[r][j] = fmaf(qv.w, kv[j].w, s[r][j]);
          }
        }
      }
      // reduce-scatter over the NH parts of hd: after it, slot NH·u holds
      // the full sum for key index j = NH·u + h
#pragma unroll
      for (int bit = 1; bit < NH; bit <<= 1) {
        const bool up = (h & bit) != 0;
#pragma unroll
        for (int j = 0; j < 8; j += 2 * bit)
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float a0 = s[r][j], a1 = s[r][j | bit];
            const float give = up ? a0 : a1;
            const float keep = up ? a1 : a0;
            s[r][j] = keep + __shfl_xor_sync(kFull, give, bit);
          }
      }
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int q_pos = q0 + rg * RPT + r + off;
        // the causal mask's last key: the row's own, or the prefix's last
        const int last = max(q_pos, p.prefix - 1);
        float mx = kNegInf;
        unsigned ok = 0u;
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          const int k_pos = kt + cg + CG * (NH * u + h);
          const float x = p.softcap > 0.f
                              ? p.softcap * tanhf(s[r][NH * u] * cap_scale)
                              : s[r][NH * u] * p.scale;
          bool valid = k_pos < p.Sk;
          if (p.causal) valid = valid && k_pos <= last;
          if (p.window > 0) valid = valid && k_pos > q_pos - p.window;
          ok |= valid ? 1u << u : 0u;
          s[r][NH * u] = valid ? x : kNegInf;
          mx = fmaxf(mx, s[r][NH * u]);
        }
#pragma unroll
        for (int sh = 1; sh < TPR; sh <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, sh));
        const float m_new = fmaxf(m_i[r], mx);
        const float m_safe = m_new <= kNegInf ? 0.f : m_new;
        // e^(x − m) as 2^(x·log2 e − ml), the difference in one FMA, with
        // ml = m·log2 e rounded once; the old terms move to the new ml by
        // 2^(ml_old − ml), exactly 1 while the max holds, so no rounding of
        // ml compounds from tile to tile
        const float m_l2 = m_new == m_i[r] ? ml_i[r] : m_safe * kLog2e;
        const float alpha = m_i[r] <= kNegInf ? 0.f
                            : m_new == m_i[r] ? 1.f
                                              : ex2(ml_i[r] - m_l2);
        float rs = 0.f;
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          const float pj = (ok >> u) & 1u
                               ? ex2(fmaf(s[r][NH * u], kLog2e, -m_l2))
                               : 0.f;
          rs += pj;
          prow[r * BK + cg + CG * (NH * u + h)] = pj;
        }
        // this lane's share of the row sum; the lanes' shares are summed
        // once, after the last tile
        l_i[r] = alpha * l_i[r] + rs;
        m_i[r] = m_new;
        ml_i[r] = m_l2;
        if (alpha != 1.f)  // the row max moved
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] *= alpha;
      }
    }

    cp_async_wait_all();
    __syncthreads();  // V_j landed, P_j written, S_j done with slot A
    if (kt + BK < k_end)
      Io<T>::template tile<HDM, BK, SWM, NH, NT>(Ks, kb, p.ks[2], kt + BK,
                                                 p.Sk, p.hd);
    cp_async_commit();

    if (live) {
#pragma unroll 2
      for (int kk = 0; kk < BK; kk += 4) {
        float4 pv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          pv[r] = *reinterpret_cast<const float4*>(prow + r * BK + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kk + e;
          const float* vrow = Vs + key * HDM + 4 * (t ^ ((key & SWM) * NH));
          const float4 v0 = *reinterpret_cast<const float4*>(vrow);
          const float4 v1 = *reinterpret_cast<const float4*>(vrow + 4 * TPR);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float a = comp(pv[r], e);
            acc[r][0] = fmaf(a, v0.x, acc[r][0]);
            acc[r][1] = fmaf(a, v0.y, acc[r][1]);
            acc[r][2] = fmaf(a, v0.z, acc[r][2]);
            acc[r][3] = fmaf(a, v0.w, acc[r][3]);
            acc[r][4] = fmaf(a, v1.x, acc[r][4]);
            acc[r][5] = fmaf(a, v1.y, acc[r][5]);
            acc[r][6] = fmaf(a, v1.z, acc[r][6]);
            acc[r][7] = fmaf(a, v1.w, acc[r][7]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // the empty group of the last tile

#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int sh = 1; sh < TPR; sh <<= 1)
      l_i[r] += __shfl_xor_sync(kFull, l_i[r], sh);
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = q0 + rg * RPT + r;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int col = 4 * (t + TPR * cc);
      if (col < p.dv)
        Io<T>::store4(ob + row * p.os[2] + col,
                      make_float4(acc[r][4 * cc] / denom,
                                  acc[r][4 * cc + 1] / denom,
                                  acc[r][4 * cc + 2] / denom,
                                  acc[r][4 * cc + 3] / denom));
    }
  }
}

template <typename T, int HDM>
int launch(const Params& p, cudaStream_t s) {
  constexpr size_t smem = Tile<HDM>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_kernel<T, HDM>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  constexpr int BQ = Tile<HDM>::BQ;
  const dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)p.H,
                  (unsigned)p.B);
  flash_kernel<T, HDM><<<grid, Tile<HDM>::NT, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const Params& p, cudaStream_t s) {
  const int d = max(p.hd, p.dv);
  if (d <= 64) return launch<T, 64>(p, s);
  if (d <= 128) return launch<T, 128>(p, s);
  return launch<T, 256>(p, s);
}

}  // namespace

// q (B, H, Sq, hd), k (B, Kh, Sk, hd), v (B, Kh, Sk, dv), o (B, H, Sq,
// dv), as element strides of (b, h, s) in `strides` (q, k, v, o; 12
// values) with unit stride on the head dim.  dtype 0: f32, 1: bf16.  hd
// and dv multiples of 8 up to 256; window 0, prefix 0 and softcap 0 mean
// none.
// Returns the cudaError_t of the attribute calls or the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int H,
                                     int Kh, int Sq, int Sk, int hd, int dv,
                                     int causal, int window, int prefix,
                                     float scale,
                                     float softcap, int dtype, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  for (int e = 0; e < 3; ++e) {
    p.qs[e] = strides[e];
    p.ks[e] = strides[3 + e];
    p.vs[e] = strides[6 + e];
    p.os[e] = strides[9 + e];
  }
  p.B = B; p.H = H; p.Kh = Kh; p.Sq = Sq; p.Sk = Sk; p.hd = hd; p.dv = dv;
  p.causal = causal; p.window = window; p.prefix = prefix;
  p.scale = scale; p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 8 != 0 || hd < 8 || hd > 256 || dv % 8 != 0 || dv < 8 ||
      dv > 256 || Kh < 1 || H % Kh != 0 || prefix < 0)
    return (int)cudaErrorInvalidValue;
  p.group = H / Kh;
  return dtype == 0 ? launch_hd<float>(p, s)
                    : launch_hd<__nv_bfloat16>(p, s);
}
