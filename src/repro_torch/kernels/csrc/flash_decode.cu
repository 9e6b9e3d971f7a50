// Flash-decoding (split keys, then merge) on Hopper (sm_90a): attention of
// 1 <= Sq <= 16 queries (a decode step) over a long K/V cache.
//
// Replaces, for every call with Sq <= 16, the Pallas TPU kernel
// src/repro/kernels/flash_attention.py, function `flash_attention` (:90,
// pallas_call :118, body `_kernel` :30); flash_attention_tc.cu (bf16
// prefill) and flash_attention.cu (the rest of the prefills) keep the
// longer queries.  It computes what `_kernel` computes: out =
// softmax(mask(cap·tanh(q·kᵀ·scale / cap))) · v per (batch, query head), q
// aligned to the end of k (q_pos = i + Sk − Sq), a key valid when
// k_pos < Sk, k_pos <= q_pos (causal) and k_pos > q_pos − window, the
// m_safe / alpha guards, the denominator clamped at 1e-30, so a row with no
// valid key comes out 0; query head h reads KV head h / (H / Kh).  q and k
// have head dim dk (`hd` below), v and the output their own head dim dv
// (MLA's naive decode: dk 192, dv 128; the scale is the caller's, 1/√dk).
// Inputs f32 or bf16, all arithmetic f32, output in q's dtype and layout.
//
// Bound on this card: bytes.  A decode step reads every K and V row of the
// band once (dk + dv elements a key) and does 2·(dk + dv) FLOP per
// (query, key)
// pair: at the serving path's global layer (B 2, H 32, Kh 16, Sq 1,
// Sk 4,609, hd 128, bf16) 75.5 MB, 0.023 ms at 3.35 TB/s, against 7.6e7
// FLOP.  What reaches the bound is memory-level parallelism: many blocks,
// many bytes in flight on each SM, and each K/V row read once.
//
// Design (simple first: no TMA, warp specialisation or clusters).
//   Pass 1, the partials.  Grid (n_split, Kh × row groups, B), 128 threads.
//     A block owns one (batch row, KV head), one contiguous key range
//     (split s holds keys [s·chunk, (s+1)·chunk), chunk = ceil(Sk /
//     n_split)) and the G·Sq query rows of that KV head packed as the rows
//     of its tile (packed row r = g·Sq + i is query head kh·G + g, query
//     i), RMAX of them (4, or 16 when G·Sq > 4; more rows take further row
//     groups).  So each K/V row is read from HBM once per row group, not
//     once per query head.  The key range is cut to the band of the
//     block's rows (causal and window); a block with nothing left writes
//     m = NEG_INF, l = 0, acc = 0 without reading K or V, which is exact.
//     K and V stream through an NS-stage ring of 32-key tiles in shared
//     memory (16-byte `cp.async.cg` copies, one commit group a tile; NS
//     is 4 while the ring fits in 48 KB, else fewer, at least 2), so
//     NS − 1 tiles are in flight under each tile's arithmetic; keys past
//     the range are zero-filled (src-size 0) and masked.  The small ring
//     is deliberate: at the serving shape (bf16, hd 128: 2 stages, 36 KB
//     a block) six blocks fit on an SM, and more resident blocks beat a
//     deeper ring on the card (PERF.md has the tuning runs).  Scores:
//     lane j takes key j of the tile, warp w the packed rows w, w + 4,
//     ...; a lane reads its K row in 16-byte units (rows padded by 16
//     bytes, so 8 lanes cover the 32 banks) and Q as broadcasts from
//     shared memory (f32), over the unrolled head_dim in two FMA chains.
//     The row's max and sum over the tile are xor shuffles across the
//     warp, with the online softmax's guards.  P·V: thread t owns 4
//     output columns (t mod dv/4) of the rows
//     t / (dv/4), that + 128/(dv/4), ...; V rows are read as one
//     contiguous line by the warp.  Scores and P·V run on the f32 CUDA
//     cores: at G·Sq = 2 rows the tensor cores would be idle.
//     Each block writes (acc[dv], m, l), unnormalised, per packed row to
//     the workspace (B, H, Sq, n_split, dv + 2) f32.  The shared-memory
//     rows are sized by two buckets (64, 128 or 256): K's and Q's by
//     max(dk, dv), V's by dv.
//   Pass 2, the merge.  Grid (Sq, H, B), 64 threads of 4 columns each.
//     m* = max_s m_s; w_s = 0 if m_s <= NEG_INF else exp(m_s − m*_safe);
//     out = Σ_s w_s·acc_s / max(Σ_s w_s·l_s, 1e-30), in split order.
// No atomics: the output is bitwise reproducible from call to call.
// Strided (b, h, s) views are taken as they are (the model hands over the
// ring cache transposed, consecutive keys Kh·hd elements apart).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;               // keys per tile: one per lane
constexpr int kMergeThreads = 64;     // 4 output columns each: dv <= 256
constexpr int kRingBytes = 48 * 1024;   // budget of the K/V ring
constexpr float kNegInf = -1e30f;     // NEG_INF of the TPU kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* ws;                             // (B, H, Sq, n_split, dv + 2)
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, s)
  int B, H, Kh, Sq, Sk, hd, dv, group, n_split, chunk;  // hd: dk
  int causal, window;    // window 0: none
  float scale, softcap;  // softcap 0: none
};

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static void load8(const float* p, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ static void load4(const float* p, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
  __device__ static void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static void load8(const __nv_bfloat16* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(h[e]);
      f[2 * e] = x.x;
      f[2 * e + 1] = x.y;
    }
  }
  __device__ static void load4(const __nv_bfloat16* p, float* f) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory layout and work split of one instance (HDM: the bucket of
// Q and K rows, 64/128/256; DVM: that of V rows and the output; RMAX:
// packed rows a block holds).
template <typename T, int HDM, int DVM, int RMAX>
struct Cfg {
  static constexpr int KROW = HDM * (int)sizeof(T) + 16;  // padded K row
  static constexpr int VROW = DVM * (int)sizeof(T);
  static constexpr int STAGE = kBK * (KROW + VROW);
  static constexpr int NS = 4 * STAGE <= kRingBytes ? 4
                            : 3 * STAGE <= kRingBytes ? 3 : 2;
  static constexpr size_t SMEM =
      (size_t)NS * STAGE + sizeof(float) * (RMAX * HDM + RMAX * kBK + RMAX);
  static constexpr int RPW = RMAX / kWarps;        // score rows per warp
  static constexpr int CG = DVM / 4;               // 4-column groups
  static constexpr int NRG = kThreads / CG;        // row groups in P·V
  static constexpr int RPT = (RMAX + NRG - 1) / NRG;  // P·V rows a thread
};

// offset of (b, h, i, split) in the workspace, in floats
__device__ __forceinline__ long long ws_row(const Params& p, int b, int h,
                                            int i, int split) {
  return ((((long long)b * p.H + h) * p.Sq + i) * p.n_split + split) *
         (p.dv + 2);
}

template <typename T, int HDM, int DVM, int RMAX>
__global__ void __launch_bounds__(kThreads) decode_partials(const Params p) {
  using C = Cfg<T, HDM, DVM, RMAX>;
  extern __shared__ float4 smem4[];
  unsigned char* Kr = reinterpret_cast<unsigned char*>(smem4);
  unsigned char* Vr = Kr + C::NS * kBK * C::KROW;
  float* Qs = reinterpret_cast<float*>(Kr + C::NS * C::STAGE);
  float* Ps = Qs + RMAX * HDM;
  float* As = Ps + RMAX * kBK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kh = blockIdx.y % p.Kh;
  const int r0 = (blockIdx.y / p.Kh) * RMAX, b = blockIdx.z;
  const int nr = min(RMAX, p.group * p.Sq - r0);  // live packed rows
  const int hd = p.hd, hd8 = hd >> 3, off = p.Sk - p.Sq;

  for (int idx = tid; idx < RMAX * hd8; idx += kThreads) {
    const int r = idx / hd8, d = (idx - r * hd8) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < nr) {
      const int pr = r0 + r, h = kh * p.group + pr / p.Sq, i = pr % p.Sq;
      Io<T>::load8(static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1] +
                       i * p.qs[2] + d, f);
    }
    reinterpret_cast<float4*>(Qs + r * HDM + d)[0] =
        make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(Qs + r * HDM + d)[1] =
        make_float4(f[4], f[5], f[6], f[7]);
  }

  // this split's keys, cut to the band of the block's query rows
  int lo = split * p.chunk, hi = min(p.Sk, lo + p.chunk);
  int imin = p.Sq, imax = -1;
  for (int r = 0; r < nr; ++r) {
    const int i = (r0 + r) % p.Sq;
    imin = min(imin, i);
    imax = max(imax, i);
  }
  if (p.causal) hi = min(hi, imax + off + 1);
  if (p.window > 0) lo = max(lo, imin + off - p.window + 1);
  const int n_tiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;

  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(p.k) + b * p.ks[0] + kh * p.ks[1]);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(p.v) + b * p.vs[0] + kh * p.vs[1]);
  const long long kstep = p.ks[2] * (long long)sizeof(T);
  const long long vstep = p.vs[2] * (long long)sizeof(T);
  // 16-byte units per K row and per V row, and the larger of the two
  const int cpr = hd * (int)sizeof(T) / 16;
  const int cprv = p.dv * (int)sizeof(T) / 16, cmax = max(cpr, cprv);
  auto load_tile = [&](int t) {
    unsigned char* kd = Kr + (t % C::NS) * kBK * C::KROW;
    unsigned char* vd = Vr + (t % C::NS) * kBK * C::VROW;
    const int k0 = lo + t * kBK;
    for (int idx = tid; idx < kBK * cmax; idx += kThreads) {
      const int row = idx / cmax, u = idx - row * cmax;
      const bool ok = k0 + row < hi;
      const long long key = ok ? k0 + row : lo;  // a valid address when not
      if (u < cpr)
        cp_async16(kd + row * C::KROW + u * 16, kb + key * kstep + u * 16,
                   ok ? 16 : 0);
      if (u < cprv)
        cp_async16(vd + row * C::VROW + u * 16, vb + key * vstep + u * 16,
                   ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < C::NS - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  float m_r[C::RPW], l_r[C::RPW];
#pragma unroll
  for (int ii = 0; ii < C::RPW; ++ii) {
    m_r[ii] = kNegInf;
    l_r[ii] = 0.f;
  }
  const int cg = tid % C::CG, rg = tid / C::CG;
  const bool col_live = cg * 4 < p.dv;
  float4 acc[C::RPT];
#pragma unroll
  for (int ii = 0; ii < C::RPT; ++ii) acc[ii] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<C::NS - 2>();
    __syncthreads();  // tile t has landed; tile t − 1's readers are done
    if (t + C::NS - 1 < n_tiles) load_tile(t + C::NS - 1);
    cp_async_commit();
    const unsigned char* kt = Kr + (t % C::NS) * kBK * C::KROW;
    const unsigned char* vt = Vr + (t % C::NS) * kBK * C::VROW;
    const int k_pos = lo + t * kBK + lane;

    if (warp < nr) {
      float s[C::RPW];
#pragma unroll
      for (int ii = 0; ii < C::RPW; ++ii) s[ii] = 0.f;
      const T* krow = reinterpret_cast<const T*>(kt + lane * C::KROW);
      float s2[C::RPW];  // odd elements: two chains of FMAs, not one
#pragma unroll
      for (int ii = 0; ii < C::RPW; ++ii) s2[ii] = 0.f;
#pragma unroll
      for (int d = 0; d < HDM; d += 8) {
        if (d >= hd) break;
        float kf[8];
        Io<T>::load8(krow + d, kf);
#pragma unroll
        for (int ii = 0; ii < C::RPW; ++ii) {
          if (warp + kWarps * ii < nr) {
            const float* qr = Qs + (warp + kWarps * ii) * HDM + d;
            const float4 a = reinterpret_cast<const float4*>(qr)[0];
            const float4 c = reinterpret_cast<const float4*>(qr)[1];
            s[ii] = fmaf(a.x, kf[0], s[ii]);
            s2[ii] = fmaf(a.y, kf[1], s2[ii]);
            s[ii] = fmaf(a.z, kf[2], s[ii]);
            s2[ii] = fmaf(a.w, kf[3], s2[ii]);
            s[ii] = fmaf(c.x, kf[4], s[ii]);
            s2[ii] = fmaf(c.y, kf[5], s2[ii]);
            s[ii] = fmaf(c.z, kf[6], s[ii]);
            s2[ii] = fmaf(c.w, kf[7], s2[ii]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < C::RPW; ++ii) s[ii] += s2[ii];
#pragma unroll
      for (int ii = 0; ii < C::RPW; ++ii) {
        const int r = warp + kWarps * ii;
        if (r >= nr) continue;  // warp-uniform
        const int q_pos = (r0 + r) % p.Sq + off;
        float x = s[ii] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool valid = k_pos < hi;
        if (p.causal) valid = valid && k_pos <= q_pos;
        if (p.window > 0) valid = valid && k_pos > q_pos - p.window;
        x = valid ? x : kNegInf;
        float mx = x;
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_new = fmaxf(m_r[ii], mx);
        const float m_safe = m_new <= kNegInf ? 0.f : m_new;
        const float alpha =
            m_r[ii] <= kNegInf ? 0.f : expf(m_r[ii] - m_safe);
        const float pj = valid ? expf(x - m_safe) : 0.f;
        float rs = pj;
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, sh);
        l_r[ii] = alpha * l_r[ii] + rs;
        m_r[ii] = m_new;
        Ps[r * kBK + lane] = pj;
        if (lane == 0) As[r] = alpha;
      }
    }
    __syncthreads();  // P and alpha complete

    if (col_live) {
#pragma unroll
      for (int ii = 0; ii < C::RPT; ++ii) {
        const int r = rg + C::NRG * ii;
        if (r < nr) {
          const float a = As[r];
          acc[ii].x *= a; acc[ii].y *= a; acc[ii].z *= a; acc[ii].w *= a;
        }
      }
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        float vv[4];
        Io<T>::load4(reinterpret_cast<const T*>(vt + j * C::VROW) + 4 * cg,
                     vv);
#pragma unroll
        for (int ii = 0; ii < C::RPT; ++ii) {
          const int r = rg + C::NRG * ii;
          if (r < nr) {
            const float pj = Ps[r * kBK + j];
            acc[ii].x = fmaf(pj, vv[0], acc[ii].x);
            acc[ii].y = fmaf(pj, vv[1], acc[ii].y);
            acc[ii].z = fmaf(pj, vv[2], acc[ii].z);
            acc[ii].w = fmaf(pj, vv[3], acc[ii].w);
          }
        }
      }
    }
  }

  // the partials: (m, l) by lane 0 of each row's score warp, acc by P·V
#pragma unroll
  for (int ii = 0; ii < C::RPW; ++ii) {
    const int r = warp + kWarps * ii, pr = r0 + r;
    if (r < nr && lane == 0) {
      float* w = p.ws + ws_row(p, b, kh * p.group + pr / p.Sq, pr % p.Sq,
                               split);
      *reinterpret_cast<float2*>(w + p.dv) = make_float2(m_r[ii], l_r[ii]);
    }
  }
  if (col_live) {
#pragma unroll
    for (int ii = 0; ii < C::RPT; ++ii) {
      const int r = rg + C::NRG * ii, pr = r0 + r;
      if (r < nr) {
        float* w = p.ws + ws_row(p, b, kh * p.group + pr / p.Sq, pr % p.Sq,
                                 split) + 4 * cg;
        reinterpret_cast<float2*>(w)[0] = make_float2(acc[ii].x, acc[ii].y);
        reinterpret_cast<float2*>(w)[1] = make_float2(acc[ii].z, acc[ii].w);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMergeThreads) decode_merge(const Params p) {
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int col = threadIdx.x * 4, stride = p.dv + 2;
  if (col >= p.dv) return;
  const float* w = p.ws + ws_row(p, b, h, i, 0);
  float m = kNegInf;
  for (int s = 0; s < p.n_split; ++s) m = fmaxf(m, w[s * stride + p.dv]);
  const float m_safe = m <= kNegInf ? 0.f : m;
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < p.n_split; ++s) {
    const float* ws = w + (long long)s * stride;
    const float ms = ws[p.dv];
    const float wt = ms <= kNegInf ? 0.f : expf(ms - m_safe);
    l = fmaf(wt, ws[p.dv + 1], l);
    const float2 a0 = reinterpret_cast<const float2*>(ws + col)[0];
    const float2 a1 = reinterpret_cast<const float2*>(ws + col)[1];
    a.x = fmaf(wt, a0.x, a.x);
    a.y = fmaf(wt, a0.y, a.y);
    a.z = fmaf(wt, a1.x, a.z);
    a.w = fmaf(wt, a1.y, a.w);
  }
  const float denom = fmaxf(l, 1e-30f);
  Io<T>::store4(static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1] +
                    i * p.os[2] + col,
                make_float4(a.x / denom, a.y / denom, a.z / denom,
                            a.w / denom));
}

template <typename T, int HDM, int DVM, int RMAX>
int launch(const Params& p, cudaStream_t s) {
  using C = Cfg<T, HDM, DVM, RMAX>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partials<T, HDM, DVM, RMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (p.group * p.Sq + RMAX - 1) / RMAX;
  if ((long long)p.Kh * groups > 65535) return (int)cudaErrorInvalidValue;
  decode_partials<T, HDM, DVM, RMAX>
      <<<dim3((unsigned)p.n_split, (unsigned)(p.Kh * groups), (unsigned)p.B),
         kThreads, C::SMEM, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge<T><<<dim3((unsigned)p.Sq, (unsigned)p.H, (unsigned)p.B),
                    kMergeThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HDM, int DVM>
int launch_rows(const Params& p, cudaStream_t s) {
  return p.group * p.Sq <= 4 ? launch<T, HDM, DVM, 4>(p, s)
                             : launch<T, HDM, DVM, 16>(p, s);
}

// V's bucket by dv; Q's and K's by max(dk, dv), so DVM <= HDM (six pairs)
template <typename T, int HDM>
int launch_dv(const Params& p, cudaStream_t s) {
  if (p.dv <= 64) return launch_rows<T, HDM, 64>(p, s);
  if constexpr (HDM >= 128) {
    if (p.dv <= 128) return launch_rows<T, HDM, 128>(p, s);
  }
  if constexpr (HDM == 256) return launch_rows<T, HDM, 256>(p, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_hd(const Params& p, cudaStream_t s) {
  const int d = max(p.hd, p.dv);
  if (d <= 64) return launch_dv<T, 64>(p, s);
  if (d <= 128) return launch_dv<T, 128>(p, s);
  return launch_dv<T, 256>(p, s);
}

}  // namespace

// As repro_flash_attention (flash_attention.cu), for 1 <= Sq <= 16, plus
// the workspace `ws` (B, H, Sq, n_split, dv + 2) f32, contiguous, that the
// caller allocates, and the number of key splits `n_split` >= 1.  Two
// launches on `stream`: the partials, then the merge.  Returns the
// cudaError_t of the attribute call or of a launch.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  void* o, const long long* strides, int B,
                                  int H, int Kh, int Sq, int Sk, int hd,
                                  int dv, int causal, int window, float scale,
                                  float softcap, int dtype, void* stream,
                                  float* ws, int n_split) {
  if (hd % 8 != 0 || hd < 8 || hd > 256 || dv % 8 != 0 || dv < 8 ||
      dv > 256 || Kh < 1 || H % Kh != 0 ||
      Sq < 1 || Sq > 16 || Sk < 1 || n_split < 1 || B < 1 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.ws = ws;
  for (int e = 0; e < 3; ++e) {
    p.qs[e] = strides[e];
    p.ks[e] = strides[3 + e];
    p.vs[e] = strides[6 + e];
    p.os[e] = strides[9 + e];
  }
  p.B = B; p.H = H; p.Kh = Kh; p.Sq = Sq; p.Sk = Sk; p.hd = hd; p.dv = dv;
  p.group = H / Kh;
  p.n_split = n_split;
  p.chunk = (Sk + n_split - 1) / n_split;
  p.causal = causal; p.window = window;
  p.scale = scale; p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_hd<float>(p, s)
                    : launch_hd<__nv_bfloat16>(p, s);
}
