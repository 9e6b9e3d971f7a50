// Flash attention (causal / sliding window / logit softcap, GQA) on Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// function `flash_attention` (:90, pallas_call :118, body `_kernel` :30):
// out = softmax(mask(cap·tanh(q·kᵀ·scale / cap))) · v per (batch, query
// head), with q aligned to the end of k (q_pos = i + Sk − Sq), a key valid
// when k_pos < Sk, k_pos <= q_pos (causal) and k_pos > q_pos − window, an
// online softmax with the reference's guards for fully masked rows (m_safe,
// alpha) and its denominator clamped at 1e-30.  Query head h reads KV head
// h / (H / Kh); K and V are never broadcast.  Inputs f32 or bf16, all
// arithmetic f32, output in q's dtype.
//
// Bound on this card: operations.  A causal prefill does 4·hd FLOP per
// (query, key) pair that the mask keeps and reads each input once; at the
// serving path's global-layer prefill (B 2, H 32, Kh 16, S 4,608, hd 128,
// bf16) that is 3.5e11 FLOP (0.35 ms at the 989 TFLOP/s bf16 tensor-core
// peak) against 0.23 GB (0.07 ms at 3.35 TB/s).  One decode step (Sq = 1)
// is the other way round: bytes-bound by the K/V read.
//
// Design (simple first; the tensor cores are later work): one block of 128
// threads per (q tile, query head, batch row).  The block stages its Q tile
// once and then loops over 32-key K/V tiles in shared memory, all as f32;
// scores and P·V run on the f32 CUDA cores, so the kernel's own floor is
// the 67 TFLOP/s f32 rate (5.2 ms at the shape above).  Thread t owns rows
// t/8 + 16·i (i < RPT) and, for the scores, keys t%8 + 8·j (j < 4): the 8
// threads of a row are adjacent lanes, so the row max and sum are three
// xor shuffles.  For P·V it owns output columns 4·(t%8) + 32·j: every
// shared-memory read is a float4 that 8 adjacent lanes take from 8
// different bank groups (Q and K rows padded by 4 floats).  The K loop
// starts and ends at the causal/window band of the tile's rows; skipping
// the tiles outside it is exact, since a fully masked tile leaves m, l and
// acc unchanged (alpha = 1, p = 0).  Keys past Sk are zero-filled and
// masked, query rows past Sq are computed and not stored, and a warp whose
// rows all lie past Sq skips the arithmetic.  RPT = 4 (64-row tiles) for
// prefill, RPT = 1 (16 rows) for Sq <= 16, which cuts the waste of a
// decode step's one live row by 4x.  Strided (b, h, s) views are taken as
// they are (the model passes (B, S, H, hd) tensors and slices of the
// (B, C, Kh, hd) cache), so no transpose or copy precedes a launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;            // keys per K/V tile
constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, h, s)
  int B, H, Kh, Sq, Sk, hd, group;
  int causal, window;  // window 0: none
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
  __device__ static void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    memcpy(&raw.x, &lo, sizeof(lo));
    memcpy(&raw.y, &hi, sizeof(hi));
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ void store8(float* dst, const float* f) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

template <int HDM, int RPT>
constexpr size_t smem_bytes() {
  // Q (BQ x HDM+4), K (BK x HDM+4), V (BK x HDM), P (BQ x BK+4), f32
  return sizeof(float) * ((size_t)16 * RPT * (HDM + 4) + kBK * (HDM + 4) +
                          kBK * HDM + (size_t)16 * RPT * (kBK + 4));
}

template <typename T, int HDM, int RPT>
__global__ void __launch_bounds__(kThreads) flash_kernel(const Params p) {
  constexpr int BQ = 16 * RPT;
  constexpr int QS = HDM + 4;  // padded row stride of Q and K (floats)
  constexpr int PS = kBK + 4;  // padded row stride of P
  constexpr int NJ = HDM / 32;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * HDM;

  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.group;
  const int hd = p.hd, hd8 = hd >> 3;
  const T* qb = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* kb = static_cast<const T*>(p.k) + b * p.ks[0] + kh * p.ks[1];
  const T* vb = static_cast<const T*>(p.v) + b * p.vs[0] + kh * p.vs[1];
  T* ob = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1];

  for (int idx = tid; idx < BQ * hd8; idx += kThreads) {
    const int row = idx / hd8, d = (idx - row * hd8) * 8;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + row < p.Sq) Io<T>::load8(qb + (q0 + row) * p.qs[2] + d, f);
    store8(Qs + row * QS + d, f);
  }

  // the band of keys this tile's rows can see
  const int off = p.Sk - p.Sq;
  int k_end = p.Sk;
  if (p.causal) k_end = min(k_end, min(q0 + BQ, p.Sq) - 1 + off + 1);
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 + off - p.window + 1);
  k_begin -= k_begin % kBK;
  // a warp whose rows (4w.. at i = 0, larger for i > 0) all lie past Sq
  const bool live = q0 + (tid >> 5) * 4 < p.Sq;

  float m_i[RPT], l_i[RPT];
  float4 acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the last tile's readers are done (publishes Q first)
    for (int idx = tid; idx < kBK * hd8; idx += kThreads) {
      const int row = idx / hd8, d = (idx - row * hd8) * 8;
      float fk[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float fv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kt + row < p.Sk) {
        Io<T>::load8(kb + (long long)(kt + row) * p.ks[2] + d, fk);
        Io<T>::load8(vb + (long long)(kt + row) * p.vs[2] + d, fv);
      }
      store8(Ks + row * QS + d, fk);
      store8(Vs + row * HDM + d, fv);
    }
    __syncthreads();

    if (live) {
      float s[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < hd; d += 4) {
        float4 qv[RPT], kv[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (r + 16 * i) * QS + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (c + 8 * j) * QS + d);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = r + 16 * i, q_pos = q0 + row + off;
        bool ok[4];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k_pos = kt + c + 8 * j;
          float x = s[i][j] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          bool valid = k_pos < p.Sk;
          if (p.causal) valid = valid && k_pos <= q_pos;
          if (p.window > 0) valid = valid && k_pos > q_pos - p.window;
          ok[j] = valid;
          s[i][j] = valid ? x : kNegInf;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int sh = 1; sh < 8; sh <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_new = fmaxf(m_i[i], mx);
        const float m_safe = m_new <= kNegInf ? 0.f : m_new;
        const float alpha = m_i[i] <= kNegInf ? 0.f : expf(m_i[i] - m_safe);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pj = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
          rs += pj;
          Ps[row * PS + c + 8 * j] = pj;
        }
#pragma unroll
        for (int sh = 1; sh < 8; sh <<= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, sh);
        l_i[i] = alpha * l_i[i] + rs;
        m_i[i] = m_new;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i][j].x *= alpha; acc[i][j].y *= alpha;
          acc[i][j].z *= alpha; acc[i][j].w *= alpha;
        }
      }
    }
    __syncthreads();  // P complete

    if (live) {
#pragma unroll 2
      for (int kk = 0; kk < kBK; kk += 4) {
        float4 pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          pv[i] = *reinterpret_cast<const float4*>(Ps + (r + 16 * i) * PS + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float4 vv = *reinterpret_cast<const float4*>(
                Vs + (kk + e) * HDM + c * 4 + 32 * j);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float a = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                            : e == 2 ? pv[i].z : pv[i].w;
              acc[i][j].x = fmaf(a, vv.x, acc[i][j].x);
              acc[i][j].y = fmaf(a, vv.y, acc[i][j].y);
              acc[i][j].z = fmaf(a, vv.z, acc[i][j].z);
              acc[i][j].w = fmaf(a, vv.w, acc[i][j].w);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + r + 16 * i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = c * 4 + 32 * j;
      if (col < hd) {
        const float4 a = acc[i][j];
        Io<T>::store4(ob + row * p.os[2] + col,
                      make_float4(a.x / denom, a.y / denom, a.z / denom,
                                  a.w / denom));
      }
    }
  }
}

template <typename T, int HDM, int RPT>
int launch(const Params& p, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<HDM, RPT>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HDM, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((p.Sq + 16 * RPT - 1) / (16 * RPT)),
                  (unsigned)p.H, (unsigned)p.B);
  flash_kernel<T, HDM, RPT><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HDM>
int launch_rows(const Params& p, cudaStream_t s) {
  return p.Sq <= 16 ? launch<T, HDM, 1>(p, s) : launch<T, HDM, 4>(p, s);
}

template <typename T>
int launch_hd(const Params& p, cudaStream_t s) {
  if (p.hd <= 64) return launch_rows<T, 64>(p, s);
  if (p.hd <= 128) return launch_rows<T, 128>(p, s);
  return launch_rows<T, 256>(p, s);
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, Kh, Sk, hd), o like q, as element strides
// of (b, h, s) in `strides` (q, k, v, o; 12 values) with unit stride on hd.
// dtype 0: f32, 1: bf16.  hd % 8 == 0, hd <= 256; window 0 and softcap 0
// mean none.  Returns the cudaError_t of the attribute call or the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int B, int H,
                                     int Kh, int Sq, int Sk, int hd,
                                     int causal, int window, float scale,
                                     float softcap, int dtype, void* stream) {
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
  p.causal = causal; p.window = window;
  p.scale = scale; p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd % 8 != 0 || hd < 8 || hd > 256 || Kh < 1 || H % Kh != 0)
    return (int)cudaErrorInvalidValue;
  return dtype == 0 ? launch_hd<float>(p, s)
                    : launch_hd<__nv_bfloat16>(p, s);
}
