// QSGD stochastic uniform quantization of the channel uplink on Hopper
// (sm_90a): two kernels over the (m, D) client-stacked flat update.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   rowwise_absmax   (function :51, pallas_call :59)   per-row max |x|
//   qsgd_quantize    (function :86, pallas_call :104)  int32 levels
//   qsgd_dequantize  (function :125, pallas_call :136) levels x row scale
// with s = 2^(b-1) - 1 levels, scale = absmax * (1/s) (the reciprocal
// rounded to f32 once, on the host), inv = 1/scale (0 for a zero row) and
// q = clip(floor(x * inv + u), -s, s); a NaN level (a row holding NaN or
// inf) converts to 0, as XLA's conversion and cvt.rzi give.  A subnormal
// absmax, scale or inv, and a subnormal element of x where its level is
// computed (`level`), are flushed to 0 (`flush`), as the reference's XLA
// runs flush them: such a row crosses as zeros, such an element gets level
// 0.  The max needs no flush of its own: a subnormal element raises it only
// where every element is subnormal, and the max itself is flushed.  (At the
// loads, the element's flush made the row pass half as slow again; see
// PERF.md.)  The flush is explicit on these values and nowhere else:
// -ftz=true would change every kernel the same flags build.
//
// Arithmetic: every product and sum goes through the IEEE intrinsics
// (__fmul_rn, __fadd_rn, __fdiv_rn).  nvcc never contracts those into an
// FMA, which would round once where the reference rounds twice and move a
// stochastic-rounding floor by one level.  The build keeps IEEE division
// and denormals (no --use_fast_math), so the levels and values are bitwise
// those of the reference and of kernels/ref.py.
//
// Bound on this card: HBM bytes.  At the main path's (20, 47,571) f32 the
// crossing's roundtrip reads x and u and writes the values (11.4 MB,
// 0.0034 ms at 3.35 TB/s); the encode reads the same and writes int32
// levels (11.4 MB); absmax alone reads 3.81 MB (0.0011 ms); dequantize
// reads levels and writes f32 (7.6 MB, 0.0023 ms).  At that size launch,
// latency and the ramp cost more than the bytes, so the design spends
// launches and passes over HBM, not instructions.
//
// The row pass (`row_kernel`): absmax, levels and values in one launch and
// one read of x.  A cluster of 8 blocks (256 threads each) a row, each
// block holding an eighth of the row; a thread keeps up to 32 values of x
// (and of u) in registers (D up to 65,536: LeNet's 47,571 takes 24), a
// longer row is re-read from global memory (L2) after the exchange.  The
// max is an integer max over |x|'s bits: with the sign bit cleared,
// integer order is float order and every NaN lies above +inf, so it is
// exact in any order (deterministic, no float atomics) and a NaN in a row
// gives a NaN scale, as jnp.max does; the row then dequantizes to NaN, as
// in the reference.  Each block pushes its max into every block's shared
// memory (distributed shared memory), one cluster barrier publishes them,
// and every block then holds the row's absmax: nothing is zeroed before
// the launch and there is no atomicMax.  The loads of u are issued before
// the barrier, so they overlap the exchange.  The epilogue is the
// instance's: absmax alone, absmax and levels (the encode), or the values
// float(q) * scale and nothing else (the roundtrip, the crossing's call).
//
// The stream (`stream_kernel`): the quantize with absmax given (the Pallas
// kernel's own signature) and the dequantize, elementwise over the flat
// m*D buffer in one wave of blocks: 16-byte accesses, the row of each
// 4-vector and its scale worked out once a vector (for D >= 4 a vector
// straddles at most one row boundary, wherever the rows start), the last
// n mod 4 elements one by one.  D < 4, or an array that does not start on
// 16 bytes (a view into a larger buffer), takes the scalar path
// throughout.
#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;     // blocks a row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegMax = 32;     // values a thread in registers, at most
constexpr int kGlobal = 0;      // slots of the re-read path

// what the row pass writes
constexpr int kAbsmax = 0;      // absmax (m, 1)
constexpr int kEncode = 1;      // absmax and int32 levels
constexpr int kRoundtrip = 2;   // float(q) * scale

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// v, or 0 where v is subnormal (NaN and inf kept)
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? 0.0f : v;
}

__device__ __forceinline__ float scale_of(float amax, float inv_levels) {
  return flush(__fmul_rn(amax, inv_levels));
}

__device__ __forceinline__ float inv_of(float scale) {
  return scale > 0.0f ? flush(__fdiv_rn(1.0f, scale)) : 0.0f;
}

// clip(floor(x * inv + u), -s, s) as jnp.clip does (a NaN stays NaN), then
// int32 with NaN -> 0; a subnormal x reads as 0
__device__ __forceinline__ int level(float x, float u, float inv, float s) {
  float y = floorf(__fadd_rn(__fmul_rn(flush(x), inv), u));
  y = y < -s ? -s : (y > s ? s : y);
  return y == y ? __float2int_rz(y) : 0;
}

__device__ __forceinline__ float value(int q, float scale) {
  return __fmul_rn(__int2float_rn(q), scale);
}

struct RowArgs {
  const float* x;
  const float* u;
  float* amax;     // (m, 1): absmax and encode
  int* q;          // (m, d): encode
  float* v;        // (m, d): roundtrip
  int d;
  int slice;       // columns a block
  float levels;    // s
  float inv_levels;
};

// R > 0: the slice in registers, R values a thread; kGlobal: re-read
template <int R, int OUT>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    row_kernel(const RowArgs a) {
  __shared__ unsigned wmax_s[kWarps];
  __shared__ unsigned rmax_s[kCluster];  // every block's max, pushed to all
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x / kCluster;
  const int b0 = rank * a.slice;
  const int n = max(0, min(a.d - b0, a.slice));
  const long long off = row * a.d + b0;
  const float* __restrict__ xs = a.x + off;
  const float* __restrict__ us = a.u + off;
  constexpr bool kLevels = OUT != kAbsmax;
  constexpr int RR = R > 0 ? R : 1;

  float xv[RR], uv[RR];
  unsigned mx = 0u;
  if constexpr (R > 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = tid + i * kThreads;
      xv[i] = j < n ? xs[j] : 0.0f;   // 0 adds nothing to the max
    }
    if constexpr (kLevels) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = tid + i * kThreads;
        uv[i] = j < n ? us[j] : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) mx = max(mx, abs_bits(xv[i]));
  } else {
    int j = tid;
    for (; j + 7 * kThreads < n; j += 8 * kThreads) {
      unsigned w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = abs_bits(xs[j + e * kThreads]);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx = max(mx, w[e]);
    }
    for (; j < n; j += kThreads) mx = max(mx, abs_bits(xs[j]));
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) wmax_s[warp] = mx;
  __syncthreads();
  if (tid < kCluster) {  // thread r pushes the block's max to block r
    unsigned bm = wmax_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) bm = max(bm, wmax_s[w]);
    *cluster.map_shared_rank(&rmax_s[rank], tid) = bm;
  }
  // every block's max arrived; after this no block touches another's
  // shared memory, so any block may leave
  cluster.sync();
  unsigned am = rmax_s[0];
#pragma unroll
  for (int r = 1; r < kCluster; ++r) am = max(am, rmax_s[r]);
  const float amax = flush(__uint_as_float(am));
  if (OUT != kRoundtrip && rank == 0 && tid == 0) a.amax[row] = amax;
  if constexpr (kLevels) {
    const float scale = scale_of(amax, a.inv_levels);
    const float inv = inv_of(scale);
    if constexpr (R > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int j = tid + i * kThreads;
        if (j < n) {
          const int q = level(xv[i], uv[i], inv, a.levels);
          if constexpr (OUT == kEncode)
            a.q[off + j] = q;
          else
            a.v[off + j] = value(q, scale);
        }
      }
    } else {
#pragma unroll 4
      for (int j = tid; j < n; j += kThreads) {
        const int q = level(xs[j], us[j], inv, a.levels);
        if constexpr (OUT == kEncode)
          a.q[off + j] = q;
        else
          a.v[off + j] = value(q, scale);
      }
    }
  }
}

// element e of the flat buffer: its row, for a 32-bit or 64-bit n
__device__ __forceinline__ long long row_of(long long e, long long d,
                                            bool narrow) {
  return narrow ? (long long)((unsigned)e / (unsigned)d) : e / d;
}

// DEQ: out = float(q) * scale of q's row; else q = level(x, u) with the
// given absmax.  Elements [0, 4 nvec) go 16 bytes at a time, the rest one
// by one.
template <bool DEQ>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const float* __restrict__ x, const float* __restrict__ u,
                  const int* __restrict__ q_in,
                  const float* __restrict__ absmax, int* __restrict__ q_out,
                  float* __restrict__ v_out, long long n, long long d,
                  long long nvec, float levels, float inv_levels) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool narrow = n <= 0xffffffffLL;
  for (long long v = t0; v < nvec; v += stride) {
    const long long e0 = 4 * v;
    const long long r0 = row_of(e0, d, narrow);
    // elements of the vector in row r0; the rest are in row r0 + 1
    const long long first = d - (e0 - r0 * d);
    const float s0 = scale_of(absmax[r0], inv_levels);
    const float s1 = first < 4 ? scale_of(absmax[r0 + 1], inv_levels) : s0;
    if constexpr (DEQ) {
      const int4 q = *reinterpret_cast<const int4*>(q_in + e0);
      float4 o;
      o.x = value(q.x, s0);
      o.y = value(q.y, first > 1 ? s0 : s1);
      o.z = value(q.z, first > 2 ? s0 : s1);
      o.w = value(q.w, first > 3 ? s0 : s1);
      *reinterpret_cast<float4*>(v_out + e0) = o;
    } else {
      const float4 xv = *reinterpret_cast<const float4*>(x + e0);
      const float4 uv = *reinterpret_cast<const float4*>(u + e0);
      const float i0 = inv_of(s0);
      const float i1 = first < 4 ? inv_of(s1) : i0;
      int4 q;
      q.x = level(xv.x, uv.x, i0, levels);
      q.y = level(xv.y, uv.y, first > 1 ? i0 : i1, levels);
      q.z = level(xv.z, uv.z, first > 2 ? i0 : i1, levels);
      q.w = level(xv.w, uv.w, first > 3 ? i0 : i1, levels);
      *reinterpret_cast<int4*>(q_out + e0) = q;
    }
  }
  for (long long e = 4 * nvec + t0; e < n; e += stride) {
    const float s = scale_of(absmax[row_of(e, d, narrow)], inv_levels);
    if constexpr (DEQ)
      v_out[e] = value(q_in[e], s);
    else
      q_out[e] = level(x[e], u[e], inv_of(s), levels);
  }
}

int slice_of(long long d) { return (int)((d + kCluster - 1) / kCluster); }

template <int OUT>
int launch_row(int slots, int m, const RowArgs& a, cudaStream_t s) {
  const dim3 grid((unsigned)m * kCluster);
  switch (slots) {
    case 8: row_kernel<8, OUT><<<grid, kThreads, 0, s>>>(a); break;
    case 16: row_kernel<16, OUT><<<grid, kThreads, 0, s>>>(a); break;
    case 24: row_kernel<24, OUT><<<grid, kThreads, 0, s>>>(a); break;
    case 32: row_kernel<32, OUT><<<grid, kThreads, 0, s>>>(a); break;
    default: row_kernel<kGlobal, OUT><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// 4-vectors of the body: all of n but its last n mod 4 when every array
// starts on 16 bytes and D >= 4, else none
long long vectors_of(const void* const* ptrs, int n_ptrs, long long n,
                     long long d) {
  bool aligned = d >= 4;
  for (int i = 0; i < n_ptrs; ++i)
    aligned = aligned &&
              (reinterpret_cast<unsigned long long>(ptrs[i]) & 15u) == 0;
  return aligned ? n / 4 : 0;
}

template <bool DEQ>
int launch_stream(const float* x, const float* u, const int* q_in,
                  const float* absmax, int* q_out, float* v_out, long long n,
                  long long d, long long nvec, float levels, float inv_levels,
                  cudaStream_t s) {
  static int per_sm = 0;  // resident blocks an SM (the same on every H100)
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stream_kernel<DEQ>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long work = nvec > (n - 4 * nvec) ? nvec : n - 4 * nvec;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long wave = (long long)per_sm * sms;
  blocks = blocks < 1 ? 1 : (blocks > wave ? wave : blocks);
  stream_kernel<DEQ><<<(unsigned)blocks, kThreads, 0, s>>>(
      x, u, q_in, absmax, q_out, v_out, n, d, nvec, levels, inv_levels);
  return (int)cudaGetLastError();
}

bool rows_ok(int m, long long d) {
  return m >= 1 && d >= 1 && (long long)m * kCluster <= 0x7fffffffLL;
}

}  // namespace

// The row pass.  x, u (m, d) f32 -> what `out` asks for: 0 absmax (m, 1)
// f32; 1 absmax and q (m, d) int32; 2 values (m, d) f32 (no absmax).
// `slots` is the register slots a thread (8, 16, 24 or 32, covering an
// eighth of the row over 256 threads) or 0 for the re-read path;
// d < 2^31, m * 8 < 2^31.  Returns the cudaError_t of the launch.
extern "C" int repro_qsgd_row_pass(const void* x, const void* u, void* absmax,
                                   void* q, void* values, int m, long long d,
                                   int slots, int out, float levels,
                                   float inv_levels, void* stream) {
  const bool reg_ok = slots == kGlobal ||
      (slots % 8 == 0 && slots >= 8 && slots <= kRegMax &&
       (long long)slots * kThreads >= slice_of(d));
  if (!rows_ok(m, d) || d > 0x7fffffffLL || !reg_ok || out < kAbsmax ||
      out > kRoundtrip)
    return (int)cudaErrorInvalidValue;
  const RowArgs a{static_cast<const float*>(x), static_cast<const float*>(u),
                  static_cast<float*>(absmax), static_cast<int*>(q),
                  static_cast<float*>(values), (int)d, slice_of(d), levels,
                  inv_levels};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out) {
    case kAbsmax: return launch_row<kAbsmax>(slots, m, a, s);
    case kEncode: return launch_row<kEncode>(slots, m, a, s);
    default: return launch_row<kRoundtrip>(slots, m, a, s);
  }
}

// The stream, quantize: x, u (m, d) f32, absmax (m, 1) f32 -> q (m, d)
// int32 in [-levels, levels].
extern "C" int repro_qsgd_quantize(const void* x, const void* u,
                                   const void* absmax, void* q, int m,
                                   long long d, float levels,
                                   float inv_levels, void* stream) {
  if (!rows_ok(m, d)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)m * d;
  const void* ptrs[3] = {x, u, q};
  return launch_stream<false>(
      static_cast<const float*>(x), static_cast<const float*>(u), nullptr,
      static_cast<const float*>(absmax), static_cast<int*>(q), nullptr, n, d,
      vectors_of(ptrs, 3, n, d), levels, inv_levels,
      static_cast<cudaStream_t>(stream));
}

// The stream, dequantize: q (m, d) int32, absmax (m, 1) f32 -> out (m, d)
// f32.
extern "C" int repro_qsgd_dequantize(const void* q, const void* absmax,
                                     void* out, int m, long long d,
                                     float inv_levels, void* stream) {
  if (!rows_ok(m, d)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)m * d;
  const void* ptrs[2] = {q, out};
  return launch_stream<true>(
      nullptr, nullptr, static_cast<const int*>(q),
      static_cast<const float*>(absmax), nullptr, static_cast<float*>(out),
      n, d, vectors_of(ptrs, 2, n, d), 0.0f, inv_levels,
      static_cast<cudaStream_t>(stream));
}
