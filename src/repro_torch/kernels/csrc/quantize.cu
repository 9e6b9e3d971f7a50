// QSGD stochastic uniform quantization of the channel uplink on Hopper
// (sm_90a): three kernels over the (m, D) client-stacked flat update.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/quantize.py:
//   rowwise_absmax   (function :51, pallas_call :59)   per-row max |x|
//   qsgd_quantize    (function :86, pallas_call :104)  int32 levels
//   qsgd_dequantize  (function :125, pallas_call :136) levels x row scale
// with s = 2^(b-1) - 1 levels, scale = absmax * (1/s) (the reciprocal
// rounded to f32 once, on the host), inv = 1/scale (0 for a zero row) and
// q = clip(floor(x * inv + u), -s, s).
//
// Arithmetic: every product and sum goes through the IEEE intrinsics
// (__fmul_rn, __fadd_rn, __fdiv_rn).  nvcc never contracts those into an
// FMA, which would round once where the reference rounds twice and move a
// stochastic-rounding floor by one level.  The build keeps IEEE division
// and denormals (no --use_fast_math), so the levels and values are bitwise
// those of the reference and of kernels/ref.py.
//
// Bound on this card: all three are elementwise streams, bound by HBM
// bytes.  At the main path's (20, 47,571) f32: absmax reads 3.81 MB
// (0.0011 ms at 3.35 TB/s), quantize reads x and u and writes int32 levels
// (11.4 MB, 0.0034 ms), dequantize reads levels and writes f32 (7.6 MB,
// 0.0023 ms).  At that size a launch costs more than the bytes.
//
// Design: a (D tiles, m) grid, 256 threads a block, 8 columns a thread at a
// stride of 256, so each warp touches 32 neighbouring words (coalesced) and
// every thread has 8 loads in flight.  The ragged D edge is masked, not
// padded.  absmax reduces a tile with warp reductions, then one atomicMax
// per block on the bit pattern of |x|: with the sign bit cleared, integer
// order is float order and every NaN lies above +inf, so the max is exact
// in any order (deterministic) and a NaN in a row gives a NaN scale, as
// jnp.max does; the row then dequantizes to NaN, as in the reference.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr long long kTileCols = (long long)kThreads * kPerThread;

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const float* __restrict__ x, unsigned* __restrict__ out,
                  long long d) {
  __shared__ unsigned warp_max[kThreads / 32];
  const int row = blockIdx.y;
  const float* xr = x + (long long)row * d;
  const long long c0 = (long long)blockIdx.x * kTileCols + threadIdx.x;
  unsigned mx = 0u;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const long long c = c0 + (long long)e * kThreads;
    if (c < d) {
      const unsigned v = abs_bits(xr[c]);
      mx = v > mx ? v : mx;
    }
  }
  mx = __reduce_max_sync(0xffffffffu, mx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < kThreads / 32 ? warp_max[lane] : 0u;
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) atomicMax(out + row, mx);
  }
}

__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float* __restrict__ x, const float* __restrict__ u,
                    const float* __restrict__ absmax, int* __restrict__ q,
                    long long d, float levels, float inv_levels) {
  const int row = blockIdx.y;
  const long long base = (long long)row * d;
  const float scale = __fmul_rn(absmax[row], inv_levels);
  const float inv = scale > 0.0f ? __fdiv_rn(1.0f, scale) : 0.0f;
  const long long c0 = (long long)blockIdx.x * kTileCols + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const long long c = c0 + (long long)e * kThreads;
    if (c < d) {
      float y = floorf(__fadd_rn(__fmul_rn(x[base + c], inv), u[base + c]));
      // clip as jnp.clip does: a NaN stays NaN (and converts to 0)
      y = y < -levels ? -levels : (y > levels ? levels : y);
      q[base + c] = (int)y;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const int* __restrict__ q,
                      const float* __restrict__ absmax,
                      float* __restrict__ out, long long d,
                      float inv_levels) {
  const int row = blockIdx.y;
  const long long base = (long long)row * d;
  const float scale = __fmul_rn(absmax[row], inv_levels);
  const long long c0 = (long long)blockIdx.x * kTileCols + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const long long c = c0 + (long long)e * kThreads;
    if (c < d) out[base + c] = __fmul_rn(__int2float_rn(q[base + c]), scale);
  }
}

dim3 grid_for(int m, long long d) {
  return dim3((unsigned)((d + kTileCols - 1) / kTileCols), (unsigned)m);
}

}  // namespace

// x (m, d) f32 -> out (m, 1) f32.  Zeroes out, then one atomicMax per block.
// Returns the cudaError_t of the memset or of the launch.
extern "C" int repro_rowwise_absmax(const void* x, void* out, int m,
                                    long long d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)m, s);
  if (err != cudaSuccess) return (int)err;
  absmax_kernel<<<grid_for(m, d), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<unsigned*>(out), d);
  return (int)cudaGetLastError();
}

// x, u (m, d) f32, absmax (m, 1) f32 -> q (m, d) int32 in [-levels, levels].
extern "C" int repro_qsgd_quantize(const void* x, const void* u,
                                   const void* absmax, void* q, int m,
                                   long long d, float levels,
                                   float inv_levels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quantize_kernel<<<grid_for(m, d), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<const float*>(absmax), static_cast<int*>(q), d, levels,
      inv_levels);
  return (int)cudaGetLastError();
}

// q (m, d) int32, absmax (m, 1) f32 -> out (m, d) f32.
extern "C" int repro_qsgd_dequantize(const void* q, const void* absmax,
                                     void* out, int m, long long d,
                                     float inv_levels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dequantize_kernel<<<grid_for(m, d), kThreads, 0, s>>>(
      static_cast<const int*>(q), static_cast<const float*>(absmax),
      static_cast<float*>(out), d, inv_levels);
  return (int)cudaGetLastError();
}
