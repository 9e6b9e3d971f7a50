// Per-row top-k magnitude threshold of the channel uplink on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_threshold.py,
// function `topk_threshold` (:47, pallas_call :60, body `_threshold_kernel`):
// for each row of |x| (m, D), 30 bisection steps over [0, max] keep
// count(|x| >= lo) >= k, so lo ends at most one ulp below the k-th largest
// magnitude; k > D never moves lo from 0.  Every step is the reference's
// f32 arithmetic: mid = 0.5 * (lo + hi) through __fmul_rn / __fadd_rn, an
// exact integer count, then count >= k moves lo or hi.  So the thresholds
// are bitwise those of the reference and of kernels/ref.py.
//
// Bound on this card: one read of |x| (3.81 MB at the main path's
// (20, 47,571) f32: 0.0011 ms at 3.35 TB/s).  The 30 steps re-read the row,
// but from shared memory.  With one block per row there are only m = 20
// blocks for 132 SMs, and each step ends in a block-wide reduction, so the
// kernel runs far above its byte bound: 30 serial reductions per row, and
// one SM pulling a 190 KB row alone.  Splitting a row over a cluster of
// blocks is later work.
//
// Design: one block of 1024 threads per row.  A row of up to ~57,800 f32
// stays resident in dynamic shared memory (up to the card's 227 KB opt-in
// limit; the launch raises the block's limit above 48 KB); a longer row is
// re-read from global memory (L2) on every step, a second code path of the
// same kernel.  The loads that fill shared memory are unrolled by 8 so
// each thread keeps 8 in flight.  The max is NaN-propagating, as jnp.max.
// A step's count: per-thread integer sum, a warp __reduce_add_sync, one
// word per warp in shared memory (double-buffered across steps, so one
// __syncthreads a step), then every thread sums the 32 words itself, so
// all threads hold the same lo and hi without a broadcast.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 30;       // N_ITER of the TPU kernel
constexpr int kUnroll = 8;
constexpr int kSmemMargin = 1024;  // static shared memory + headroom

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads)
    topk_kernel(const float* __restrict__ a, float* __restrict__ out,
                long long d, long long k) {
  extern __shared__ float row_s[];  // (d,) when kResident
  __shared__ float max_s[kWarps];
  __shared__ int cnt_s[2][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* ar = a + (long long)blockIdx.x * d;

  float hi = __uint_as_float(0xff800000u);  // -inf
  long long j = threadIdx.x;
  for (; j + (long long)(kUnroll - 1) * kThreads < d;
       j += (long long)kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) v[e] = ar[j + (long long)e * kThreads];
#pragma unroll
    for (int e = 0; e < kUnroll; ++e) {
      if (kResident) row_s[j + (long long)e * kThreads] = v[e];
      hi = nan_max(hi, v[e]);
    }
  }
  for (; j < d; j += kThreads) {
    const float v = ar[j];
    if (kResident) row_s[j] = v;
    hi = nan_max(hi, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) max_s[warp] = hi;
  __syncthreads();  // also publishes row_s
  hi = max_s[0];
  for (int w = 1; w < kWarps; ++w) hi = nan_max(hi, max_s[w]);

  float lo = 0.0f;
  for (int it = 0; it < kIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (long long i = threadIdx.x; i < d; i += kThreads) {
      c += (kResident ? row_s[i] : ar[i]) >= mid ? 1 : 0;
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) cnt_s[it & 1][warp] = c;
    __syncthreads();
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += cnt_s[it & 1][w];
    const bool ge = total >= k;
    lo = ge ? mid : lo;
    hi = ge ? hi : mid;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = lo;
}

bool resident(long long d, int optin) {
  return (long long)sizeof(float) * d + kSmemMargin <= (long long)optin;
}

int optin_smem() {
  int dev = 0, optin = 48 * 1024;
  if (cudaGetDevice(&dev) != cudaSuccess) return optin;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

}  // namespace

// 1 when a row of d f32 stays resident in shared memory on the current
// device, 0 when the kernel re-reads it from global memory every step.
extern "C" int repro_topk_threshold_resident(long long d) {
  return resident(d, optin_smem()) ? 1 : 0;
}

// a (m, d) f32 magnitudes -> out (m, 1) f32 thresholds, k >= 1.
// Returns the cudaError_t of the attribute call or of the launch.
extern "C" int repro_topk_threshold(const void* a, void* out, int m,
                                    long long d, long long k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* of = static_cast<float*>(out);
  if (resident(d, optin_smem())) {
    const size_t smem = sizeof(float) * (size_t)d;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          topk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    topk_kernel<true><<<(unsigned)m, kThreads, smem, s>>>(af, of, d, k);
  } else {
    topk_kernel<false><<<(unsigned)m, kThreads, 0, s>>>(af, of, d, k);
  }
  return (int)cudaGetLastError();
}
