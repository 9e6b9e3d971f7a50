// User-centric aggregation Y = W Θ on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mixing_aggregate.py,
// function `mixing_aggregate` (body `_kernel`): W (k, m) fp32 mixing
// rules, Θ (m, D) client-stacked flat params in fp32 or bf16, Y (k, D) in
// Θ's dtype with fp32 accumulation.
//
// Bound on this card: each Θ element feeds k multiply-adds, so the
// arithmetic intensity is O(k) FLOP per byte.  At the main path's sizes
// (k, m <= 20) the kernel is bound by HBM bytes: Θ read once plus Y
// written once.  At k = m = 100 the 2·k·m·D FLOPs on the fp32 (non-tensor)
// pipes approach the byte time, so both bounds have to be checked there.
//
// Design: one block owns a tile of 128 neighbouring D columns, one column
// per thread, so each warp reads 32 neighbouring Θ elements of a row
// (coalesced).  W sits in shared memory (dynamic, zero-padded to a
// multiple of the k-chunk; above 48 KB the launch raises the block's
// limit); every thread reads the same W word at a time, a broadcast.
// Accumulators for a chunk of KC output rows live in registers; k > KC
// loops over chunks and re-reads the block's Θ tile, which is then
// served from L1/L2 rather than HBM.  The ragged D edge is masked.
// No atomics: each output element is written by exactly one thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
    mix_kernel(const float* __restrict__ w, const T* __restrict__ theta,
               T* __restrict__ out, int k, int m, long long d) {
  extern __shared__ float w_s[];  // (k_pad, m), rows >= k are zero
  const int k_pad = ((k + KC - 1) / KC) * KC;
  for (int i = threadIdx.x; i < k_pad * m; i += kThreads) {
    w_s[i] = (i / m) < k ? w[i] : 0.0f;
  }
  __syncthreads();

  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  const T* tcol = theta + col;
  for (int k0 = 0; k0 < k; k0 += KC) {
    float acc[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] = 0.0f;
    const float* wrow = w_s + k0 * m;
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float t = to_f32(tcol[(long long)j * d]);
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = fmaf(wrow[c * m + j], t, acc[c]);
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (k0 + c < k) store(out + (long long)(k0 + c) * d + col, acc[c]);
    }
  }
}

template <typename T, int KC>
cudaError_t launch(const float* w, const void* theta, void* out, int k, int m,
                   long long d, cudaStream_t stream) {
  const int k_pad = ((k + KC - 1) / KC) * KC;
  const size_t smem = sizeof(float) * (size_t)k_pad * (size_t)m;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mix_kernel<T, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (d + kThreads - 1) / kThreads;
  mix_kernel<T, KC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      w, static_cast<const T*>(theta), static_cast<T*>(out), k, m, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const float* w, const void* theta, void* out, int k,
                     int m, long long d, cudaStream_t stream) {
  if (k <= 1) return launch<T, 1>(w, theta, out, k, m, d, stream);
  if (k <= 4) return launch<T, 4>(w, theta, out, k, m, d, stream);
  if (k <= 8) return launch<T, 8>(w, theta, out, k, m, d, stream);
  if (k <= 16) return launch<T, 16>(w, theta, out, k, m, d, stream);
  return launch<T, 32>(w, theta, out, k, m, d, stream);
}

}  // namespace

// Bytes of shared memory the launch needs for W: the wrapper refuses shapes
// above the card's per-block limit before calling in.
extern "C" long long repro_mixing_aggregate_smem(int k, int m) {
  const int kc = k <= 1 ? 1 : k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : 32;
  return (long long)sizeof(float) * ((k + kc - 1) / kc) * kc * m;
}

// dtype: 0 = float32 Θ/Y, 1 = bfloat16 Θ/Y.  Returns cudaGetLastError().
extern "C" int repro_mixing_aggregate(const void* w, const void* theta,
                                      void* out, int k, int m, long long d,
                                      int dtype, void* stream) {
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0 ? dispatch<float>(wf, theta, out, k, m, d, s)
      : dtype == 1 ? dispatch<__nv_bfloat16>(wf, theta, out, k, m, d, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
