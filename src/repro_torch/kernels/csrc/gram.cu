// Gram matrix G = g gᵀ of client gradients on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_sqdist.py,
// function `gram_matrix` (body `_gram_kernel`): g (m, D) fp32 -> G (m, m)
// fp32, the inner products behind Δ_ij = ||g_i − g_j||².
//
// Bound on this card: g is read once (m·D·4 bytes) and G is tiny, while
// the work is 2·m²·D FLOPs; at the main path's m = 20 that is 10 FLOP per
// byte, below the fp32 pipes' ridge, so HBM bytes bound it.
//
// Design: the TPU kernel revisits one output block across a sequential
// grid and accumulates into it.  Blocks on Hopper run in no order, so that
// does not carry over.  This is a deterministic two-pass design instead:
//   pass 1: block (bx, by, c) computes the 16x16 output tile
//           G[by*16.., bx*16..] over D chunk c, staging 32-column slices of
//           both row panels in shared memory, and writes it to its own
//           slot partial[c] of the (nchunks, m, m) scratch;
//   pass 2: one thread per (i, j) sums partial[0..nchunks) in chunk order.
// No atomics, so G — and with it Δ, the mixing matrix and the k-means
// stream plan — is the same from run to run.  G_ij and G_ji are the same
// fmaf sequence with the factors swapped, so G is exactly symmetric and
// Δ's diagonal is exactly zero.  Each g element is read by ceil(m/16)
// tiles; the repeats are served from L2.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;  // output tile edge
constexpr int kTd = 32;    // D columns staged per step

__global__ void __launch_bounds__(kTile* kTile)
    gram_partial_kernel(const float* __restrict__ g,
                        float* __restrict__ partial, int m, long long d,
                        long long chunk) {
  __shared__ float a_s[kTile][kTd + 1];
  __shared__ float b_s[kTile][kTd + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const long long c = blockIdx.z;
  const long long d0 = c * chunk;
  const long long d1 = d0 + chunk < d ? d0 + chunk : d;

  float acc = 0.0f;
  for (long long t0 = d0; t0 < d1; t0 += kTd) {
    for (int e = tid; e < kTile * kTd; e += kTile * kTile) {
      const int r = e / kTd, q = e % kTd;
      const long long dc = t0 + q;
      const bool in = dc < d1;
      a_s[r][q] = (in && i0 + r < m) ? g[(long long)(i0 + r) * d + dc] : 0.0f;
      b_s[r][q] = (in && j0 + r < m) ? g[(long long)(j0 + r) * d + dc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kTd; ++q) acc = fmaf(a_s[ty][q], b_s[tx][q], acc);
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i < m && j < m) partial[(c * m + i) * m + j] = acc;
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int m,
                                   int nchunks) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mm = (long long)m * m;
  if (idx >= mm) return;
  float s = 0.0f;
  for (int c = 0; c < nchunks; ++c) s += partial[c * mm + idx];
  out[idx] = s;
}

}  // namespace

// partial: (nchunks, m, m) fp32 scratch from the caller, nchunks =
// ceil(d / chunk), chunk a multiple of 32.  Returns cudaGetLastError().
extern "C" int repro_gram_matrix(const void* g, void* partial, void* out,
                                 int m, long long d, long long chunk,
                                 int nchunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = (unsigned)((m + kTile - 1) / kTile);
  dim3 grid1(tiles, tiles, (unsigned)nchunks);
  dim3 block1(kTile, kTile);
  gram_partial_kernel<<<grid1, block1, 0, s>>>(
      static_cast<const float*>(g), static_cast<float*>(partial), m, d, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long mm = (long long)m * m;
  const int threads = 256;
  gram_reduce_kernel<<<(unsigned)((mm + threads - 1) / threads), threads, 0,
                       s>>>(static_cast<const float*>(partial),
                            static_cast<float*>(out), m, nchunks);
  return (int)cudaGetLastError();
}
