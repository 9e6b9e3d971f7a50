// User-centric aggregation Y_l = W Θ_l of a whole parameter tree on Hopper
// (sm_90a), every leaf in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mixing_aggregate.py,
// function `mixing_aggregate` (body `_kernel`): W (k, m) fp32 mixing
// rules, Θ_l (m, D_l) client-stacked params in fp32 or bf16, Y_l (k, D_l)
// in Θ's dtype with fp32 accumulation.  The TPU kernel is called once per
// leaf; here one launch takes up to kMaxLeaves leaves.
//
// Bound on this card: each Θ element feeds k multiply-adds.  At the main
// path's k = m = 20 (LeNet-5, ΣD_l = 47,571) the kernel is bound by HBM
// bytes (Θ read once, Y written once: 7.6 MB, 2.3 µs), and ten launches of
// one leaf each cost more than that in launch and tail latency.  At
// k = m = 100 the 2·k·m·ΣD fp32 FMAs (14 µs at 67 TFLOP/s) bound it as
// much as the bytes (11 µs), so both matter there.
//
// Design:
// - The leaf table (Θ and Y pointers, D_l, the prefix of tile counts and
//   the widest copy each Θ row allows) travels by value in the kernel's
//   parameters, as PyTorch's multi-tensor apply does: no H2D copy, no
//   extra launch.  Block x owns one (leaf, 128-column tile) pair, found
//   from the prefix; block y owns up to 128 output rows.  LeNet's ten
//   leaves make 376 tiles: small leaves share the waves of fc1's 240.
// - The block's (m × 128) Θ panel goes to shared memory by cp.async,
//   every row issued before the first wait.  Above m = 64 the panel moves
//   through a 2-stage ring of 16-row chunks, so W (up to 46 KB at k = 100)
//   and the ring leave room for three blocks an SM.  cp.async takes 16, 8
//   or 4 bytes from an address aligned to that size: the wrapper picks the
//   widest each leaf's base and row stride allow (conv1's 150-column rows
//   are 600 B: 8-byte copies), and a bf16 leaf of odd width, whose rows are
//   2-byte aligned, takes plain loads.
// - W is scattered once a block into shared memory as (m, 4 warps, KC):
//   warp g owns rows [g·nr, (g+1)·nr) of the block's rows, so the W values
//   a thread needs at step j are KC contiguous floats, read as
//   warp-uniform float4 broadcasts.  Lane l owns columns 4l..4l+3 and
//   keeps KC × 4 fp32 accumulators in registers: per step one 16-byte Θ
//   load and KC/4 W loads feed 4·KC FMAs.
// - Each output element is summed as fmaf over j = 0..m−1 in order from
//   0, whatever the leaf set, so a tree call equals one-leaf calls bit for
//   bit and an identity W returns Θ exactly.
// - Stores are 16 bytes (fp32) or 8 bytes (bf16) where the leaf's output
//   base and width allow, else per element; the ragged tile edge is
//   masked.  No atomics: each output element is written by one thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;           // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;              // Θ columns a block owns: 32 lanes × 4
constexpr int kRowsPerBlock = 128;      // output rows of one block: 4 × KC ≤ 32
constexpr int kMaxLeaves = 32;          // must match N_MAX in mixing_aggregate.py
constexpr int kMFull = 64;              // m up to which the panel is staged whole
constexpr int kMRing = 16;              // rows a ring stage holds above that
constexpr int kSmemLimit = 232448;      // bytes of shared memory a block can use

struct LeafTable {
  const void* theta[kMaxLeaves];
  void* out[kMaxLeaves];
  int d[kMaxLeaves];
  int tile0[kMaxLeaves + 1];            // tile0[l]: the first tile of leaf l
  unsigned char ld_bytes[kMaxLeaves];   // cp.async width 16/8/4; 2: plain loads
  int n;
};
static_assert(sizeof(LeafTable) < 1536, "the table must stay far below 4 KB");

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four neighbouring Θ values of one panel row, as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  memcpy(&raw.x, &lo, sizeof(lo));
  memcpy(&raw.y, &hi, sizeof(hi));
  *reinterpret_cast<uint2*>(p) = raw;
}

// W's shared-memory row pitch (floats) for one step j: 4 warps × KC rows,
// plus 4 so that the scatter's neighbouring j do not share one bank
__host__ __device__ constexpr int w_pitch(int kc) { return kWarps * kc + 4; }

__host__ __device__ inline int panel_rows(int m) {
  return m <= kMFull ? m : 2 * kMRing;
}

template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
    mix_kernel(const __grid_constant__ LeafTable tab,
               const float* __restrict__ w, int k, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPitch = w_pitch(KC);
  float* ws = reinterpret_cast<float*>(smem);                  // (m, kPitch)
  T* panel = reinterpret_cast<T*>(smem + sizeof(float) * m * kPitch);

  // this block's leaf and tile
  const int t = blockIdx.x;
  int l = 0;
  while (l + 1 < tab.n && tab.tile0[l + 1] <= t) ++l;
  const int d = tab.d[l];
  const int col0 = (t - tab.tile0[l]) * kTile;
  const int ncols = min(kTile, d - col0);
  const T* theta = static_cast<const T*>(tab.theta[l]) + col0;
  const int ld = tab.ld_bytes[l];

  // Θ panel: chunks of mc rows, one stage each (one chunk when m <= kMFull)
  const int mc = m <= kMFull ? m : kMRing;
  const int nch = (m + mc - 1) / mc;
  const int units = ncols * (int)sizeof(T) / ld;   // copies per row
  auto issue = [&](int c) {
    const int j0 = c * mc, rows = min(mc, m - j0);
    unsigned char* dst0 =
        reinterpret_cast<unsigned char*>(panel + (c & 1) * mc * kTile);
    for (int u = threadIdx.x; u < rows * units; u += kThreads) {
      const int r = u / units, q = u - r * units;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(theta + (size_t)(j0 + r) * d)
          + q * ld;
      unsigned char* dst = dst0 + (size_t)r * kTile * sizeof(T) + q * ld;
      if (ld == 2) {  // a bf16 row of odd width: 2-byte aligned only
        *reinterpret_cast<T*>(dst) = *reinterpret_cast<const T*>(src);
      } else {
        cp_async(dst, src, ld);
      }
    }
    cp_async_commit();
  };
  issue(0);
  if (nch > 1) issue(1);

  // W: zero the (m, kPitch) table, then scatter this block's rows into it
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int kb = min(kRowsPerBlock, k - row0);
  const int nr = (kb + kWarps - 1) / kWarps;          // rows a warp owns
  for (int e = threadIdx.x; e < m * kPitch; e += kThreads) ws[e] = 0.0f;
  __syncthreads();
  const float* wb = w + (size_t)row0 * m;
  for (int e = threadIdx.x; e < kb * m; e += kThreads) {
    const int i = e / m, j = e - i * m;
    const int g = i / nr;
    ws[j * kPitch + g * KC + (i - g * nr)] = wb[e];
  }

  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const float* wg = ws + g * KC;
  float acc[KC][4];
#pragma unroll
  for (int r = 0; r < KC; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
  }
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* st = panel + (c & 1) * mc * kTile + lane * 4;
    const int j0 = c * mc, j1 = min(m, j0 + mc);
    for (int j = j0; j < j1; ++j) {
      const float4 tv = load4(st + (j - j0) * kTile);
      const float tq[4] = {tv.x, tv.y, tv.z, tv.w};
      const float* wj = wg + j * kPitch;
#pragma unroll
      for (int r = 0; r < KC; r += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wj + r);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r][q] = fmaf(wv.x, tq[q], acc[r][q]);
          acc[r + 1][q] = fmaf(wv.y, tq[q], acc[r + 1][q]);
          acc[r + 2][q] = fmaf(wv.z, tq[q], acc[r + 2][q]);
          acc[r + 3][q] = fmaf(wv.w, tq[q], acc[r + 3][q]);
        }
      }
    }
    __syncthreads();                  // stage c & 1 is free again
    if (c + 2 < nch) issue(c + 2);
  }

  // stores: rows [g·nr, g·nr + cnt) of the block, columns 4·lane.. of the tile
  const int cnt = max(0, min(nr, kb - g * nr));
  const int col = lane * 4;
  if (col >= ncols) return;
  T* out = static_cast<T*>(tab.out[l]) + (size_t)(row0 + g * nr) * d + col0
           + col;
  const bool vec = col + 4 <= ncols && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(tab.out[l]) %
                           (4 * sizeof(T)) == 0;
#pragma unroll
  for (int r = 0; r < KC; ++r) {
    if (r < cnt) {
      T* o = out + (size_t)r * d;
      if (vec) {
        store4(o, acc[r]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (col + q < ncols) store1(o + q, acc[r][q]);
        }
      }
    }
  }
}

// rows a warp owns, rounded up to the 4 of a float4 of W
int kc_of(int k) {
  const int kb = k < kRowsPerBlock ? k : kRowsPerBlock;
  const int nr = (kb + kWarps - 1) / kWarps;
  return (nr + 3) / 4 * 4;
}

template <typename T, int KC>
cudaError_t launch(const LeafTable& tab, const float* w, int k, int m,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mix_kernel<T, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)tab.tile0[tab.n],
            (unsigned)((k + kRowsPerBlock - 1) / kRowsPerBlock));
  mix_kernel<T, KC><<<grid, kThreads, smem, stream>>>(tab, w, k, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const LeafTable& tab, const float* w, int k, int m,
                     size_t smem, cudaStream_t s) {
  switch (kc_of(k)) {
    case 4: return launch<T, 4>(tab, w, k, m, smem, s);
    case 8: return launch<T, 8>(tab, w, k, m, smem, s);
    case 12: return launch<T, 12>(tab, w, k, m, smem, s);
    case 16: return launch<T, 16>(tab, w, k, m, smem, s);
    case 20: return launch<T, 20>(tab, w, k, m, smem, s);
    case 24: return launch<T, 24>(tab, w, k, m, smem, s);
    case 28: return launch<T, 28>(tab, w, k, m, smem, s);
    default: return launch<T, 32>(tab, w, k, m, smem, s);
  }
}

}  // namespace

// Bytes of shared memory one block takes: W's (m, pitch) table plus the Θ
// panel.  mixing_aggregate.py's `smem_bytes` repeats this formula.
extern "C" long long repro_mix_smem(int k, int m, int elt) {
  return (long long)sizeof(float) * m * w_pitch(kc_of(k)) +
         (long long)panel_rows(m) * kTile * elt;
}

// One launch over n <= kMaxLeaves leaves: theta[l] (m, d[l]) and out[l]
// (k, d[l]), contiguous; tile0 (n + 1) the prefix of ceil(d / 128);
// ld_bytes[l] the copy width of leaf l.  dtype: 0 = fp32, 1 = bf16.
// Returns a cudaError_t (cudaGetLastError() after the launch).
extern "C" int repro_mix_leaves(const void* w, int k, int m, int n,
                                const void* const* theta, void* const* out,
                                const int* d, const int* tile0,
                                const unsigned char* ld_bytes, int dtype,
                                void* stream) {
  if (n < 1 || n > kMaxLeaves || k < 1 || m < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  LeafTable tab;
  tab.n = n;
  for (int l = 0; l < n; ++l) {
    tab.theta[l] = theta[l];
    tab.out[l] = out[l];
    tab.d[l] = d[l];
    tab.tile0[l] = tile0[l];
    tab.ld_bytes[l] = ld_bytes[l];
    if (ld_bytes[l] == 2 && dtype != 1) return (int)cudaErrorInvalidValue;
  }
  tab.tile0[n] = tile0[n];
  const long long smem = repro_mix_smem(k, m, dtype == 0 ? 4 : 2);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? dispatch<float>(tab, wf, k, m, (size_t)smem, s)
                   : dispatch<__nv_bfloat16>(tab, wf, k, m, (size_t)smem, s));
}
