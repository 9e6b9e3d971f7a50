// Per-row top-k magnitude threshold of the channel uplink on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_threshold.py,
// function `topk_threshold` (:47, pallas_call :60, body `_threshold_kernel`):
// for each row of |x| (m, D), 30 bisection steps over [0, max] keep
// count(|x| >= lo) >= k, so lo ends at most one ulp below the k-th largest
// magnitude; k > D never moves lo from 0.  Every step is the reference's
// f32 arithmetic: mid = 0.5 * (lo + hi) through __fmul_rn / __fadd_rn,
// flushed to 0 where subnormal (as the reference's XLA runs flush it; the
// flush is explicit, not -ftz=true, which would change every kernel the
// same flags build), an exact integer count, then count >= k moves lo or
// hi.  So the thresholds are bitwise those of the reference and of
// kernels/ref.py.
//
// Bound on this card: one read of |x| (3.81 MB at the main path's
// (20, 47,571) f32: 0.0011 ms at 3.35 TB/s).  What sets the time is not
// the bytes but the chain of 30 bisection steps, each of which needs the
// count over the whole row before the next midpoint is known.
//
// Design: a cluster of 8 blocks (256 threads each) per row, so 20 rows
// light 160 blocks on 120 SMs, each block holding an eighth of the row.  A
// slice of up to 32 values a thread stays in registers (D up to 65,536),
// a longer one in shared memory (up to the card's opt-in limit a block, D
// up to ~460,000), and a row longer still is re-read from global memory
// (L2) on every pass: instances of one kernel, `repro_topk_threshold_path`
// says which a shape takes.
//  - Multi-level bisection: the next kLevels steps form a tree of
//    2^kLevels − 1 candidate midpoints, each the same f32 expression of the
//    lo and hi that the earlier outcomes select, so one pass counts all of
//    them and the walk down the tree then takes the decisions the
//    sequential steps would, bit for bit: 30 steps become 10 passes.
//  - Counts are f32 in a thread (exact below 2^24), summed within the warp
//    (__reduce_add_sync; two 16-bit counts a word on the register path),
//    then the block (a word a warp in shared memory), then across the
//    cluster: thread r of each block pushes the block's counts into block
//    r's shared memory with st.async, which completes the transaction
//    count of block r's mbarrier for that pass (two buffers, each with its
//    mbarrier, alternate between passes).  Each thread waits on its own
//    block's mbarrier and sums the 8 blocks' counts in rank order, so all
//    threads of the cluster hold the same lo and hi with no cluster-wide
//    barrier.  A block cannot push pass p + 2 into a buffer before every
//    thread of the receiver is past pass p's wait, since that needs the
//    receiver's pass p + 1 counts.  The row max goes the same way before
//    pass 0 (NaN-propagating, as jnp.max), under the one barrier.cluster,
//    which also publishes the mbarriers' initialisation.
//  - The register path counts its values in registers at pass 0 only.
//    Every later candidate lies within [lo, hi] of the walk's outcome, so
//    a value >= hi is counted by all of them and one < lo by none: after
//    each pass a warp packs the values still in [lo, hi) into its list in
//    shared memory (ballot + popc; in place after pass 0) and each thread
//    keeps the number of its values >= hi.  With a continuous row the list
//    shrinks about 8x a pass.  (Above 1e38 a midpoint could overflow past
//    hi, and a NaN hi compares false with all: there every value stays.)
// Integer counts, no atomics: the result is the same from call to call.
#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // blocks a row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 30;         // N_ITER of the TPU kernel
constexpr int kLevels = 3;         // bisection steps a pass
constexpr int kNodes = (1 << kLevels) - 1;
constexpr int kSlots = (kNodes + 4) / 4 * 4;  // counts padded to int4s
constexpr int kRegMax = 32;        // values a thread in registers, at most
constexpr int kShared = 0;         // instance of the shared-memory path
constexpr int kGlobal = -1;        // instance of the long-row path
constexpr int kSmemMargin = 2048;  // static shared memory + headroom

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// the same shared-memory address in block `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
}
// this block's one arrival of a phase, which then completes when `bytes`
// of st.async have landed
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}" ::"r"(bar), "r"(parity) : "memory");
}
// 16 bytes into another block's shared memory, counted by its mbarrier
__device__ __forceinline__ void st_async(unsigned addr, int4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// depth of heap node n (the root, 1, is at 0)
__device__ constexpr int level_of(int n) { return n > 1 ? 1 + level_of(n / 2) : 0; }

// R > 0: the slice in registers, R values a thread; kShared: in dynamic
// shared memory; kGlobal: re-read from global memory every pass
template <int R>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    topk_kernel(const float* __restrict__ a, float* __restrict__ out, int d,
                int slice, long long k) {
  // the shared path's slice (slice,); the register path's per-warp lists
  // of the values still inside [lo, hi) (kWarps, 32·R)
  extern __shared__ float dyn_s[];
  float* slice_s = dyn_s;
  __shared__ float wmax_s[kWarps];
  __shared__ float rmax_s[kCluster];  // every block's max, pushed to all
  // per warp, then every block's counts, pushed to all; both
  // double-buffered across passes, the latter with an mbarrier each
  __shared__ __align__(16) int wcnt_s[2][kWarps][kSlots];
  __shared__ __align__(16) int rcnt_s[2][kCluster][kSlots];
  __shared__ __align__(8) unsigned long long bar_s[2];
  constexpr unsigned kPassBytes = kCluster * kSlots * sizeof(int);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x / kCluster;
  const int b0 = rank * slice;
  const int n = max(0, min(d - b0, slice));
  const float* src = a + row * d + b0;

  // the slice, and its max; NaN pads the register slots past n (no count
  // takes it: NaN >= mid is false)
  constexpr int RR = R > 0 ? R : 1;
  float v[RR];
  float mx = __uint_as_float(0xff800000u);  // -inf
  if constexpr (R > 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = tid + i * kThreads;
      v[i] = j < n ? src[j] : __uint_as_float(0x7fc00000u);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (tid + i * kThreads < n) mx = nan_max(mx, v[i]);
  } else {
    int j = tid;
    for (; j + 7 * kThreads < n; j += 8 * kThreads) {
      float w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = src[j + e * kThreads];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (R == kShared) slice_s[j + e * kThreads] = w[e];
        mx = nan_max(mx, w[e]);
      }
    }
    for (; j < n; j += kThreads) {
      const float w = src[j];
      if constexpr (R == kShared) slice_s[j] = w;
      mx = nan_max(mx, w);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) wmax_s[warp] = mx;
  if (tid == 0) {  // armed for passes 0 and 1 before any block can push
    mbar_init(smem_addr(&bar_s[0]));
    mbar_init(smem_addr(&bar_s[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_addr(&bar_s[0]), kPassBytes);
    mbar_expect(smem_addr(&bar_s[1]), kPassBytes);
  }
  __syncthreads();
  if (tid < kCluster) {  // thread r pushes the block's max to block r
    float bm = wmax_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) bm = nan_max(bm, wmax_s[w]);
    *cluster.map_shared_rank(&rmax_s[rank], tid) = bm;
  }
  cluster.sync();  // every block's max (and its shared slice) arrived
  float hi = rmax_s[0];
#pragma unroll
  for (int r = 1; r < kCluster; ++r) hi = nan_max(hi, rmax_s[r]);

  float lo = 0.0f;
  constexpr int kPasses = (kIters + kLevels - 1) / kLevels;
  // register path after pass 0: this warp's values in [lo, hi), and per
  // thread the number of its values >= hi (which every later candidate,
  // all within [lo, hi], counts)
  float* list = dyn_s + warp * 32 * RR;
  int n_list = 0, base = 0;
  for (int done = 0, pass = 0; done < kIters; done += kLevels, ++pass) {
    const int levels = min(kLevels, kIters - done);
    // the tree's candidates, in heap order (node n at mid[n − 1]; its
    // children: 2n when count < k moves hi, 2n + 1 when it moves lo).
    // Node n's lo and hi are those its ancestors' outcomes select, taken
    // from the root down.
    float mid[kNodes];
#pragma unroll
    for (int nd = 1; nd <= kNodes; ++nd) {
      float l = lo, h = hi;
#pragma unroll
      for (int sh = kLevels - 1; sh >= 1; --sh) {
        const int anc = nd >> sh;
        if (anc >= 1) {
          if ((nd >> (sh - 1)) & 1)
            l = mid[anc - 1];
          else
            h = mid[anc - 1];
        }
      }
      const float c = __fmul_rn(0.5f, __fadd_rn(l, h));
      mid[nd - 1] = fabsf(c) < FLT_MIN ? 0.0f : c;
    }
    // counted in f32 (exact: a thread counts fewer than 2^24 values)
    float cf[kSlots];
#pragma unroll
    for (int e = 0; e < kSlots; ++e) cf[e] = 0.f;
    if constexpr (R > 0) {
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int e = 0; e < kNodes; ++e) cf[e] += v[i] >= mid[e] ? 1.f : 0.f;
      } else {
        for (int j = lane; j < n_list; j += 32) {
          const float w = list[j];
#pragma unroll
          for (int e = 0; e < kNodes; ++e) cf[e] += w >= mid[e] ? 1.f : 0.f;
        }
      }
    } else {
#pragma unroll 4
      for (int j = tid; j < n; j += kThreads) {
        const float w = R == kShared ? slice_s[j] : src[j];
#pragma unroll
        for (int e = 0; e < kNodes; ++e) cf[e] += w >= mid[e] ? 1.f : 0.f;
      }
    }
    int c[kSlots];
#pragma unroll
    for (int e = 0; e < kSlots; ++e) c[e] = (int)cf[e] + base;
    const int buf = pass & 1;
    if constexpr (R > 0) {
      // a thread's counts are at most 2R <= 64 and a warp's at most 2,048:
      // two to a word, half the warp reductions
#pragma unroll
      for (int e = 0; e < kSlots; e += 2) {
        const int s =
            __reduce_add_sync(0xffffffffu, c[e] | (c[e + 1] << 16));
        if (lane == 0) {
          wcnt_s[buf][warp][e] = s & 0xffff;
          wcnt_s[buf][warp][e + 1] = s >> 16;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kSlots; ++e) {
        const int s = __reduce_add_sync(0xffffffffu, c[e]);
        if (lane == 0) wcnt_s[buf][warp][e] = s;
      }
    }
    __syncthreads();
    if (tid < kCluster) {  // thread r pushes the block's counts to block r
      int4 s[kSlots / 4];
#pragma unroll
      for (int e = 0; e < kSlots / 4; ++e) {
        s[e] = reinterpret_cast<const int4*>(wcnt_s[buf][0])[e];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const int4 x = reinterpret_cast<const int4*>(wcnt_s[buf][w])[e];
          s[e].x += x.x; s[e].y += x.y; s[e].z += x.z; s[e].w += x.w;
        }
      }
      const unsigned dst = cluster_addr(smem_addr(&rcnt_s[buf][rank][0]), tid);
      const unsigned bar = cluster_addr(smem_addr(&bar_s[buf]), tid);
#pragma unroll
      for (int e = 0; e < kSlots / 4; ++e) st_async(dst + 16 * e, s[e], bar);
    }
    // this pass's counts of every block arrived (phase pass / 2 of the
    // buffer's mbarrier); no block can push pass + 2's before every
    // thread here is past this wait, since that needs our pass + 1
    mbar_wait(smem_addr(&bar_s[buf]), (pass >> 1) & 1);
    if (tid == 0 && pass + 2 < kPasses)
      mbar_expect(smem_addr(&bar_s[buf]), kPassBytes);
    int tot[kSlots];
#pragma unroll
    for (int e = 0; e < kSlots; ++e) tot[e] = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
#pragma unroll
      for (int e = 0; e < kSlots / 4; ++e) {
        const int4 x = reinterpret_cast<const int4*>(rcnt_s[buf][r])[e];
        tot[4 * e] += x.x;
        tot[4 * e + 1] += x.y;
        tot[4 * e + 2] += x.z;
        tot[4 * e + 3] += x.w;
      }
    // walk down the tree, level by level (heap order): the sequential
    // steps' decisions
    int node = 1;
#pragma unroll
    for (int nd = 1; nd <= kNodes; ++nd)
      if (nd == node && level_of(nd) < levels) {
        const bool ge = (long long)tot[nd - 1] >= k;
        lo = ge ? mid[nd - 1] : lo;
        hi = ge ? hi : mid[nd - 1];
        node = 2 * nd + (ge ? 1 : 0);
      }
    if constexpr (R > 0) {
      // keep the values still inside [lo, hi), packed at the front of the
      // warp's list (in place after pass 0: a round writes below what it
      // read); the rest are counted by every later candidate (>= hi) or
      // by none (< lo).  Above 1e38 a midpoint could overflow past hi, and
      // a NaN hi compares false with all: there every non-NaN value stays.
      if (pass + 1 < kPasses) {
        const bool tight = hi <= 1e38f;
        const unsigned below = (1u << lane) - 1u;
        int kept = 0;
        if (pass == 0) {
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float w = v[i];
            const bool keep = tight ? w >= lo && w < hi : w == w;
            base += tight && w >= hi ? 1 : 0;
            const unsigned bal = __ballot_sync(0xffffffffu, keep);
            if (keep) list[kept + __popc(bal & below)] = w;
            kept += __popc(bal);
          }
        } else {
          for (int j0 = 0; j0 < n_list; j0 += 32) {
            const float w = j0 + lane < n_list ? list[j0 + lane]
                                               : __uint_as_float(0x7fc00000u);
            const bool keep = tight ? w >= lo && w < hi : w == w;
            base += tight && w >= hi ? 1 : 0;
            const unsigned bal = __ballot_sync(0xffffffffu, keep);
            __syncwarp();
            if (keep) list[kept + __popc(bal & below)] = w;
            kept += __popc(bal);
          }
        }
        n_list = kept;
        __syncwarp();
      }
    }
  }
  // every block's stores into this one have landed: it may leave
  if (rank == 0 && tid == 0) out[row] = lo;
}

int optin_smem() {
  int dev = 0, optin = 48 * 1024;
  if (cudaGetDevice(&dev) != cudaSuccess) return optin;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

int slice_of(long long d) { return (int)((d + kCluster - 1) / kCluster); }

// the register path's per-warp lists: a block's R values a thread
size_t list_bytes(int r) { return sizeof(float) * (size_t)kThreads * r; }

// register slots a thread for a slice (a multiple of 8 up to kRegMax),
// kShared or kGlobal
int path_of(long long d, int optin) {
  const int slice = slice_of(d);
  const int per = (slice + kThreads - 1) / kThreads;
  if (per <= kRegMax) return per <= 8 ? 8 : (per + 7) / 8 * 8;
  if ((long long)sizeof(float) * slice + kSmemMargin <= optin) return kShared;
  return kGlobal;
}

template <int R>
int launch(const float* a, float* out, int m, int d, long long k, size_t smem,
           cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topk_kernel<R><<<(unsigned)m * kCluster, kThreads, smem, s>>>(
      a, out, d, slice_of(d), k);
  return (int)cudaGetLastError();
}

}  // namespace

// Where a row of d f32 is held on the current device: 0 registers,
// 1 shared memory, 2 re-read from global memory every pass.
extern "C" int repro_topk_threshold_path(long long d) {
  const int p = path_of(d, optin_smem());
  return p > 0 ? 0 : p == kShared ? 1 : 2;
}

// a (m, d) f32 magnitudes -> out (m, 1) f32 thresholds, k >= 1, d < 2^31,
// m · 8 < 2^31.  Returns the cudaError_t of the attribute call or of the
// launch.
extern "C" int repro_topk_threshold(const void* a, void* out, int m,
                                    long long d, long long k, void* stream) {
  if (m < 1 || d < 1 || d > 0x7fffffffLL || k < 1 ||
      (long long)m * kCluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* of = static_cast<float*>(out);
  const int di = (int)d;
  switch (path_of(d, optin_smem())) {
    case 8: return launch<8>(af, of, m, di, k, list_bytes(8), s);
    case 16: return launch<16>(af, of, m, di, k, list_bytes(16), s);
    case 24: return launch<24>(af, of, m, di, k, list_bytes(24), s);
    case 32: return launch<32>(af, of, m, di, k, list_bytes(32), s);
    case kShared:
      return launch<kShared>(af, of, m, di, k,
                             sizeof(float) * (size_t)slice_of(d), s);
    default: return launch<kGlobal>(af, of, m, di, k, 0, s);
  }
}
