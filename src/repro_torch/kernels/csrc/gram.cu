// Gram matrix G = g gᵀ of client gradients and Δ_ij = ||g_i − g_j||² on
// Hopper (sm_90a), both from one deterministic launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pairwise_sqdist.py,
// function `gram_matrix` (body `_gram_kernel`), and the Δ assembly of
// `pairwise_sqdist` after it: g (m, D) fp32 -> G (m, m) fp32 and
// Δ = max((G_ii + G_jj) − 2·G_ij, 0), bitwise `ref.sqdist_from_gram(G)`.
//
// Bound on this card: g is read once (m·D·4 bytes) and G, Δ are small;
// the upper triangle is m(m+1)·D FLOPs.  At the main path's m = 20
// (D = 47,571) that is 5 FLOP a byte, far below the fp32 ridge: HBM bytes
// bound it (1.1 µs), and at that size launches and the cross-block
// reduction cost more than the bytes.  At m = 100 the FMAs (7 µs at 67
// TFLOP/s) bound it as much as the bytes (5.7 µs).
//
// Design:
// - Each block owns one contiguous D range and computes the whole m × m
//   partial of it for m <= 128 (one output tile, te = m rounded up to the
//   micro-tile edge R = 4); above 128, grid y enumerates the upper pairs
//   (ti <= tj) of 64-row tiles.  Only the upper triangle's R × R
//   micro-tiles are computed, and G_ij is mirrored into G_ji, so G is
//   exactly symmetric.  The grid is one wave: the wrapper asks
//   cudaOccupancyMaxActiveClusters how many clusters fit (on an H100, 30
//   at m = 100, where 33 made a second wave of one cluster).
// - The tile's rows move through a 3-stage cp.async ring of 64-column
//   slices (16-byte copies where g's base and row stride allow it, else
//   4-byte ones: LeNet's D = 47,571 rows are 4-byte aligned only).  A
//   slice is stored as (column quad, row) float4s with rows permuted to
//   (i mod R)·nb + i/R, so the lanes of a warp, which hold neighbouring
//   micro-tile columns, read neighbouring 16-byte words.
// - Thread (micro-tile, lane): lane l of L takes the slice's quads
//   l, l + L, ... (L > 1 when the tile has few micro-tiles, as at m = 20);
//   each holds R × R = 4 × 4 fp32 sums.  Per quad: 8 float4 loads, 64
//   FMAs.  (8 × 8 micro-tiles, a 2-stage ring, unrolling the quad loop and
//   prefetching the next quad's loads into registers were each slower at
//   m = 100 or no faster, on the H100.)
// - The cross-block sum is deterministic and stays in this launch; no
//   atomics touch values.  Blocks run in clusters of 8: after the lanes
//   are summed in lane order into the block's partial in shared memory,
//   rank r of the cluster sums its eighth of the entries over the 8
//   ranks' partials in rank order (distributed shared memory) into the
//   cluster's slot of the scratch.  Then a ticket: each thread fences its
//   slot writes (__threadfence) before the cluster barrier, and rank 0
//   takes atomicAdd on the tile's counter.  The cluster that draws the
//   last ticket sums the slots into G (each rank an eighth of the
//   entries, in runs of slots with 8 loads in flight, the runs added in
//   order) and resets the counter to 0; with several tiles it takes a
//   second ticket across them.  The last tile's cluster writes Δ from G
//   with __fadd_rn / __fsub_rn, in the reference's operation order.
// - Every sum runs in an order fixed by (m, D) alone, so G, Δ, the mixing
//   matrix and the k-means stream plan repeat bit for bit.
// - The counters are the wrapper's, zeroed once and reset by the last
//   cluster.  Two launches in flight on two streams must not share them:
//   their tickets would interleave and a cluster of one launch could take
//   the last ticket of the other's count.  The wrapper keys them by
//   (device, stream); launches on one stream run in order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // blocks of a cluster (grid.x % 8 == 0)
constexpr int kTd = 64;            // D columns a staged slice holds
constexpr int kQuads = kTd / 4;    // float4 column quads of a slice
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kSmemLimit = 232448; // bytes of shared memory a block can use
constexpr int kR = 4;              // micro-tile edge

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// micro-tile mt of a tile with nb 4-row blocks a side -> (bi, bj): the
// upper pairs bi <= bj row by row on a diagonal tile, all pairs off it
__device__ __forceinline__ void micro_tile(int mt, int nb, bool diag,
                                           int& bi, int& bj) {
  if (!diag) {
    bi = mt / nb;
    bj = mt - bi * nb;
    return;
  }
  bi = 0;
  while (mt >= nb - bi) {
    mt -= nb - bi;
    ++bi;
  }
  bj = bi + mt;
}

// floats of one ring stage: kQuads × te rows × 4, twice when tiles pair
__host__ __device__ inline int stage_floats(int te, int nt) {
  return kQuads * 4 * te * (nt > 1 ? 2 : 1);
}

// the ring, also the lanes' sums (threads × R × R) after the slices
__host__ __device__ inline int ring_floats(int te, int nt, int threads) {
  const int ring = kStages * stage_floats(te, nt);
  return ring > threads * kR * kR ? ring : threads * kR * kR;
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    gram_kernel(const float* __restrict__ g, float* __restrict__ scratch,
                int* __restrict__ counters, float* __restrict__ gram,
                float* __restrict__ delta, int m, long long d, int te, int nt,
                long long chunk, int lanes, int emax) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, nthreads = blockDim.x;
  float* ring = smem;
  float* part = smem + ring_floats(te, nt, nthreads);   // (emax)

  // this block's output tile (ti, tj) and D range [d0, d1)
  int y = blockIdx.y, ti = 0;
  while (y >= nt - ti) {
    y -= nt - ti;
    ++ti;
  }
  const int tj = ti + y;
  const bool diag = ti == tj;
  const int a0 = ti * te, b0 = tj * te;
  const int na = min(te, m - a0), nbr = min(te, m - b0);
  const int nb = te / kR;                        // 4-row blocks a side
  const int tcount = diag ? nb * (nb + 1) / 2 : nb * nb;
  const long long d0 = min(d, (long long)blockIdx.x * chunk);
  const long long d1 = min(d, d0 + chunk);
  const int nslices = (int)((d1 - d0 + kTd - 1) / kTd);
  const bool vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int sfl = stage_floats(te, nt);

  // slice s into its ring stage: row r of the tile (A rows, then B rows
  // off the diagonal) to float4 (column quad, (r mod R)·nb + r/R); a
  // thread keeps one column (4-byte copies: two) and walks the rows
  auto issue = [&](int s) {
    if (s < nslices) {
      float* st = ring + (s % kStages) * sfl;
      const long long c0 = d0 + (long long)s * kTd;
      const int rows = diag ? te : 2 * te;
      const int per = vec16 ? kQuads : 32;         // threads a row
      const int q = tid % per;
      for (int r = tid / per; r < rows; r += nthreads / per) {
        const int side = r >= te, lr = r - side * te;
        const bool row_ok = lr < (side ? nbr : na);
        const float* src = g + (size_t)((side ? b0 : a0) + lr) * d + c0;
        float* dst = st + side * kQuads * 4 * te + ((lr % kR) * nb + lr / kR) * 4;
        if (vec16) {
          const bool ok = row_ok && c0 + 4 * q < d1;
          cp_async16(dst + q * te * 4, ok ? src + 4 * q : g, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = q + 32 * h;
            const bool ok = row_ok && c0 + col < d1;
            cp_async4(dst + (col / 4) * te * 4 + col % 4, ok ? src + col : g,
                      ok ? 4 : 0);
          }
        }
      }
    }
    cp_async_commit();
  };

  const bool active = tid < tcount * lanes;
  const int mt = tid % tcount, lane = tid / tcount;
  int bi = 0, bj = 0;
  micro_tile(mt, nb, diag, bi, bj);
  float acc[kR][kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int c = 0; c < kR; ++c) acc[r][c] = 0.0f;
  }

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < nslices; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(s + kStages - 1);
    if (active) {
      const float4* A =
          reinterpret_cast<const float4*>(ring + (s % kStages) * sfl) + bi;
      const float4* B =
          (diag ? A - bi : A - bi + kQuads * te) + bj;
      for (int q = lane; q < kQuads; q += lanes) {
        float4 a[kR], b[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) a[r] = A[q * te + r * nb];
#pragma unroll
        for (int c = 0; c < kR; ++c) b[c] = B[q * te + c * nb];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
#pragma unroll
          for (int c = 0; c < kR; ++c) {
            float v = acc[r][c];
            v = fmaf(a[r].x, b[c].x, v);
            v = fmaf(a[r].y, b[c].y, v);
            v = fmaf(a[r].z, b[c].z, v);
            v = fmaf(a[r].w, b[c].w, v);
            acc[r][c] = v;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the lanes' sums, added in lane order: the block's partial, whose
  // entry mt·R² + r·R + c is (row R·bi + r, column R·bj + c) of micro-tile mt
  const int ecount = tcount * kR * kR;
  if (active) {
    float4* red =
        reinterpret_cast<float4*>(ring) + (lane * tcount + mt) * (kR * kR / 4);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int c = 0; c < kR; c += 4)
        red[(r * kR + c) / 4] = make_float4(acc[r][c], acc[r][c + 1],
                                           acc[r][c + 2], acc[r][c + 3]);
    }
  }
  __syncthreads();
  for (int e = tid; e < ecount; e += nthreads) {
    float v = ring[e];
    for (int l = 1; l < lanes; ++l) v += ring[l * ecount + e];
    part[e] = v;
  }

  // the cluster's partial: rank r sums its eighth of the entries (in
  // float4s) over the 8 ranks in rank order into the cluster's slot
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int ncl = gridDim.x / kCluster, cid = blockIdx.x / kCluster;
  const int n4 = ecount / 4;
  const int lo = n4 * rank / kCluster, hi = n4 * (rank + 1) / kCluster;
  const float4* part4 = reinterpret_cast<const float4*>(part);
  float4* slots =
      reinterpret_cast<float4*>(scratch + (size_t)blockIdx.y * ncl * emax);
  const int e4 = emax / 4;                       // float4s of one slot
  for (int u = lo + tid; u < hi; u += nthreads) {
    float4 v = cluster.map_shared_rank(part4, 0)[u];
#pragma unroll
    for (int q = 1; q < kCluster; ++q)
      add4(v, cluster.map_shared_rank(part4, q)[u]);
    slots[(size_t)cid * e4 + u] = v;
  }
  __threadfence();
  cluster.sync();            // slots written; no rank reads `part` any more

  // ticket on this tile: the cluster that draws the last one sums the slots
  if (rank == 0 && tid == 0) {
    const int t = atomicAdd(&counters[blockIdx.y], 1);
    __threadfence();
    flag = t == ncl - 1;
  }
  cluster.sync();
  const bool last = *cluster.map_shared_rank(&flag, 0) != 0;
  cluster.sync();            // rank 0's flag read by every rank
  if (!last) return;
  __threadfence();
  // rank r's eighth of the entries over the ncl slots: sg thread groups
  // each sum a contiguous run of slots in order, 8 float4 loads in flight
  // (a run costs ~ncl / 8 / sg L2 round trips, not ncl); then the runs are
  // added in run order
  const int cnt = hi - lo;
  int sg = 1;
  while (sg < kCluster && 2 * sg * cnt <= nthreads) sg *= 2;
  float4* runs = reinterpret_cast<float4*>(ring);      // (sg, cnt)
  for (int it = tid; it < sg * cnt; it += nthreads) {
    const int grp = it / cnt;
    const float4* p = slots + lo + (it - grp * cnt);
    int c = ncl * grp / sg;
    const int c1 = ncl * (grp + 1) / sg;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (; c + 8 <= c1; c += 8) {
      float4 x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) x[k] = __ldcg(p + (size_t)(c + k) * e4);
#pragma unroll
      for (int k = 0; k < 8; ++k) add4(v, x[k]);
    }
    for (; c < c1; ++c) add4(v, __ldcg(p + (size_t)c * e4));
    runs[it] = v;
  }
  __syncthreads();
  for (int u = tid; u < cnt; u += nthreads) {
    float4 v4 = runs[u];
    for (int grp = 1; grp < sg; ++grp) add4(v4, runs[grp * cnt + u]);
    const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * (lo + u) + k;
      int pi, pj;
      micro_tile(e / (kR * kR), nb, diag, pi, pj);
      const int i = a0 + kR * pi + (e / kR) % kR, j = b0 + kR * pj + e % kR;
      if (i < m && j < m && (!diag || i <= j)) {
        gram[(size_t)i * m + j] = vs[k];
        gram[(size_t)j * m + i] = vs[k];
      }
    }
  }
  if (rank == 0 && tid == 0) counters[blockIdx.y] = 0;
  __threadfence();
  cluster.sync();            // this tile of G is written

  // with several tiles, a ticket across them: the last tile's cluster
  // writes Δ from G (with one tile, this cluster is that one)
  const int ny = gridDim.y;
  if (ny > 1) {
    if (rank == 0 && tid == 0) {
      const int t = atomicAdd(&counters[ny], 1);
      __threadfence();
      flag = t == ny - 1;
    }
    cluster.sync();
    const bool final_tile = *cluster.map_shared_rank(&flag, 0) != 0;
    cluster.sync();
    if (!final_tile) return;
    __threadfence();
    if (rank == 0 && tid == 0) counters[ny] = 0;
  }
  const long long mm = (long long)m * m;
  const long long dlo = mm * rank / kCluster, dhi = mm * (rank + 1) / kCluster;
  for (long long e = dlo + tid; e < dhi; e += nthreads) {
    const int i = (int)(e / m), j = (int)(e - (long long)i * m);
    const float gii = __ldcg(gram + (size_t)i * m + i);
    const float gjj = __ldcg(gram + (size_t)j * m + j);
    const float v = __fsub_rn(__fadd_rn(gii, gjj),
                              __fmul_rn(2.0f, __ldcg(gram + e)));
    delta[e] = v < 0.0f ? 0.0f : v;
  }
}

}  // namespace

// Bytes of dynamic shared memory one block takes (pairwise_sqdist.py's
// `GramPlan.smem` repeats this formula).
extern "C" long long repro_gram_smem(int te, int nt, int threads, int emax) {
  return (long long)sizeof(float) * (ring_floats(te, nt, threads) + emax);
}

static cudaError_t set_smem(long long smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Clusters of 8 blocks of this size that the card runs at once (> 0), or
// minus a cudaError_t.
extern "C" int repro_gram_max_clusters(int threads, long long smem) {
  cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, gram_kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// One launch: g (m, d) fp32; scratch (ny, blocks / 8, emax) fp32;
// counters (ny + 1) int32, zero; gram and delta (m, m) fp32.  The grid is
// (blocks, ny), blocks a multiple of 8, ny = nt (nt + 1) / 2 tiles of te
// rows a side; block x owns columns [x·chunk, (x + 1)·chunk).  Returns a
// cudaError_t.
extern "C" int repro_gram_sqdist(const void* g, void* scratch, void* counters,
                                 void* gram, void* delta, int m, long long d,
                                 int te, int nt, long long chunk, int blocks,
                                 int lanes, int threads, int emax,
                                 void* stream) {
  if (m < 1 || d < 1 || te % kR != 0 || blocks % kCluster != 0 ||
      threads % 32 != 0 || threads > 1024 || lanes < 1 || emax % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long smem = repro_gram_smem(te, nt, threads, emax);
  cudaError_t err = set_smem(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)blocks, (unsigned)(nt * (nt + 1) / 2));
  gram_kernel<<<grid, threads, (size_t)smem,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(scratch),
      static_cast<int*>(counters), static_cast<float*>(gram),
      static_cast<float*>(delta), m, d, te, nt, chunk, lanes, emax);
  return (int)cudaGetLastError();
}
