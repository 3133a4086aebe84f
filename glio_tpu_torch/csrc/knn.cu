// Exact brute-force k-nearest-neighbour search, f32, for NVIDIA Hopper (sm_90a).
//
// Replaces glio_tpu/ops/knn_pallas.py::_knn_kernel (the TPU kernel behind
// knn_pallas, a drop-in for glio_tpu.lidar.neighbors.knn) and serves the
// sliding-window association, 5 x 1024 window points against a voxelled
// local map of at most 16,384 points, and batch level 1's association,
// ~21 k keyframe pairs of 1024 x 1024 points in one launch
// (glio_knn5_pairs_f32).
//
// Contract (neighbors.knn's, which the estimator consumes):
//   * squared distance computed directly as (dx*dx + dy*dy) + dz*dz. The
//     |q|^2 + |p|^2 - 2 q.p expansion of the TPU kernel cancels at world-scale
//     coordinates. Built with --fmad=false, so no multiply-add is contracted
//     and the result equals the plain torch version bit for bit;
//   * invalid map points are skipped;
//   * output sorted ascending, ties going to the lowest map index;
//   * missing slots and invalid queries come back as +inf / -1;
//   * indices are int64.
//
// What bounds it: FP32 issue, not bytes. Q x N pairs at 8 operations each
// (3 sub, 3 mul, 2 add; no FMA) plus a compare; at 5120 x 16,384 that is
// ~20 us on 132 SMs x 128 lanes x 1.98 GHz, while the inputs and outputs
// (under 600 KB, L2-resident) move in under 1 us. What costs beyond that
// is keeping the top-k: an insertion into a sorted list of k is ~30
// instructions, and a query meets ~k ln(n / k) of them in a scan of n points.
//
// Design. The map may be split between the blocks of a cluster, and each
// warp scans for two queries at once:
//   * a tile of kTileQueries = 16 queries (8 warps x kR = 2) is served by a
//     thread-block cluster of C blocks (C in {1, 2, 4, 8}, the portable
//     sizes). Block r of the cluster takes the contiguous map split
//     [r * split, (r + 1) * split), clipped to N. ops/knn.py::knn_plan picks
//     C and split: every split costs each query a fresh top-k warm-up, so it
//     takes the fewest splits that give every SM a block (at the window's
//     5120 x 16,384, C = 1 and 320 tiles; at the odometry's 1024 or 2048
//     scan points against its 16,384-point map, C = 4 or 2);
//   * the block stages its split into shared memory as it lies (x, y, z a
//     point), kTile = 2048 points (24 KB) at a time, with 16-byte loads where
//     the split starts 16-byte aligned (knn_plan makes splits a multiple of
//     4 points); then every invalid point's coordinates become +inf. For a
//     finite query its distance is then +inf, and the strict '<' against the
//     k-th best distance rejects it, as the plain version's +inf does, so the
//     scan has no validity test;
//   * each of the block's 8 warps takes kR = 2 of the tile's queries, and its
//     32 lanes take 32 consecutive map points a step: a lane reads its point
//     once (three conflict-free 4-byte shared loads, stride 3) and computes
//     kR distances. Every lane holds the same sorted top-k of
//     each query in registers (k is a template parameter, so the insertion
//     network unrolls to constant register indices). A warp computes kSteps
//     = 8 steps before it votes: each lane sets one bit a (step, query) whose
//     distance beats the k-th best, and a warp-wide OR (redux.sync) says
//     which pairs have candidates. Only those are done again, each query's
//     in ascending steps: a ballot finds the step's candidates and the warp
//     inserts them together, the lowest lane first, or, where a step has more
//     than a few (the first steps of a scan), by k rounds of a warp-wide
//     lexicographic minimum. Every branch is the same for the whole warp, so
//     a query meets ~k ln(n / 32) insertion steps in a scan of n points,
//     where a thread per query would stall its warp on the union of 32
//     queries' insertions, ~32 k / t at the t-th point;
//   * the warp keeps each query's list in shared memory between stages; then
//     cluster.sync(), and block r merges the lists of its 1/C share of the
//     tile's queries: lane (query, peer block) of warp 0 reads that peer's
//     list through distributed shared memory (map_shared_rank), and the C
//     lanes of a query merge pairwise by warp shuffles. A second
//     cluster.sync() keeps each block's shared memory alive until its peers
//     have read it.
//     One launch, no global scratch, no atomics.
// A batch of independent problems takes the grid's y dimension: block row b
// queries frame pair_i[b] of a stack of equal-sized clouds against the map
// frame pair_j[b] of the same stack (batch level 1's keyframe pairs, 1024 x
// 1024 each), and writes the b-th (S, K) slice of the output. Only the base
// pointers move; the scan, the merge and the contract are the same.
//
// Why the result is the plain version's, bit for bit, whatever the order in
// which blocks run: the plain version's output is the first k pairs, in the
// lexicographic order of (distance, index), among the valid points (its
// ascending scan with a strict '<' sends ties to the lowest index). Every
// map index lies in exactly one split, so the first k of the whole map are
// among the union of each split's first k. Within a split a warp offers the
// candidates to the list in ascending (distance, index) order within a step
// and in ascending steps, so the strict '<' insertion keeps each split's
// first k exactly. The merge compares (distance, index) lexicographically, a
// total order on distinct indices, so the merged list is the first k of the
// union, independent of the merge's order. Each distance is computed by the
// same f32 operations as the plain version.
//
// A query with a non-finite coordinate gets d = +inf or NaN for every
// point and no neighbour (+inf / -1); on the main path such a query is
// invalid and is masked at the output anyway.
//
// What stays out, and why: wgmma (tensor cores compute products, not
// squared differences); the |q|^2 + |p|^2 - 2 q.p expansion (it cancels at
// world-scale coordinates, neighbors.py in the JAX package, and would break
// the bit equality that keeps the replay's association equal to JAX's);
// TMA (the map is 213 KB and L2-resident; plain 16-byte loads stage it).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQueriesPerWarp = 2;   // kR: queries a warp scans for at once
constexpr int kTileQueries = kWarps * kQueriesPerWarp;   // 16 queries a tile
constexpr int kTile = 2048;          // map points staged at a time
constexpr int kMaxCluster = 8;
constexpr int kSteps = 8;            // steps of 32 points computed before a vote
constexpr int kFewCandidates = 2;    // at most this many: one at a time
constexpr unsigned kAll = 0xffffffffu;
static_assert(kSteps * kQueriesPerWarp <= 32 && kSteps < 32, "one candidate bit a (step, query)");
static_assert(kTileQueries % kMaxCluster == 0 && kTileQueries <= 32, "the merge: one warp");

// The plain version's squared distance: three differences, three products,
// two sums, in this order (built with --fmad=false: no contraction).
__device__ __forceinline__ float dist2(float qx, float qy, float qz, float px, float py,
                                       float pz) {
  const float dx = qx - px;
  const float dy = qy - py;
  const float dz = qz - pz;
  return (dx * dx + dy * dy) + dz * dz;
}

// (d, i) comes before (e, j) in the lexicographic order of (distance, index).
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Inserts (d, i) into the sorted list (bd, bi) if it comes before the last
// entry; the entries after its place move down by one and the last drops out.
// Empty slots hold (+inf, -1), and +inf candidates are never inserted.
// kScan: i comes after every entry of equal distance in the list, as along
// an ascending scan, so "before" is d < e alone, one compare a slot.
template <int K, bool kScan>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
  auto before_ = [&](int s) { return kScan ? d < bd[s] : before(d, i, bd[s], bi[s]); };
  if (!before_(K - 1)) return;
#pragma unroll
  for (int s = K - 1; s >= 0; --s) {
    const bool moves = before_(s);
    if (moves && s + 1 < K) {
      bd[s + 1] = bd[s];
      bi[s + 1] = bi[s];
    }
    if (moves && (s == 0 || !before_(s - 1))) {
      bd[s] = d;
      bi[s] = i;
    }
  }
}

// The warp's candidates of one step: lane l (set in `mask`) offers
// (d, first + l). Every lane holds the same list and gets the same result.
template <int K>
__device__ __forceinline__ void insert_step(float (&bd)[K], int (&bi)[K], unsigned mask,
                                            float d, int first, int lane) {
  if (__popc(mask) <= kFewCandidates) {
    // The lowest lane first: ascending index, so ties keep the lower one.
    for (; mask; mask &= mask - 1) {
      const int l = __ffs(mask) - 1;
      const float c = __shfl_sync(kAll, d, l);
      insert<K, true>(bd, bi, c, first + l);
    }
    return;
  }
  // Many candidates (the first steps of a scan): the step's k smallest by
  // (distance, lane), each by a butterfly minimum, in ascending order.
  float mine = (mask >> lane) & 1 ? d : INFINITY;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float v = mine;
    int l = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(kAll, v, off);
      const int l2 = __shfl_xor_sync(kAll, l, off);
      if (before(v2, l2, v, l)) {
        v = v2;
        l = l2;
      }
    }
    if (!(v < bd[K - 1])) break;
    insert<K, true>(bd, bi, v, first + l);
    if (lane == l) mine = INFINITY;
  }
}

// Stages points [0, n) of `src` (n x 3 floats) into `stage` as they lie,
// with 16-byte loads where `src` is 16-byte aligned, then sets the
// coordinates of each invalid point to +inf. Ends with a block barrier.
__device__ __forceinline__ void stage_points(float* stage, const float* __restrict__ src,
                                             const uint8_t* __restrict__ valid, int n) {
  const int nf = 3 * n;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = nf / 4 * 4;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    float4* stage4 = reinterpret_cast<float4*>(stage);
#pragma unroll 4
    for (int i = threadIdx.x; i < nf / 4; i += kThreads) stage4[i] = src4[i];
  }
  for (int e = done + threadIdx.x; e < nf; e += kThreads) stage[e] = src[e];
  __syncthreads();
  for (int t = threadIdx.x; t < n; t += kThreads) {
    if (!valid[t]) stage[3 * t] = stage[3 * t + 1] = stage[3 * t + 2] = INFINITY;
  }
  __syncthreads();
}

template <int K, int kR, bool kPairs>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const uint8_t* __restrict__ query_valid,
           const float* __restrict__ points, const uint8_t* __restrict__ points_valid,
           int n_query, int n_points, int split,
           float* __restrict__ out_d, int64_t* __restrict__ out_i,
           const int64_t* __restrict__ pair_i, const int64_t* __restrict__ pair_j,
           int64_t n_frames) {
  __shared__ __align__(16) float stage[3 * kTile];   // point t at [3 t, 3 t + 3)
  __shared__ float list_d[kTileQueries * K];   // query j's list at [j * K, j * K + K)
  __shared__ int list_i[kTileQueries * K];
  if constexpr (kPairs) {
    // Pairs: query and map are frames of one stack of n_frames clouds of
    // n_query (= n_points) points each.
    const int64_t b = blockIdx.y;
    const int64_t fi = pair_i[b];
    const int64_t fj = pair_j[b];
    if (fi < 0 || fi >= n_frames || fj < 0 || fj >= n_frames) __trap();   // a caller's bug
    query += fi * 3 * n_query;
    query_valid += fi * n_query;
    points += fj * 3 * n_points;
    points_valid += fj * n_points;
    out_d += b * n_query * K;
    out_i += b * n_query * K;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int q0 = (blockIdx.x / csize) * kTileQueries;   // the tile's first query
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j0 = warp * kR;   // the warp's queries: q0 + j0 + r, r < kR

  for (int e = threadIdx.x; e < kTileQueries * K; e += kThreads) {
    list_d[e] = INFINITY;
    list_i[e] = -1;
  }

  // The block's split [lo, hi); ops/knn.py::knn_splits computes the same.
  const int lo = min(rank * split, n_points);
  const int hi = min(lo + split, n_points);
  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    __syncthreads();   // the previous stage and lists are no longer in use
    stage_points(stage, points + 3 * static_cast<int64_t>(base), points_valid + base, n);

    float qx[kR], qy[kR], qz[kR];
    float bd[kR][K];
    int bi[kR][K];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int q = q0 + j0 + r;
      const bool active = q < n_query;
      qx[r] = active ? query[3 * q] : 0.f;
      qy[r] = active ? query[3 * q + 1] : 0.f;
      qz[r] = active ? query[3 * q + 2] : 0.f;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        bd[r][s] = list_d[(j0 + r) * K + s];
        bi[r][s] = list_i[(j0 + r) * K + s];
      }
    }
    // kSteps steps of 32 points at a time. First only which (step, query)
    // pairs have a candidate in some lane: bit r * kSteps + u, OR-ed over
    // the warp. Then those pairs again, each query's in ascending steps,
    // the distances recomputed (the same operations, so the same bits).
    for (int t0 = 0; t0 < n; t0 += 32 * kSteps) {
      unsigned bits = 0;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = t0 + 32 * u + lane;
        const float px = t < n ? stage[3 * t] : INFINITY;
        const float py = t < n ? stage[3 * t + 1] : INFINITY;
        const float pz = t < n ? stage[3 * t + 2] : INFINITY;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (dist2(qx[r], qy[r], qz[r], px, py, pz) < bd[r][K - 1]) bits |= 1u << (r * kSteps + u);
        }
      }
      bits = __reduce_or_sync(kAll, bits);
      if (bits == 0) continue;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        for (unsigned m = (bits >> (r * kSteps)) & ((1u << kSteps) - 1); m; m &= m - 1) {
          const int u = __ffs(m) - 1;
          const int t = t0 + 32 * u + lane;
          const float px = t < n ? stage[3 * t] : INFINITY;
          const float py = t < n ? stage[3 * t + 1] : INFINITY;
          const float pz = t < n ? stage[3 * t + 2] : INFINITY;
          const float d = dist2(qx[r], qy[r], qz[r], px, py, pz);
          const unsigned mask = __ballot_sync(kAll, d < bd[r][K - 1]);
          if (mask) insert_step<K>(bd[r], bi[r], mask, d, base + t0 + 32 * u, lane);
        }
      }
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int s = 0; s < K; ++s) {
          list_d[(j0 + r) * K + s] = bd[r][s];
          list_i[(j0 + r) * K + s] = bi[r][s];
        }
      }
    }
  }
  cluster.sync();   // every block's lists are written and visible

  // Block `rank` merges the tile's queries [rank * share, (rank + 1) * share):
  // lane (jj, peer) of warp 0 reads the peer block's list of query jj, then
  // the C lanes of the query (neighbouring lanes, C divides 16) merge by
  // shuffles. Lanes past the tile hold empty lists and write nothing.
  if (warp == 0) {
    const int share = kTileQueries / csize;
    const bool live = lane < kTileQueries;
    const int peer = lane % csize;
    const int j = rank * share + (live ? lane / csize : 0);
    float md[K];
    int mi[K];
    const float* peer_d = cluster.map_shared_rank(list_d, peer);
    const int* peer_i = cluster.map_shared_rank(list_i, peer);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      md[s] = live ? peer_d[j * K + s] : INFINITY;
      mi[s] = live ? peer_i[j * K + s] : -1;
    }
    for (int off = 1; off < csize; off <<= 1) {
      float od[K];
      int oi[K];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        od[s] = __shfl_xor_sync(kAll, md[s], off);
        oi[s] = __shfl_xor_sync(kAll, mi[s], off);
      }
#pragma unroll
      for (int s = 0; s < K; ++s) insert<K, false>(md, mi, od[s], oi[s]);
    }
    const int q = q0 + j;
    if (live && peer == 0 && q < n_query) {
      const bool ok = query_valid[q] != 0;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        out_d[static_cast<int64_t>(q) * K + s] = ok ? md[s] : INFINITY;
        out_i[static_cast<int64_t>(q) * K + s] = ok ? static_cast<int64_t>(mi[s]) : -1;
      }
    }
  }
  cluster.sync();   // the peers have read this block's lists before it exits
}

// One launch of knn_kernel: ceil(n_query / 16) clusters of `cluster` blocks
// along x, `rows` problems along y. Returns the launch's cudaError_t.
template <bool kPairs>
int launch(const void* query, const void* query_valid, const void* points,
           const void* points_valid, size_t n_query, size_t n_points, size_t cluster,
           size_t split, void* out_d, void* out_i, const void* pair_i, const void* pair_j,
           size_t n_frames, size_t rows, void* stream) {
  const size_t tiles = (n_query + kTileQueries - 1) / kTileQueries;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(tiles * cluster), static_cast<unsigned>(rows), 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, knn_kernel<5, kQueriesPerWarp, kPairs>, static_cast<const float*>(query),
      static_cast<const uint8_t*>(query_valid), static_cast<const float*>(points),
      static_cast<const uint8_t*>(points_valid), static_cast<int>(n_query),
      static_cast<int>(n_points), static_cast<int>(split), static_cast<float*>(out_d),
      static_cast<int64_t*>(out_i), static_cast<const int64_t*>(pair_i),
      static_cast<const int64_t*>(pair_j), static_cast<int64_t>(n_frames));
  if (err != cudaSuccess) {
    cudaGetLastError();   // leave no error behind for the next launch to report
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_plan(size_t n_query, size_t n_points, size_t cluster, size_t split) {
  return 3 * n_query > INT32_MAX || 3 * n_points > INT32_MAX || cluster < 1 ||
         cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 || split > n_points ||
         cluster * split < n_points;
}

}  // namespace

// query (Q, 3) f32, query_valid (Q,) bool, points (N, 3) f32, points_valid
// (N,) bool, all contiguous on one device; out_d (Q, 5) f32 and out_i (Q, 5)
// int64. (cluster, split) is ops/knn.py::knn_plan's. Launches a grid of
// ceil(Q / 16) clusters of `cluster` blocks on `stream` and returns the
// cudaError_t of the launch (0 on success). Coordinates are indexed in int32,
// so 3 Q and 3 N must fit in it.
// Every argument is 64 bits wide, which ctypes converts fastest.
extern "C" int glio_knn5_f32(const void* query, const void* query_valid, const void* points,
                             const void* points_valid, size_t n_query, size_t n_points,
                             size_t cluster, size_t split, void* out_d, void* out_i,
                             void* stream) {
  if (bad_plan(n_query, n_points, cluster, split)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_query == 0) return 0;
  return launch<false>(query, query_valid, points, points_valid, n_query, n_points, cluster,
                       split, out_d, out_i, nullptr, nullptr, 0, 1, stream);
}

// A batch of n_pairs problems over one stack of clouds: world (F, S, 3) f32
// and world_valid (F, S) bool, contiguous; pair_i and pair_j (n_pairs,) int64
// frame indices in [0, F), on the device. Problem b is
// glio_knn5_f32(world[pair_i[b]], ..., world[pair_j[b]], ...) into out_d
// (n_pairs, S, 5) f32 and out_i (n_pairs, S, 5) int64, indices into frame
// pair_j[b]'s S points. (cluster, split) is knn_plan's for S x S with the
// batch's tiles counted. One launch, n_pairs rows of the grid: at most
// 65,535 (the grid's y limit); more is refused, here and by the wrapper.
// A frame index out of range traps (a device-side fault, as a bad index of a
// PyTorch gather would).
extern "C" int glio_knn5_pairs_f32(const void* world, const void* world_valid,
                                   const void* pair_i, const void* pair_j, size_t n_frames,
                                   size_t n_scan, size_t n_pairs, size_t cluster, size_t split,
                                   void* out_d, void* out_i, void* stream) {
  if (bad_plan(n_scan, n_scan, cluster, split) || n_pairs > 65535 || n_frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs == 0 || n_scan == 0) return 0;
  return launch<true>(world, world_valid, world, world_valid, n_scan, n_scan, cluster, split,
                      out_d, out_i, pair_i, pair_j, n_frames, n_pairs, stream);
}
