// Exact brute-force k-nearest-neighbour search, f32, for NVIDIA Hopper (sm_90a).
//
// Replaces glio_tpu/ops/knn_pallas.py::_knn_kernel (the TPU kernel behind
// knn_pallas, a drop-in for glio_tpu.lidar.neighbors.knn) and serves the
// sliding-window association: 5 x 1024 window points against a voxelled
// local map of at most 16,384 points.
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
// What bounds it: FP32 compare-and-insert work, Q*N*(3 sub + 3 mul + 2 add +
// compares), not bytes: each map point is 16 bytes and is read once per
// block. Design: one thread per query, 128 threads a block; map tiles of
// 1024 points are staged through shared memory as float4 (x, y, z, valid),
// 16 KB, and each staged tile serves all 128 queries of the block. Each
// thread keeps its sorted top-k in registers (k is a template parameter, so
// the insertion network unrolls to constant register indices) and inserts
// with a strict '<' while scanning map indices in ascending order, which is
// what sends ties to the lowest index.
//
// Known limit: at Q = 5120 this launches 40 blocks on 132 SMs. Splitting the
// map across blocks and merging their top-k lists is the next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ query, const uint8_t* __restrict__ query_valid,
           const float* __restrict__ points, const uint8_t* __restrict__ points_valid,
           int n_query, int n_points,
           float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < n_query;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * q];
    qy = query[3 * q + 1];
    qz = query[3 * q + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = -1;
  }

  for (int base = 0; base < n_points; base += kTile) {
    const int n = min(kTile, n_points - base);
    __syncthreads();  // the previous tile is no longer read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int j = base + t;
      tile[t] = make_float4(points[3 * j], points[3 * j + 1], points[3 * j + 2],
                            points_valid[j] ? 1.f : 0.f);
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < n; ++t) {
      const float4 p = tile[t];
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      const float d = (dx * dx + dy * dy) + dz * dz;
      if (p.w == 0.f || !(d < bd[K - 1])) continue;
      const int idx = base + t;
      // Insert at the first slot whose distance is strictly greater; the
      // slots from there on move down by one and the last one drops out.
#pragma unroll
      for (int s = K - 1; s >= 0; --s) {
        const bool moves = d < bd[s];
        if (moves && s + 1 < K) {
          bd[s + 1] = bd[s];
          bi[s + 1] = bi[s];
        }
        if (moves && (s == 0 || !(d < bd[s - 1]))) {
          bd[s] = d;
          bi[s] = idx;
        }
      }
    }
  }

  if (active) {
    const bool ok = query_valid[q] != 0;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[(int64_t)q * K + s] = ok ? bd[s] : INFINITY;
      out_i[(int64_t)q * K + s] = ok ? (int64_t)bi[s] : -1;
    }
  }
}

}  // namespace

// query (Q, 3) f32, query_valid (Q,) bool, points (N, 3) f32, points_valid
// (N,) bool, all contiguous on one device; out_d (Q, 5) f32 and out_i (Q, 5)
// int64. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int glio_knn5_f32(const void* query, const void* query_valid,
                             const void* points, const void* points_valid,
                             int n_query, int n_points,
                             void* out_d, void* out_i, void* stream) {
  if (n_query <= 0) return 0;
  const int blocks = (n_query + kThreads - 1) / kThreads;
  knn_kernel<5><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const uint8_t*>(query_valid),
      static_cast<const float*>(points), static_cast<const uint8_t*>(points_valid),
      n_query, n_points, static_cast<float*>(out_d), static_cast<int64_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
