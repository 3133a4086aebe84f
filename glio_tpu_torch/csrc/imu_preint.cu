// Midpoint IMU preintegration of padded sample runs, f64, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package preintegrates in plain JAX (a
// lax.scan, glio_tpu/factors/imu.py::preintegrate). It was added because
// the port's plain version, factors/imu.py::preintegrate_reference, is a
// Python loop over the padded buffer's samples, and on the card each of
// its ~376 operators a sample is a launch: 10,903 launches a keyframe for
// the window's 4 edges x 40 slots, dispatched by the host while the device
// waits, ahead of the LM on the keyframe's critical path.
//
// Contract (the loop's, Preintegration.h:96-235): for every edge, walk its
// samples in order; a valid sample takes one midpoint step of (dp, dq, dv),
// the 15 x 15 Jacobian (jac <- F jac) and covariance (cov <- (F cov) F^T +
// (V N) V^T, the full matrix: nothing is symmetrised), summing dt; an
// invalid sample leaves every state as it was, a_prev and g_prev included,
// which on finite inputs is what the loop's m * new + (1 - m) * old blend
// gives. The formulas are the loop's, operation for operation, and every
// matrix product sums over its inner index in index order. Built with
// --fmad=false, so no multiply-add is contracted.
//
// What bounds it: latency. One edge is 40 dependent steps of ~38 k f64
// operations each as the loop counts them (the four 15-wide products and
// the 18-wide noise ones); at the window's 4 edges the whole call is
// ~6 MFLOP, a fraction of a microsecond of the card's 34 TFLOP/s f64, and
// its ~27 KB of inputs and outputs less still. A step cannot start before
// the previous one ends, so the time is 40 x the step's critical path: the
// midpoint update's two square roots and eight divisions, short dependent
// sums and the block barriers between them. At the batch's 3,492 edges the
// blocks fill the card, and the f64 operations start to count.
//
// Design. One block an edge (the leading axes flattened: 4 blocks in the
// window, T - 1 in the batch's IMU chain), of two roles that overlap:
//   * the first warp walks the edge's samples in order, staging them into
//     shared memory kTile at a time, and keeps (q, p, v, sum_dt, a_prev,
//     g_prev) in registers: each of its threads computes the midpoint
//     update itself, so the state needs no barrier. Nine of its threads
//     then form one (row, column) entry each of the step's 3 x 3 matrices
//     (R(q), R(q_new), R0 [a0]x, R1 [a1]x, rot = I - [w]x dt, R1 [a1]x rot)
//     and write that entry of each of the 21 blocks of F (15 x 15) and V
//     (15 x 18) that change with the sample; the identity and zero blocks
//     are written once, before the walk. An invalid sample is skipped;
//   * the other kMatrixThreads threads propagate: jac' = F jac and
//     FC = F cov (225 threads, one pass over F's row), VN = V N (270
//     entries), a barrier of their own, then cov = (F cov) F^T + (V N) V^T
//     (225 threads). A product visits only the columns where F's or V's
//     row may be nonzero (f_row, v_row: 5.4 of F's 15 and 5.6 of V's 18 on
//     average), in index order; the rest hold exact zeros, which add
//     nothing to a sum of finite terms;
//   * the walk runs one step ahead: while the propagation takes step k from
//     one buffer of F and V, the first warp builds step k + 1 into the
//     other, so the square roots and divisions of the midpoint update leave
//     the critical path. One block barrier a step hands the buffers over;
//     the Jacobian, too, lives in two buffers that swap each step;
//   * at the end the block writes dp, dq, dv, sum_dt, the Jacobian and the
//     covariance once.
// Shared memory is ~24 KB a block; a sum is one thread's, so nothing is
// reduced across threads and no atomics are used: the result is the same
// on every run.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kS = 15;          // state: dp, dtheta, dv, dba, dbg
constexpr int kN = 18;          // noise: acc_n, gyr_n at i and j, acc_w, gyr_w
constexpr int kMatrixThreads = 256;                // warps 1-8: the propagation
constexpr int kThreads = 32 + kMatrixThreads;      // warp 0: the walk
constexpr int kTile = 64;                          // samples staged at a time

struct Shared {
  double noise[kN][kN];
  double jac[2][kS][kS];
  double cov[kS][kS];
  double F[2][kS][kS];
  double V[2][kS][kN];
  double FC[kS][kS];       // F cov
  double VN[kS][kN];       // V N
  double acc[kTile][3];
  double gyr[kTile][3];
  double dt[kTile];
  uint8_t ok[kTile];
  int steps;               // the edge's valid samples
};

// Row i of quat.to_rotmat(q), q = (w, x, y, z).
__device__ __forceinline__ void rot_row(const double q[4], int i, double r[3]) {
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  const double xx = x * x, yy = y * y, zz = z * z;
  const double wx = w * x, wy = w * y, wz = w * z;
  const double xy = x * y, xz = x * z, yz = y * z;
  if (i == 0) {
    r[0] = 1.0 - 2.0 * (yy + zz); r[1] = 2.0 * (xy - wz); r[2] = 2.0 * (xz + wy);
  } else if (i == 1) {
    r[0] = 2.0 * (xy + wz); r[1] = 1.0 - 2.0 * (xx + zz); r[2] = 2.0 * (yz - wx);
  } else {
    r[0] = 2.0 * (xz - wy); r[1] = 2.0 * (yz + wx); r[2] = 1.0 - 2.0 * (xx + yy);
  }
}

// Column j of so3.hat(v): hat(a) b = a x b.
__device__ __forceinline__ void hat_col(const double v[3], int j, double c[3]) {
  if (j == 0) {
    c[0] = 0.0; c[1] = v[2]; c[2] = -v[1];
  } else if (j == 1) {
    c[0] = -v[2]; c[1] = 0.0; c[2] = v[0];
  } else {
    c[0] = v[1]; c[1] = -v[0]; c[2] = 0.0;
  }
}

// a[k] for a k known only at run time, without taking a's address (which
// would put a in local memory).
__device__ __forceinline__ double pick(const double a[3], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : a[2]);
}

__device__ __forceinline__ void cross(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// quat.rotate: v + 2 (w (u x v) + u x (u x v)).
__device__ __forceinline__ void rotate(const double q[4], const double v[3], double out[3]) {
  const double u[3] = {q[1], q[2], q[3]};
  double uv[3], uuv[3];
  cross(u, v, uv);
  cross(u, uv, uuv);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = v[k] + 2.0 * (q[0] * uv[k] + uuv[k]);
}

__device__ __forceinline__ void normalize(double q[4]) {
  const double n = sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

// quat.mul: the Hamilton product a (x) b.
__device__ __forceinline__ void qmul(const double a[4], const double b[4], double out[4]) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// Entry (i, j) of the step's 3 x 3 matrices (Preintegration.h:118-166),
// written into that entry of each of the 21 blocks of F and V that change
// with the sample.
__device__ __forceinline__ void step_entries(double (*F)[kS], double (*V)[kN], int i, int j,
                                             const double q[4], const double qn[4],
                                             const double e0[3], const double e1[3],
                                             const double w[3], double h) {
  double r0[3], r1[3], c0[3], c1[3], cw[3];
  rot_row(q, i, r0);
  rot_row(qn, i, r1);
  hat_col(e0, j, c0);
  hat_col(w, j, cw);
  const double A0 = (r0[0] * c0[0] + r0[1] * c0[1]) + r0[2] * c0[2];     // R0 [a0]x
  // Row i of R1 [a1]x, then its product with column j of rot.
  double r1a1x[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    hat_col(e1, k, c1);
    r1a1x[k] = (r1[0] * c1[0] + r1[1] * c1[1]) + r1[2] * c1[2];
  }
  double rot_j[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) rot_j[k] = (k == j ? 1.0 : 0.0) - cw[k] * h;
  const double R0 = pick(r0, j), R1 = pick(r1, j), A1 = pick(r1a1x, j);
  // (-0.25 R1a1x) rot scales exactly by a power of two, so the product is
  // formed once and scaled where F uses it.
  const double M = (r1a1x[0] * rot_j[0] + r1a1x[1] * rot_j[1]) + r1a1x[2] * rot_j[2];
  const double eye = i == j ? 1.0 : 0.0;
  // F: rows dp, dtheta, dv; columns dp, dtheta, dv, dba, dbg.
  F[0 + i][3 + j] = -0.25 * A0 * h * h + -0.25 * M * h * h;
  F[0 + i][6 + j] = eye * h;
  F[0 + i][9 + j] = -0.25 * (R0 + R1) * h * h;
  F[0 + i][12 + j] = 0.25 * A1 * h * h * h;
  F[3 + i][3 + j] = pick(rot_j, i);
  F[3 + i][12 + j] = -eye * h;
  F[6 + i][3 + j] = -0.5 * A0 * h + -0.5 * M * h;
  F[6 + i][9 + j] = -0.5 * (R0 + R1) * h;
  F[6 + i][12 + j] = 0.5 * A1 * h * h;
  // V: columns acc_n(i), gyr_n(i), acc_n(j), gyr_n(j), acc_w, gyr_w.
  V[0 + i][0 + j] = 0.25 * R0 * h * h;
  V[0 + i][3 + j] = -0.125 * A1 * h * h * h;
  V[0 + i][6 + j] = 0.25 * R1 * h * h;
  V[0 + i][9 + j] = -0.125 * A1 * h * h * h;
  V[3 + i][3 + j] = 0.5 * eye * h;
  V[3 + i][9 + j] = 0.5 * eye * h;
  V[6 + i][0 + j] = 0.5 * R0 * h;
  V[6 + i][3 + j] = -0.25 * A1 * h * h;
  V[6 + i][6 + j] = 0.5 * R1 * h;
  V[6 + i][9 + j] = -0.25 * A1 * h * h;
  V[9 + i][12 + j] = eye * h;
  V[12 + i][15 + j] = eye * h;
}

// The columns l where row i of F may be nonzero, in index order; the others
// hold exact zeros (the zero blocks and the off-diagonal entries of I dt),
// whose products add nothing to a sum of finite terms, so visiting only
// these gives the dense product's sum, term for term.
template <typename Visit>
__device__ __forceinline__ void f_row(int i, Visit visit) {
  const int rb = i / 3, r = i % 3;
  if (rb == 0 || rb == 2) {                  // dp, dv: I or 0, dtheta, I dt or I, dba, dbg
    if (rb == 0) visit(r);
#pragma unroll
    for (int l = 3; l < 6; ++l) visit(l);
    visit(6 + r);
#pragma unroll
    for (int l = 9; l < 15; ++l) visit(l);
  } else if (rb == 1) {                      // dtheta: rot, -I dt
#pragma unroll
    for (int l = 3; l < 6; ++l) visit(l);
    visit(12 + r);
  } else {                                   // dba, dbg: I
    visit(3 * rb + r);
  }
}

// The same for V: the noise columns where row i of V may be nonzero.
template <typename Visit>
__device__ __forceinline__ void v_row(int i, Visit visit) {
  const int rb = i / 3, r = i % 3;
  if (rb == 0 || rb == 2) {
#pragma unroll
    for (int l = 0; l < 12; ++l) visit(l);
  } else if (rb == 1) {
    visit(3 + r);
    visit(9 + r);
  } else {
    visit(3 * rb + 3 + r);                   // dba: acc_w, dbg: gyr_w
  }
}

// The first warp's part: the walk's state and its cursor over the samples.
struct Walk {
  double q[4], p[3], v[3], a_prev[3], g_prev[3], ba[3], bg[3];
  double sum_dt;
  int64_t cursor, tile;          // the next sample; the first sample staged

  // Stage samples [t0, t0 + kTile) of the edge (the warp together).
  __device__ __forceinline__ void stage(Shared& sh, const double* acc, const double* gyr,
                                        const double* dt, const uint8_t* valid, int64_t base,
                                        int64_t n_samples, int64_t t0, int lane) {
    const int n_tile = static_cast<int>(n_samples - t0 < kTile ? n_samples - t0 : kTile);
    __syncwarp();
    for (int k = lane; k < 3 * n_tile; k += 32) {
      (&sh.acc[0][0])[k] = acc[(base + t0) * 3 + k];
      (&sh.gyr[0][0])[k] = gyr[(base + t0) * 3 + k];
    }
    for (int k = lane; k < n_tile; k += 32) {
      sh.dt[k] = dt[base + t0 + k];
      sh.ok[k] = valid[base + t0 + k];
    }
    tile = t0;
    __syncwarp();
  }

  // Take the next valid sample: one midpoint step of the state, and its
  // entries of F and V by lanes 0-8. The caller knows that one is left.
  __device__ __forceinline__ void step(Shared& sh, double (*F)[kS], double (*V)[kN],
                                       const double* acc, const double* gyr, const double* dt,
                                       const uint8_t* valid, int64_t base, int64_t n_samples,
                                       int lane) {
    for (;; ++cursor) {
      if (cursor - tile == kTile) stage(sh, acc, gyr, dt, valid, base, n_samples, cursor, lane);
      if (sh.ok[cursor - tile]) break;
    }
    const int n = static_cast<int>(cursor - tile);
    ++cursor;
    const double h = sh.dt[n];
    double a1[3], g1[3], w[3], e0[3], e1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a1[k] = sh.acc[n][k];
      g1[k] = sh.gyr[n][k];
      w[k] = 0.5 * (g_prev[k] + g1[k]) - bg[k];        // un_gyr
      e0[k] = a_prev[k] - ba[k];
      e1[k] = a1[k] - ba[k];
    }
    // q_new = normalize(q (x) delta_q(un_gyr h)), delta_q(th) = normalize([1, th / 2]).
    double dq[4] = {1.0, 0.5 * (w[0] * h), 0.5 * (w[1] * h), 0.5 * (w[2] * h)};
    normalize(dq);
    double qn[4], rot_a0[3], rot_a1[3];
    qmul(q, dq, qn);
    normalize(qn);
    if (lane < 9) step_entries(F, V, lane / 3, lane % 3, q, qn, e0, e1, w, h);
    rotate(q, e0, rot_a0);
    rotate(qn, e1, rot_a1);
    // p + v h + (0.5 un_acc) h h, v + un_acc h.
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double un_acc = 0.5 * (rot_a0[k] + rot_a1[k]);
      p[k] = p[k] + v[k] * h + 0.5 * un_acc * h * h;
      v[k] = v[k] + un_acc * h;
      a_prev[k] = a1[k];
      g_prev[k] = g1[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = qn[k];
    sum_dt = sum_dt + h;
  }
};

// The propagation of one step by matrix thread mt: jac' = F jac, FC = F cov
// and VN = V N, a barrier of the matrix threads, then cov = FC F^T + VN V^T.
__device__ __forceinline__ void propagate(Shared& sh, double (*F)[kS], double (*V)[kN], int cur,
                                          int mt) {
  if (mt < kS * kS) {
    const int i = mt / kS, j = mt % kS;
    double s = 0.0, u = 0.0;
    f_row(i, [&](int l) {
      s = s + F[i][l] * sh.jac[cur][l][j];
      u = u + F[i][l] * sh.cov[l][j];
    });
    sh.jac[cur ^ 1][i][j] = s;
    sh.FC[i][j] = u;
  }
  for (int k = mt; k < kS * kN; k += kMatrixThreads) {
    const int i = k / kN, j = k % kN;
    double s = 0.0;
    v_row(i, [&](int l) { s = s + V[i][l] * sh.noise[l][j]; });
    sh.VN[i][j] = s;
  }
  asm volatile("bar.sync 1, %0;" ::"r"(kMatrixThreads) : "memory");
  if (mt < kS * kS) {
    const int i = mt / kS, j = mt % kS;
    double s = 0.0, u = 0.0;
    f_row(j, [&](int l) { s = s + sh.FC[i][l] * F[j][l]; });
    v_row(j, [&](int l) { u = u + sh.VN[i][l] * V[j][l]; });
    sh.cov[i][j] = s + u;
  }
}

// Two blocks an SM (at most 112 registers a thread, a few spilled): at the
// batch's 3,492 edges that takes the launch from 1.74 to 1.10 ms on an H100,
// for 5 us more at the window's 4 (0.069 -> 0.075 ms).
__global__ void __launch_bounds__(kThreads, 2)
imu_preint_kernel(const double* __restrict__ acc, const double* __restrict__ gyr,
                  const double* __restrict__ dt, const uint8_t* __restrict__ valid,
                  const double* __restrict__ ba, const double* __restrict__ bg,
                  const double* __restrict__ acc0, const double* __restrict__ gyr0,
                  const double* __restrict__ noise, int64_t n_samples,
                  double* __restrict__ out_p, double* __restrict__ out_q,
                  double* __restrict__ out_v, double* __restrict__ out_jac,
                  double* __restrict__ out_cov, double* __restrict__ out_sum_dt) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid % 32;
  const int64_t edge = blockIdx.x, base = edge * n_samples;

  for (int k = tid; k < kN * kN; k += kThreads) (&sh.noise[0][0])[k] = noise[k];
  for (int k = tid; k < kS * kS; k += kThreads) {
    const int i = k / kS, j = k % kS;
    const double eye = i == j ? 1.0 : 0.0;
    sh.jac[0][i][j] = eye;
    sh.cov[i][j] = 1e-3 * eye;                       // Preintegration.h:56
    // The constant blocks of F: I at (dp, dp), (dv, dv), (dba, dba), (dbg, dbg).
    sh.F[0][i][j] = sh.F[1][i][j] = (i == j && (i < 3 || i >= 6)) ? 1.0 : 0.0;
  }
  for (int k = tid; k < 2 * kS * kN; k += kThreads) (&sh.V[0][0][0])[k] = 0.0;

  Walk walk;
  if (tid < 32) {
    int steps = 0;
    for (int64_t k0 = 0; k0 < n_samples; k0 += 32) {
      const bool ok = k0 + lane < n_samples && valid[base + k0 + lane];
      steps += __popc(__ballot_sync(0xffffffffu, ok));
    }
    if (lane == 0) sh.steps = steps;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      walk.p[k] = walk.v[k] = 0.0;
      walk.ba[k] = ba[edge * 3 + k];
      walk.bg[k] = bg[edge * 3 + k];
      walk.a_prev[k] = acc0[edge * 3 + k];
      walk.g_prev[k] = gyr0[edge * 3 + k];
    }
    walk.q[0] = 1.0;
    walk.q[1] = walk.q[2] = walk.q[3] = 0.0;
    walk.sum_dt = 0.0;
    walk.cursor = walk.tile = 0;
    if (n_samples > 0) walk.stage(sh, acc, gyr, dt, valid, base, n_samples, 0, lane);
  }
  __syncthreads();   // the set-up, the count and the first tile
  const int steps = sh.steps;
  if (tid < 32 && steps > 0)
    walk.step(sh, sh.F[0], sh.V[0], acc, gyr, dt, valid, base, n_samples, lane);
  __syncthreads();

  int cur = 0;       // the Jacobian's buffer
  for (int k = 0; k < steps; ++k) {
    const int buf = k & 1;
    if (tid < 32) {
      if (k + 1 < steps)
        walk.step(sh, sh.F[buf ^ 1], sh.V[buf ^ 1], acc, gyr, dt, valid, base, n_samples, lane);
    } else {
      propagate(sh, sh.F[buf], sh.V[buf], cur, tid - 32);
    }
    __syncthreads();
    cur ^= 1;
  }

  for (int k = tid; k < kS * kS; k += kThreads) {
    out_jac[edge * kS * kS + k] = (&sh.jac[cur][0][0])[k];
    out_cov[edge * kS * kS + k] = (&sh.cov[0][0])[k];
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      out_p[edge * 3 + k] = walk.p[k];
      out_v[edge * 3 + k] = walk.v[k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) out_q[edge * 4 + k] = walk.q[k];
    out_sum_dt[edge] = walk.sum_dt;
  }
}

}  // namespace

// acc, gyr (B, N, 3) f64, dt (B, N) f64, valid (B, N) bool, ba, bg, acc0,
// gyr0 (B, 3) f64 and noise (18, 18) f64, all contiguous on one device;
// out_p (B, 3), out_q (B, 4) wxyz, out_v (B, 3), out_jac and out_cov
// (B, 15, 15), out_sum_dt (B,), f64. Launches B blocks of 288 threads on
// `stream` and returns the cudaError_t of the launch (0 on success; B = 0
// launches nothing). Every argument is 64 bits wide, which ctypes converts
// fastest.
extern "C" int glio_imu_preint_f64(const void* acc, const void* gyr, const void* dt,
                                   const void* valid, const void* ba, const void* bg,
                                   const void* acc0, const void* gyr0, const void* noise,
                                   size_t n_edges, size_t n_samples, void* out_p, void* out_q,
                                   void* out_v, void* out_jac, void* out_cov, void* out_sum_dt,
                                   void* stream) {
  if (n_edges > INT32_MAX || n_samples > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n_edges == 0) return 0;
  imu_preint_kernel<<<static_cast<unsigned>(n_edges), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(acc), static_cast<const double*>(gyr),
      static_cast<const double*>(dt), static_cast<const uint8_t*>(valid),
      static_cast<const double*>(ba), static_cast<const double*>(bg),
      static_cast<const double*>(acc0), static_cast<const double*>(gyr0),
      static_cast<const double*>(noise), static_cast<int64_t>(n_samples),
      static_cast<double*>(out_p), static_cast<double*>(out_q), static_cast<double*>(out_v),
      static_cast<double*>(out_jac), static_cast<double*>(out_cov),
      static_cast<double*>(out_sum_dt));
  return static_cast<int>(cudaGetLastError());
}
