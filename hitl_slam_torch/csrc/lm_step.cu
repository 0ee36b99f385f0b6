// One trip of the Levenberg-Marquardt loop outside its linear solve, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the LM's assembly and
// its accept tail (hitl_slam_tpu/solver/assembly_soa.py::
// normal_equations_soa and the body of hitl_slam_tpu/solver/lm.py's
// lax.while_loop) to XLA, which fuses them. In the port the same work was
// ~280 PyTorch kernels a trip inside the LM's CUDA-graph WHILE node, each a
// graph node of ~1.2 us; the bytes are tiny (a trip at 1024 poses reads the
// poses, the step and ~20 constant vectors, and writes D, U and g: ~0.3 MB,
// ~0.1 us at 3.35 TB/s). What bounds it on this card is launch latency and
// the block barriers of its one reduction, not bytes or flops. So a trip is
// one launch (hitl_slam_torch/solver/lm_step.py says what it computes):
//   - one thread a pose. A thread forms its pose's trial point x + step and
//     both of its chain factors (i-1, i) and (i, i+1) from device memory,
//     recomputing the factor its left neighbour forms too, so no barrier
//     separates the assembly's steps; it holds its pose's D, U and g in
//     registers;
//   - six sums (the odometry and human cost terms, the model decrease,
//     |x + step|^2, |x|^2, |step|^2) reduce in a fixed order: a butterfly
//     over each warp, then every warp over the warps' sums, so every thread
//     holds the same bits (no atomics: a replay repeats bit for bit). Each
//     thread then decides accept, the damping and the exits itself, writes
//     its pose's selected x, D, U, g and the next trip's damped D and -g,
//     and thread 0 the scalars;
//   - a thread's chain of loads, transcendentals and the reduction is what
//     a launch waits on, once its warps no longer queue for one SM's
//     schedulers: on the H100 a trip at 1024 poses took 13.1 us as one
//     block of 1024 threads, 6.9 us as 4 blocks of 256 and 5.8 us as 8 of
//     128 or 16 of 64. So up to 128 poses run as one block, and up to 16384
//     as a thread-block cluster of as many blocks of about 128 poses as the
//     16 a cluster may hold (a non-portable size) allow; its blocks exchange
//     their sums through distributed shared memory and sum them in rank
//     order;
//   - more: two launches, many blocks writing the trial point's D, U, g and
//     their sums to scratch, then up to 128 blocks that each sum those in
//     block order, decide and write their share of the poses.
// The first assembly of a solve is the same launch with no step: it writes
// the carry at poses0 and the first damped system, and decides nothing.
// Each element is formed by the operations of the plain version in their
// order, built without contracting a*b+c into an FMA (--fmad=false), so
// that D, U and g at the trial point round as PyTorch's separate kernels
// do; only the sums are taken in another order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
// poses a block holds, one a thread; a cluster holds up to kMaxCluster
// blocks; past that the two-launch route takes any number up to kMaxPoses,
// its second launch kAcceptBlocks blocks at most
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 16;
constexpr int kAcceptBlocks = 128;
constexpr int kMaxPoses = 1 << 25;
// the sums a trip reduces
constexpr int kSums = 6;
enum { kOdom, kHuman, kPred, kNew2, kOld2, kStep2 };
// the launch's routes
enum { kBlock, kCluster, kPartials };

struct Args {
  // the problem's constants: axis [F, 2, 2], radial and rotation [F],
  // inv_sigma [F, 3] (rows inv_stride floats apart: 0 when one row serves
  // every factor), the compact human terms A [P, 3, 3], c and q0 [P, 3], k
  const float *axis, *radial, *rotation, *inv_sigma, *A, *hc, *q0, *k;
  // the trip's input: x_in (the carry's x, or poses0 for the first
  // assembly), the step (null: the first assembly), mu0 (null: initial_mu)
  const float *x_in, *step, *mu0;
  // the carry: x [P, 3], D [P, 3, 3], U [P-1, 3, 3], g [P, 3], the next
  // trip's Dd [P, 3, 3] and b [P, 3]; scalars c, c0, mu, nu, it, done, go;
  // accepted [max_it]
  float *x, *D, *U, *g, *Dd, *b, *c, *c0, *mu, *nu;
  int* it;
  bool *done, *go, *accepted;
  // the two-launch route's scratch: the trial x [P, 3], D [P, 6], U [P-1, 9],
  // g [P, 3], each block's sums [blocks, kSums] and then the carry's
  // scalars c, mu, nu, it, done as the first launch read them [5]
  float *tx, *tD, *tU, *tg, *partials;
  int P, max_it, inv_stride;
  float initial_mu, ftol, ptol, mu_collapse, min_diag, max_diag, third;
};

// PyTorch's clamp and maximum: a NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) || isnan(b) ? a + b : fmaxf(a, b);
}

// Pose j of the trial point: x_in + step, or x_in for the first assembly.
__device__ __forceinline__ void trial_pose(const Args& a, int j, float* p) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    p[c] = a.step ? a.x_in[3 * j + c] + a.step[3 * j + c] : a.x_in[3 * j + c];
}

// What chain factor f (poses f, f+1) gives its two poses.
struct Factor {
  float S00, S01, S11, t0, t1, e22, gv0, gv1, g2a, g2b, i2sq, rr;
};

__device__ Factor chain_factor(const Args& a, int f, const float* p0,
                               const float* p1) {
  const float ax = a.axis[4 * f], ay = a.axis[4 * f + 1];
  const float d = a.radial[f], w = a.rotation[f];
  const float* inv = a.inv_sigma + f * a.inv_stride;
  const float i0 = inv[0], i1 = inv[1], i2 = inv[2];
  const float cth = cosf(p0[2]), sth = sinf(p0[2]);
  const float dtx = p1[0] - p0[0], dty = p1[1] - p0[1];
  const float vx = cth * dtx + sth * dty;
  const float vy = -sth * dtx + cth * dty;
  const float u0 = ax * vx + ay * vy;
  const float u1 = -ay * vx + ax * vy;
  const float r0 = (u0 - d) * i0;
  const float r1 = u1 * i1;
  const float dth = p1[2] - p0[2] - w;
  const float r2 = atan2f(sinf(dth), cosf(dth)) * i2;
  const float p = ax * cth - ay * sth;
  const float q = ax * sth + ay * cth;
  const float du0 = i0 * (ax * vy - ay * vx);
  const float du1 = -i1 * (ay * vy + ax * vx);
  const float i0sq = i0 * i0, i1sq = i1 * i1, i2sq = i2 * i2;
  Factor o;
  o.S00 = i0sq * p * p + i1sq * q * q;
  o.S01 = (i0sq - i1sq) * p * q;
  o.S11 = i0sq * q * q + i1sq * p * p;
  o.t0 = i0 * p * du0 - i1 * q * du1;
  o.t1 = i0 * q * du0 + i1 * p * du1;
  o.e22 = du0 * du0 + du1 * du1 + i2sq;
  o.gv0 = i0 * p * r0 - i1 * q * r1;
  o.gv1 = i0 * q * r0 + i1 * p * r1;
  o.g2a = du0 * r0 + du1 * r1 - i2 * r2;
  o.g2b = i2 * r2;
  o.i2sq = i2sq;
  o.rr = r0 * r0 + r1 * r1 + r2 * r2;
  return o;
}

// Pose i's rows of the normal equations at the trial point, gauge-fixed at
// pose 0, and its shares of the six sums.
struct Trial {
  float x[3];
  float D[6];   // D00 D01 D02 D11 D12 D22
  float U[9];   // coupling (i, i+1), for i < P-1
  float g[3];
  float sum[kSums];
};

__device__ void assemble_pose(const Args& a, int i, Trial& t) {
  const int F = a.P - 1;
  const float z = 0.0f;
  float nb[3];
  trial_pose(a, i, t.x);
  Factor l{}, r{};
  if (i > 0) {
    trial_pose(a, i - 1, nb);
    l = chain_factor(a, i - 1, nb, t.x);
  }
  if (i < F) {
    trial_pose(a, i + 1, nb);
    r = chain_factor(a, i, t.x, nb);
  }
  // the compact human terms, e = q0 - x
  const float* A = a.A + 9 * i;
  const float A00 = A[0], A01 = A[1], A02 = A[2], A11 = A[4], A12 = A[5],
              A22 = A[8];
  const float c0 = a.hc[3 * i], c1 = a.hc[3 * i + 1], c2 = a.hc[3 * i + 2];
  const float e0 = a.q0[3 * i] - t.x[0], e1 = a.q0[3 * i + 1] - t.x[1],
              e2 = a.q0[3 * i + 2] - t.x[2];
  const float Ae0 = A00 * e0 + A01 * e1 + A02 * e2;
  const float Ae1 = A01 * e0 + A11 * e1 + A12 * e2;
  const float Ae2 = A02 * e0 + A12 * e1 + A22 * e2;
  const bool left = i > 0, right = i < F;
  float D00 = A00 + (right ? r.S00 : z) + (left ? l.S00 : z);
  float D01 = A01 + (right ? r.S01 : z) + (left ? l.S01 : z);
  float D02 = A02 + (right ? -r.t0 : z);
  float D11 = A11 + (right ? r.S11 : z) + (left ? l.S11 : z);
  float D12 = A12 + (right ? -r.t1 : z);
  float D22 = A22 + (right ? r.e22 : z) + (left ? l.i2sq : z);
  float g0 = -(c0 + Ae0) + (right ? -r.gv0 : z) + (left ? l.gv0 : z);
  float g1 = -(c1 + Ae1) + (right ? -r.gv1 : z) + (left ? l.gv1 : z);
  float g2 = -(c2 + Ae2) + (right ? r.g2a : z) + (left ? l.g2b : z);
  // gauge fix pose 0
  const float gate = i == 0 ? 0.0f : 1.0f;
  t.D[0] = D00 * gate + (1.0f - gate);
  t.D[1] = D01 * gate;
  t.D[2] = D02 * gate;
  t.D[3] = D11 * gate + (1.0f - gate);
  t.D[4] = D12 * gate;
  t.D[5] = D22 * gate + (1.0f - gate);
  t.g[0] = g0 * gate;
  t.g[1] = g1 * gate;
  t.g[2] = g2 * gate;
  if (right) {
    const float uz = i == 0 ? 0.0f : 1.0f;
    t.U[0] = -r.S00 * uz;
    t.U[1] = -r.S01 * uz;
    t.U[2] = z * uz;
    t.U[3] = -r.S01 * uz;
    t.U[4] = -r.S11 * uz;
    t.U[5] = z * uz;
    t.U[6] = r.t0 * uz;
    t.U[7] = r.t1 * uz;
    t.U[8] = -r.i2sq * uz;
  }
  t.sum[kOdom] = right ? r.rr : z;
  t.sum[kHuman] = e0 * (2.0f * c0 + Ae0) + e1 * (2.0f * c1 + Ae1) +
                  e2 * (2.0f * c2 + Ae2);
  t.sum[kNew2] = t.x[0] * t.x[0] + t.x[1] * t.x[1] + t.x[2] * t.x[2];
  t.sum[kPred] = t.sum[kOld2] = t.sum[kStep2] = z;
  if (a.step) {
    // the model decrease L(0) - L(step) in the MNT form, with the damping
    // and g of the carry
    const float mu = *a.mu;
    float pred[3], x2[3], s2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float diag = clamp_nan(a.D[9 * i + 4 * c], a.min_diag, a.max_diag);
      const float s = a.step[3 * i + c], x = a.x_in[3 * i + c];
      pred[c] = s * (mu * diag * s - a.g[3 * i + c]);
      x2[c] = x * x;
      s2[c] = s * s;
    }
    t.sum[kPred] = pred[0] + pred[1] + pred[2];
    t.sum[kOld2] = x2[0] + x2[1] + x2[2];
    t.sum[kStep2] = s2[0] + s2[1] + s2[2];
  }
}

// A butterfly over the warp: every lane ends with the same bits (each
// step adds the same two values on both lanes of a pair).
__device__ __forceinline__ void warp_sum(float (&v)[kSums]) {
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1)
#pragma unroll
    for (int n = 0; n < kSums; ++n)
      v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
}

// The block's sums in every thread: each warp's, then every warp over the
// warps' sums in one order. One barrier; called once a launch.
__device__ void block_sum(float (&v)[kSums], float (*part)[kSums]) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  warp_sum(v);
  if (lane == 0)
#pragma unroll
    for (int n = 0; n < kSums; ++n) part[warp][n] = v[n];
  __syncthreads();
  const int warps = blockDim.x / kWarp;
#pragma unroll
  for (int n = 0; n < kSums; ++n) v[n] = lane < warps ? part[lane][n] : 0.0f;
  warp_sum(v);
}

// The carry's scalars at the start of the launch, read by every thread
// before any barrier (thread 0 writes them after the last).
struct Scalars {
  float c, mu, nu;
  int it;
  bool done;
  float k;   // the human terms' cost offset
};

__device__ Scalars load_scalars(const Args& a) {
  Scalars s{0.0f, 0.0f, 0.0f, 0, false, *a.k};
  if (a.step) s = Scalars{*a.c, *a.mu, *a.nu, *a.it, *a.done, *a.k};
  return s;
}

// The two-launch route: the scalars as the first launch read them, kept
// in scratch for the second, whose first block rewrites the carry's while
// other blocks may not have started.
__device__ void hold_scalars(const Args& a, int blocks, const Scalars& s) {
  float* h = a.partials + blocks * kSums;
  h[0] = s.c;
  h[1] = s.mu;
  h[2] = s.nu;
  h[3] = __int_as_float(s.it);
  h[4] = s.done ? 1.0f : 0.0f;
}

__device__ Scalars held_scalars(const Args& a, int blocks) {
  const float* h = a.partials + blocks * kSums;
  return Scalars{h[0], h[1], h[2], __float_as_int(h[3]), h[4] != 0.0f, *a.k};
}

struct Decision {
  bool accept, done, go;
  float c, c_new, mu, nu;
  int it;
};

// Accept, the damping update and the exit tests from the sums, as the plain
// version's tail; the first assembly accepts its point and starts the
// damping at mu0 (clamped) or initial_mu.
__device__ Decision decide(const Args& a, const float (&v)[kSums],
                           const Scalars& s) {
  Decision d;
  d.c_new = 0.5f * v[kOdom] + 0.5f * (s.k + v[kHuman]);
  if (!a.step) {
    d.accept = true;
    d.c = d.c_new;
    d.mu = a.mu0 ? clamp_nan(*a.mu0, static_cast<float>(1e-6),
                             static_cast<float>(1e-1))
                 : a.initial_mu;
    d.nu = 2.0f;
    d.it = 0;
    d.done = false;
    d.go = 0 < a.max_it;
    return d;
  }
  const float pred = 0.5f * v[kPred];
  const float rho = (s.c - d.c_new) /
                    clamp_nan(pred, static_cast<float>(1e-30), INFINITY);
  d.accept = rho > 0.0f && isfinite(d.c_new);
  const float t = 2.0f * rho - 1.0f;
  const float factor = max_nan(a.third, 1.0f - t * (t * t));
  d.mu = clamp_nan(d.accept ? s.mu * factor : s.mu * s.nu,
                   static_cast<float>(1e-32), static_cast<float>(1e32));
  d.nu = d.accept ? 2.0f : s.nu * 2.0f;
  d.c = d.accept ? d.c_new : s.c;
  // relative function decrease (accepted steps only), relative step size
  // (every step), or trust-region collapse
  const bool fdone = d.accept && fabsf(s.c - d.c_new) <= a.ftol * s.c;
  const float xnorm = sqrtf(d.accept ? v[kNew2] : v[kOld2]);
  const bool sdone = sqrtf(v[kStep2]) <= a.ptol * (xnorm + a.ptol);
  const bool mdone = d.mu >= a.mu_collapse;
  d.it = s.it + 1;
  d.done = s.done || fdone || sdone || mdone;
  d.go = !d.done && d.it < a.max_it;
  return d;
}

// Pose i of the carry after the decision, and the next trip's system:
// D damped by mu, and -g.
__device__ void commit(const Args& a, int i, const Decision& d,
                       const Trial& t) {
  float D[6], g[3];
  if (d.accept) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.x[3 * i + c] = t.x[c];
      a.g[3 * i + c] = g[c] = t.g[c];
    }
#pragma unroll
    for (int e = 0; e < 6; ++e) D[e] = t.D[e];
    float* o = a.D + 9 * i;
    o[0] = D[0]; o[1] = D[1]; o[2] = D[2];
    o[3] = D[1]; o[4] = D[3]; o[5] = D[4];
    o[6] = D[2]; o[7] = D[4]; o[8] = D[5];
    if (i < a.P - 1)
#pragma unroll
      for (int e = 0; e < 9; ++e) a.U[9 * i + e] = t.U[e];
  } else {
    const float* o = a.D + 9 * i;
    D[0] = o[0]; D[1] = o[1]; D[2] = o[2];
    D[3] = o[4]; D[4] = o[5]; D[5] = o[8];
#pragma unroll
    for (int c = 0; c < 3; ++c) g[c] = a.g[3 * i + c];
  }
  const float off = d.mu * 0.0f;
  const float dd0 = D[0] + d.mu * clamp_nan(D[0], a.min_diag, a.max_diag);
  const float dd1 = D[3] + d.mu * clamp_nan(D[3], a.min_diag, a.max_diag);
  const float dd2 = D[5] + d.mu * clamp_nan(D[5], a.min_diag, a.max_diag);
  float* o = a.Dd + 9 * i;
  o[0] = dd0;        o[1] = D[1] + off; o[2] = D[2] + off;
  o[3] = D[1] + off; o[4] = dd1;        o[5] = D[4] + off;
  o[6] = D[2] + off; o[7] = D[4] + off; o[8] = dd2;
#pragma unroll
  for (int c = 0; c < 3; ++c) a.b[3 * i + c] = -g[c];
}

// The scalars, by one thread; the first assembly also clears the flags.
__device__ void commit_scalars(const Args& a, const Decision& d,
                               const Scalars& s) {
  *a.c = d.c;
  *a.mu = d.mu;
  *a.nu = d.nu;
  *a.it = d.it;
  *a.done = d.done;
  *a.go = d.go;
  if (a.step) {
    if (s.it < a.max_it) a.accepted[s.it] = d.accept;
  } else {
    *a.c0 = d.c;
  }
}

__device__ void clear_flags(const Args& a, int first, int stride) {
  if (!a.step)
    for (int j = first; j < a.max_it; j += stride) a.accepted[j] = false;
}

// One block, a cluster, or the first of the two launches (kPartials).
template <int kRoute>
__global__ void __launch_bounds__(kMaxThreads, 1) lm_step_kernel(const Args a) {
  __shared__ float part[kMaxThreads / kWarp][kSums];
  __shared__ float block_total[kSums];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = i < a.P;
  const Scalars s = load_scalars(a);
  Trial t;
  if (mine) {
    assemble_pose(a, i, t);
  } else {
#pragma unroll
    for (int n = 0; n < kSums; ++n) t.sum[n] = 0.0f;
  }
  if constexpr (kRoute == kPartials) {
    if (mine) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a.tx[3 * i + c] = t.x[c];
        a.tg[3 * i + c] = t.g[c];
      }
#pragma unroll
      for (int e = 0; e < 6; ++e) a.tD[6 * i + e] = t.D[e];
      if (i < a.P - 1)
#pragma unroll
        for (int e = 0; e < 9; ++e) a.tU[9 * i + e] = t.U[e];
    }
  }
  block_sum(t.sum, part);
  if constexpr (kRoute == kPartials) {
    if (threadIdx.x == 0)
#pragma unroll
      for (int n = 0; n < kSums; ++n)
        a.partials[blockIdx.x * kSums + n] = t.sum[n];
    if (i == 0) hold_scalars(a, gridDim.x, s);
    return;
  } else {
    if constexpr (kRoute == kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      if (threadIdx.x == 0)
#pragma unroll
        for (int n = 0; n < kSums; ++n) block_total[n] = t.sum[n];
      cluster.sync();
      const int lane = threadIdx.x % kWarp;
      const unsigned rank = static_cast<unsigned>(lane);
      const bool held = lane < static_cast<int>(cluster.num_blocks());
#pragma unroll
      for (int n = 0; n < kSums; ++n)
        t.sum[n] = held ? *cluster.map_shared_rank(&block_total[n], rank)
                        : 0.0f;
      // this block's reads of the others' sums are done; it waits for the
      // others' at its end, so that no block leaves while another may read
      asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
      warp_sum(t.sum);
    }
    const Decision d = decide(a, t.sum, s);
    if (mine) commit(a, i, d, t);
    if (i == 0) commit_scalars(a, d, s);
    clear_flags(a, i, gridDim.x * blockDim.x);
    if constexpr (kRoute == kCluster)
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
}

// The second of the two launches: in each block the first launch's
// `blocks` sums in block order (every block the same bits), the decision,
// and the block's share of the poses.
__global__ void __launch_bounds__(kMaxThreads, 1)
    lm_accept_kernel(const Args a, int blocks) {
  __shared__ float part[kMaxThreads / kWarp][kSums];
  const Scalars s = held_scalars(a, blocks);
  float v[kSums];
#pragma unroll
  for (int n = 0; n < kSums; ++n) v[n] = 0.0f;
  for (int k = threadIdx.x; k < blocks; k += blockDim.x)
#pragma unroll
    for (int n = 0; n < kSums; ++n) v[n] += a.partials[k * kSums + n];
  block_sum(v, part);
  const Decision d = decide(a, v, s);
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int i = first; i < a.P; i += stride) {
    Trial t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t.x[c] = a.tx[3 * i + c];
      t.g[c] = a.tg[3 * i + c];
    }
#pragma unroll
    for (int e = 0; e < 6; ++e) t.D[e] = a.tD[6 * i + e];
    if (i < a.P - 1)
#pragma unroll
      for (int e = 0; e < 9; ++e) t.U[e] = a.tU[9 * i + e];
    commit(a, i, d, t);
  }
  if (first == 0) commit_scalars(a, d, s);
  clear_flags(a, first, stride);
}

cudaError_t launch(const Args& a, int blocks, int threads,
                   cudaStream_t stream) {
  if (blocks == 1) {
    lm_step_kernel<kBlock><<<1, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  if (blocks <= kMaxCluster) {
    auto kernel = lm_step_kernel<kCluster>;
    // set at the first launch of each device
    static int configured = -1;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (configured != device) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      configured = device;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  lm_step_kernel<kPartials><<<blocks, threads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  lm_accept_kernel<<<blocks < kAcceptBlocks ? blocks : kAcceptBlocks,
                     kMaxThreads, 0, stream>>>(a, blocks);
  return cudaGetLastError();
}

}  // namespace

// One LM trip (a step given) or a solve's first assembly (step null), with
// the launch plan the wrapper computed (solver/lm_step.py::launch_plan):
// `blocks` blocks of `threads` threads, one a pose. The pointers, in
// order: axis, radial, rotation, inv_sigma, A, c, q0, k (the problem);
// x_in, step, mu0 (the input; step and mu0 may be null); x, D, U, g, Dd,
// b, c, c0, mu, nu, it, done, go, accepted (the carry); tx, tD, tU, tg,
// partials (the two-launch route's scratch, null on the others; partials
// holds blocks * 6 + 5 floats). f:
// initial_mu, function_tolerance, parameter_tolerance, mu_collapse,
// min_diagonal, max_diagonal, 1/3. n: P, max_iterations, inv_sigma's row
// stride (0 or 3), blocks, threads. Returns a CUDA error code; a plan
// outside the routes or a missing buffer is refused with
// cudaErrorInvalidValue.
extern "C" int hitl_lm_step(void* const* p, const float* f, const int* n,
                            void* stream) {
  const int P = n[0], max_it = n[1], inv_stride = n[2], blocks = n[3],
            threads = n[4];
  bool ok = P >= 1 && P <= kMaxPoses && max_it >= 0 &&
            (inv_stride == 0 || inv_stride == 3) && blocks >= 1 &&
            threads >= kWarp && threads <= kMaxThreads &&
            threads % kWarp == 0 &&
            static_cast<long long>(blocks) * threads >= P &&
            static_cast<long long>(blocks - 1) * threads < P;
  // every buffer but the factors' and U (empty at P = 1), step, mu0, the
  // flags (none at max_it = 0) and the scratch
  static const int kRequired[] = {4,  5,  6,  7,  8,  11, 12, 14, 15,
                                  16, 17, 18, 19, 20, 21, 22, 23};
  static const int kFactors[] = {0, 1, 2, 3, 13};
  for (int k : kRequired) ok = ok && p[k] != nullptr;
  if (P > 1)
    for (int k : kFactors) ok = ok && p[k] != nullptr;
  if (max_it > 0) ok = ok && p[24] != nullptr;
  if (blocks > kMaxCluster)
    for (int k = 25; k < 30; ++k) ok = ok && p[k] != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  auto fp = [&](int k) { return static_cast<float*>(p[k]); };
  const Args a{fp(0), fp(1), fp(2), fp(3), fp(4), fp(5), fp(6), fp(7),
               fp(8), fp(9), fp(10),
               fp(11), fp(12), fp(13), fp(14), fp(15), fp(16), fp(17),
               fp(18), fp(19), fp(20), static_cast<int*>(p[21]),
               static_cast<bool*>(p[22]), static_cast<bool*>(p[23]),
               static_cast<bool*>(p[24]),
               fp(25), fp(26), fp(27), fp(28), fp(29),
               P, max_it, inv_stride,
               f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
  return static_cast<int>(
      launch(a, blocks, threads, static_cast<cudaStream_t>(stream)));
}
