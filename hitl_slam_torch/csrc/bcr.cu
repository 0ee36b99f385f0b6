// Block cyclic reduction of the LM normal equations for Hopper (sm_90a).
//
// Replaces: hitl_slam_tpu/solver/pallas_bcr.py::_bcr_kernel (entry
// bcr_solve_pallas), the Pallas TPU kernel that solves the symmetric
// block-tridiagonal system H x = b, H[i,i] = D[i], H[i,i+1] = U[i],
// H[i+1,i] = U[i]^T (3x3 blocks), by in-place masked cyclic reduction:
// log2(m) downward levels, one adjugate inverse per eliminated lane, then
// upward back-substitution. The algebra and elimination order are those of
// hitl_slam_tpu/solver/tridiag.py::bcr_solve (the plain version, ported to
// hitl_slam_torch/solver/tridiag.py): same padding to m = next_pow2(n) with
// identity blocks and zero couplings, same adjugate inverse, same
// subtraction order.
//
// What bounds it on this card: the chain of dependent levels, not bytes or
// flops. A solve at n = 1024 reads 98 KB and does ~0.5 MFLOP, but its
// 2*log2(m) + 1 steps are serially dependent: past the first few levels a
// step is one warp running a few hundred dependent instructions, so the
// time is the number of steps times the length of one step's instruction
// chain, plus the flops of the wide top levels on the SMs that hold them.
// The design keeps every step on chip and runs a solve of up to 16384 poses
// as ONE launch:
//   - the lane state lives in shared memory, in planes of floats: D (which
//     becomes Dinv once the lane is eliminated), L, U, b (which becomes x),
//     and for an eliminated lane its products Dinv L, Dinv U, Dinv b: 51
//     floats a lane. D, U, b are read from device memory once (each thread
//     with the loads of two lanes in flight) and x is written once. Every
//     block lays its planes out for 1024 lanes, lane i at slot i + i/32, so
//     the lanes a level touches (2^k apart) fall in distinct banks and every
//     plane offset is a compile-time constant of the address;
//   - a level is two steps: the odd lanes invert their D and write their
//     products to their own slots, then, after a barrier, the even lanes
//     read them and absorb both neighbours. (Having each even lane recompute
//     its neighbours' products in registers instead saves a barrier a level
//     but inverts each odd block twice; on the H100 it was within a few
//     per cent of this either way, so only this one is kept.);
//   - m <= 1024 lanes: one block of up to 512 threads, __syncthreads()
//     between steps;
//   - m = 2048 .. 16384: a thread-block cluster of m/1024 blocks (up to 16,
//     a non-portable size), each holding 1024 lanes in its shared memory.
//     A level's only cross-block read is the left neighbour of a block's
//     first active lane (and, once the active lanes are more than a block
//     apart, every neighbour), read from the owner's shared memory through
//     distributed shared memory; cluster.sync() separates the steps whose
//     reads cross blocks. Those last log2(m/1024) levels keep one active
//     lane in each of the blocks that still have one;
//   - m > 16384 (up to 2^25, the range of int32 offsets into the state):
//     the top log2(m/16384) levels run over a lane-major copy of the state
//     in device memory, two many-block launches a level (odd lanes, then
//     even lanes) with the same device functions in the same order; the
//     cluster of 16 then solves the 16384 lanes left (every 2^top-th lane)
//     as above, and one launch a top level back-substitutes its odd lanes.
// Up to 16384 poses no device memory holds intermediate state.
//
// Batched route (hitl_bcr_solve_batched): B systems of the same n, stacked
// in D, U, b, x (and the state), solved by the same launches with gridDim.y
// = B. Block (i, r) offsets every pointer by system r's strides (9n, 9(n-1),
// 3n, 3n, and m * kPlanes in the state) and then runs the arithmetic of
// block i of a lone solve, so each system's x is bit-equal to a lone launch
// on it. A cluster spans gridDim.x only: it never holds two systems. The
// lone entry hitl_bcr_solve is the batched one at B = 1.
//
// Multi-right-hand-side route (hitl_bcr_solve_multi): S systems of the same
// n, each against R <= 8 right-hand sides, D [S, n, 3, 3], U [S, n-1, 3, 3],
// b [S, n, 3, R] -> x [S, n, 3, R]. It replaces the same Pallas kernel's
// function under the reference's vmap over the SPIKE's 7 right-hand sides
// (hitl_slam_tpu/parallel/sharded_solver.py:198, where D and U stay
// unbatched and are factored once). What bounds it is the lone route's
// chain of dependent levels at the deep levels, and at the wide ones the
// instructions of R columns a lane on the SMs that hold a system. The
// design factors each system once, in one block or cluster, and carries
// its columns beside the factorization:
//   - a lane holds 27 floats of matrices, D (Dinv once eliminated), L and
//     U, in planes as in the lone route, and 3R floats of columns, b (then
//     x), lane-major in the order of device memory: 48 at R = 7, so a
//     block holds 1024 lanes at every R <= 8 and the routes are the lone
//     route's. Filling and draining the columns are straight copies of a
//     warp's 32 lanes, every load in flight at once. Dinv L, Dinv U and
//     Dinv b of an eliminated lane are not stored: its two even neighbours
//     form them from its Dinv, L, U and b (the same products as the lone
//     route's), a 3x3 product more on the even step's chain and one less
//     on the odd step's;
//   - a level is the lone route's two steps. The odd step inverts, one
//     thread a lane. The even step has a matrix item a lane and G column
//     items (columns g, g + G, ...), G as large as the threads allow, up
//     to R: one column an item at the deep levels, a lane's columns
//     together at the wide ones. Matrix items fill whole warps of their
//     own, so at a deep level the matrix thread and the R column threads
//     run side by side instead of R vector steps in a row. A matrix item
//     holds the new L, U in registers and stores them at the next level's
//     odd step, which reads only D: by then the lane's columns have read
//     the old ones. The back-substitution and the root are column items;
//   - a system of more than 1024 lanes spreads over a cluster of up to 16
//     blocks of at least 256 lanes (the lone route packs 1024 a block): a
//     cluster's syncs cost the same at any size, and its wide levels then
//     run on more SMs (on the H100, the SPIKE's 2048-lane systems took
//     0.0305 ms a launch as 8 blocks of 256 lanes, 0.0422 as 2 of 1024);
//   - D, U and b advance by system strides the caller gives, so the SPIKE
//     hands its partitions' D, a view of U and its [n, Pl, 3, 7] right-hand
//     sides with no copy.
// Each column's arithmetic is a lone launch's on that column: same padding,
// elimination order and adjugate inverse.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxLanesPerBlock = 1024;
constexpr int kMaxCluster = 16;
// the most lanes shared memory holds; a larger system first runs its top
// levels in device memory
constexpr int kMaxSharedLanes = kMaxLanesPerBlock * kMaxCluster;
// lanes of the largest system: lane-major offsets into the state fit int32
constexpr int kMaxLanes = 1 << 25;
constexpr int kLevelThreads = 256;
// every block lays its planes out for kMaxLanesPerBlock lanes, so plane
// offsets are compile-time constants of the shared-memory addresses
constexpr int kStride = kMaxLanesPerBlock + kMaxLanesPerBlock / 32;

enum Plane {
  kD = 0,       // D, then Dinv once eliminated
  kL = 9,
  kU = 18,
  kB = 27,      // b, then x
  kDinvL = 30,  // Dinv L, Dinv U, Dinv b of an eliminated lane
  kDinvU = 39,
  kDinvB = 48,
  kPlanes = 51
};

__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// Where lane g's floats live: float q of lane g is
// planes(g)[q * kStep + at(g)].
// In shared memory, plane-major: this block's planes, or in a cluster the
// owner block's, through distributed shared memory.
template <bool kCluster>
struct SharedLanes {
  static constexpr int kStep = kStride;
  float* own;       // this block's planes
  int log2_lanes;
  int rank;

  __device__ __forceinline__ float* planes(int g) const {
    if constexpr (kCluster) {
      const int owner = g >> log2_lanes;
      if (owner != rank) return cg::this_cluster().map_shared_rank(own, owner);
    }
    return own;
  }
  __device__ __forceinline__ int at(int g) const {
    return slot(g & ((1 << log2_lanes) - 1));
  }
};

// In device memory (the top levels of m > kMaxSharedLanes), lane-major.
struct DeviceLanes {
  static constexpr int kStep = 1;
  float* own;       // the whole state, kPlanes floats a lane

  __device__ __forceinline__ float* planes(int) const { return own; }
  __device__ __forceinline__ int at(int g) const { return g * kPlanes; }
};

template <int K, class Ln, class Off>
__device__ __forceinline__ void ld(const Ln&, const float* p, int plane,
                                   Off s, float* o) {
#pragma unroll
  for (int k = 0; k < K; ++k) o[k] = p[(plane + k) * Ln::kStep + s];
}

template <int K, class Ln, class Off>
__device__ __forceinline__ void st(const Ln&, float* p, int plane, Off s,
                                   const float* v) {
#pragma unroll
  for (int k = 0; k < K; ++k) p[(plane + k) * Ln::kStep + s] = v[k];
}

template <int K>
__device__ __forceinline__ void zero(float* o) {
#pragma unroll
  for (int k = 0; k < K; ++k) o[k] = 0.0f;
}

template <int K>
__device__ __forceinline__ void negate(float* o) {
#pragma unroll
  for (int k = 0; k < K; ++k) o[k] = -o[k];
}

// adjugate inverse, row-major [a00 a01 a02 a10 ... a22]
__device__ __forceinline__ void inv3(const float* r, float* o) {
  const float a = r[0], b = r[1], c = r[2];
  const float d = r[3], e = r[4], f = r[5];
  const float g = r[6], h = r[7], i = r[8];
  const float A = e * i - f * h;
  const float B = -(d * i - f * g);
  const float C = d * h - e * g;
  const float D = -(b * i - c * h);
  const float E = a * i - c * g;
  const float F = -(a * h - b * g);
  const float G = b * f - c * e;
  const float H = -(a * f - c * d);
  const float I = a * e - b * d;
  const float inv_det = 1.0f / (a * A + b * B + c * C);
  o[0] = A * inv_det; o[1] = D * inv_det; o[2] = G * inv_det;
  o[3] = B * inv_det; o[4] = E * inv_det; o[5] = H * inv_det;
  o[6] = C * inv_det; o[7] = F * inv_det; o[8] = I * inv_det;
}

__device__ __forceinline__ void mm3(const float* x, const float* y,
                                    float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = x[3 * i] * y[j] + x[3 * i + 1] * y[3 + j] +
                     x[3 * i + 2] * y[6 + j];
}

__device__ __forceinline__ void mv3(const float* x, const float* v,
                                    float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = x[3 * i] * v[0] + x[3 * i + 1] * v[1] + x[3 * i + 2] * v[2];
}

// The lanes g of [base, base + lanes) with g % 2^k == r (base a multiple
// of lanes) are first + j * 2^k for j < count.
struct Range {
  int first, count;
};

__device__ __forceinline__ Range lanes_of(int base, int lanes, int k, int r) {
  Range out;
  out.first = base + ((r - base) & ((1 << k) - 1));
  out.count = out.first < base + lanes
                  ? ((base + lanes - out.first - 1) >> k) + 1
                  : 0;
  return out;
}

template <bool kCluster>
__device__ __forceinline__ void sync_cluster() {
  if constexpr (kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The matrices of lane g of the padded system (L[g] = U[g-1]^T; identity D
// and zero L, U past n) at offset s of p.
template <class Ln, class Off>
__device__ __forceinline__ void load_matrices(
    const Ln& ln, const float* __restrict__ Din,
    const float* __restrict__ Uin, float* p, Off s, int g, int n) {
  float d[9], u[9], l[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    d[k] = g < n ? Din[g * 9 + k] : (k % 4 == 0 ? 1.0f : 0.0f);
    u[k] = g < n - 1 ? Uin[g * 9 + k] : 0.0f;
    l[k] = g >= 1 && g < n ? Uin[(g - 1) * 9 + 3 * (k % 3) + k / 3] : 0.0f;
  }
  st<9>(ln, p, kD, s, d);
  st<9>(ln, p, kU, s, u);
  st<9>(ln, p, kL, s, l);
}

// Lane g of the padded system from D, U, b (zero b past n), stored at slot s
// of p.
template <class Ln>
__device__ __forceinline__ void load_lane(
    const Ln& ln, const float* __restrict__ Din,
    const float* __restrict__ Uin, const float* __restrict__ bin, float* p,
    int s, int g, int n) {
  float v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = g < n ? bin[g * 3 + k] : 0.0f;
  load_matrices(ln, Din, Uin, p, s, g, n);
  st<3>(ln, p, kB, s, v);
}

// Odd lane o of a level: Dinv (over D), Dinv L, Dinv U, Dinv b.
template <class Ln>
__device__ __forceinline__ void eliminate_odd(const Ln& ln, int o) {
  float* p = ln.own;
  const int so = ln.at(o);
  float Dm[9], Lm[9], Um[9], bm[3], Di[9], T[9], w[3];
  ld<9>(ln, p, kD, so, Dm);
  ld<9>(ln, p, kL, so, Lm);
  ld<9>(ln, p, kU, so, Um);
  ld<3>(ln, p, kB, so, bm);
  inv3(Dm, Di);
  st<9>(ln, p, kD, so, Di);
  mm3(Di, Lm, T);
  st<9>(ln, p, kDinvL, so, T);
  mm3(Di, Um, T);
  st<9>(ln, p, kDinvU, so, T);
  mv3(Di, bm, w);
  st<3>(ln, p, kDinvB, so, w);
}

// Even lane e absorbs its odd neighbours l = e - h (none for e == 0) and
// r = e + h:
//   D_e <- D_e - L_e DinvU_l - U_e DinvL_r
//   b_e <- b_e - L_e Dinvb_l - U_e Dinvb_r
//   L_e <- -L_e DinvL_l ;  U_e <- -U_e DinvU_r
template <class Ln>
__device__ __forceinline__ void absorb_even(const Ln& ln, int e, int h) {
  float* p = ln.own;
  const int se = ln.at(e);
  float Le[9], Ue[9], De[9], be[3];
  float DLl[9], DUl[9], Dbl[3], DLr[9], DUr[9], Dbr[3];
  ld<9>(ln, p, kL, se, Le);
  ld<9>(ln, p, kU, se, Ue);
  ld<9>(ln, p, kD, se, De);
  ld<3>(ln, p, kB, se, be);
  if (e > 0) {
    const float* q = ln.planes(e - h);
    const int s = ln.at(e - h);
    ld<9>(ln, q, kDinvL, s, DLl);
    ld<9>(ln, q, kDinvU, s, DUl);
    ld<3>(ln, q, kDinvB, s, Dbl);
  } else {
    zero<9>(DLl);
    zero<9>(DUl);
    zero<3>(Dbl);
  }
  {
    const float* q = ln.planes(e + h);
    const int s = ln.at(e + h);
    ld<9>(ln, q, kDinvL, s, DLr);
    ld<9>(ln, q, kDinvU, s, DUr);
    ld<3>(ln, q, kDinvB, s, Dbr);
  }
  float T[9], W[9], t3[3], w3[3];
  mm3(Le, DUl, T);
  mm3(Ue, DLr, W);
#pragma unroll
  for (int k = 0; k < 9; ++k) De[k] = De[k] - T[k] - W[k];
  st<9>(ln, p, kD, se, De);
  mv3(Le, Dbl, t3);
  mv3(Ue, Dbr, w3);
#pragma unroll
  for (int k = 0; k < 3; ++k) be[k] = be[k] - t3[k] - w3[k];
  st<3>(ln, p, kB, se, be);
  mm3(Le, DLl, T);
  negate<9>(T);
  st<9>(ln, p, kL, se, T);
  mm3(Ue, DUr, T);
  negate<9>(T);
  st<9>(ln, p, kU, se, T);
}

// Odd lane o of level h: x_o = Dinv_o (b_o - L_o x_{o-h} - U_o x_{o+h}),
// into its b plane.
template <class Ln>
__device__ __forceinline__ void back_substitute(const Ln& ln, int o, int h,
                                                int m) {
  float* p = ln.own;
  const int so = ln.at(o);
  float Lm[9], Um[9], Di[9], b[3], xl[3], xr[3], t3[3], w3[3];
  ld<3>(ln, ln.planes(o - h), kB, ln.at(o - h), xl);
  if (o + h < m)
    ld<3>(ln, ln.planes(o + h), kB, ln.at(o + h), xr);
  else
    zero<3>(xr);
  ld<9>(ln, p, kL, so, Lm);
  ld<9>(ln, p, kU, so, Um);
  ld<9>(ln, p, kD, so, Di);
  ld<3>(ln, p, kB, so, b);
  mv3(Lm, xl, t3);
  mv3(Um, xr, w3);
#pragma unroll
  for (int k = 0; k < 3; ++k) b[k] = b[k] - t3[k] - w3[k];
  mv3(Di, b, t3);
  st<3>(ln, p, kB, so, t3);
}

// p advanced to system blockIdx.y of a batch whose systems are `stride`
// floats apart.
template <class T>
__device__ __forceinline__ T* of_system(T* p, size_t stride) {
  return p == nullptr ? p : p + blockIdx.y * stride;
}

// The solve of m lanes in shared memory: one block (kCluster = false) or
// one block of a cluster of m / lanes blocks; block `rank` owns lanes
// [rank * lanes, (rank + 1) * lanes). Its lane g is lane g << top of the
// padded system: with top = 0 it reads D, U, b; with top > 0 the top levels
// have already run in `state` (device memory), which it reads the lanes
// from and writes their x back to, for the top levels' back-substitution.
// blockIdx.y picks the system of a batch.
template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads, 1)
bcr_kernel(const float* __restrict__ Din, const float* __restrict__ Uin,
           const float* __restrict__ bin, float* __restrict__ xout,
           float* __restrict__ state, int n, int m, int log2_lanes,
           int top) {
  extern __shared__ float sm[];
  Din = of_system(Din, 9 * static_cast<size_t>(n));
  Uin = of_system(Uin, 9 * static_cast<size_t>(n - 1));
  bin = of_system(bin, 3 * static_cast<size_t>(n));
  xout = of_system(xout, 3 * static_cast<size_t>(n));
  state = of_system(state, (static_cast<size_t>(m) << top) * kPlanes);
  const int lanes = 1 << log2_lanes;
  int rank = 0;
  if constexpr (kCluster) rank = static_cast<int>(cg::this_cluster().block_rank());
  const SharedLanes<kCluster> ln{sm, log2_lanes, rank};
  const int base = rank * lanes;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (top == 0) {
#pragma unroll 2
    for (int i = tid; i < lanes; i += nt)
      load_lane(ln, Din, Uin, bin, sm, slot(i), base + i, n);
  } else {
    for (int i = tid; i < lanes; i += nt) {
      const float* src = state + ((base + i) << top) * kPlanes;
#pragma unroll
      for (int q = 0; q < kB + 3; ++q) sm[q * kStride + slot(i)] = src[q];
    }
  }
  sync_cluster<kCluster>();

  int levels = 0;
  while ((1 << levels) < m) ++levels;

  // ---- downward elimination ----
  for (int k = 1; k <= levels; ++k) {
    const int h = 1 << (k - 1);
    const int s = 1 << k;
    const Range odd = lanes_of(base, lanes, k, h);
    for (int j = tid; j < odd.count; j += nt)
      eliminate_odd(ln, odd.first + j * s);
    sync_cluster<kCluster>();
    const Range even = lanes_of(base, lanes, k, 0);
    for (int j = tid; j < even.count; j += nt)
      absorb_even(ln, even.first + j * s, h);
    // the next level's odd step reads only its own block's lanes
    __syncthreads();
  }

  // ---- root: lane 0 ----
  if (rank == 0 && tid == 0) {
    float X[9], Di[9], b[3], x[3];
    ld<9>(ln, sm, kD, 0, X);
    inv3(X, Di);
    ld<3>(ln, sm, kB, 0, b);
    mv3(Di, b, x);
    st<3>(ln, sm, kB, 0, x);
  }
  sync_cluster<kCluster>();

  // ---- upward back-substitution ----
  for (int k = levels; k >= 1; --k) {
    const int h = 1 << (k - 1);
    const Range odd = lanes_of(base, lanes, k, h);
    for (int j = tid; j < odd.count; j += nt)
      back_substitute(ln, odd.first + j * (1 << k), h, m);
    sync_cluster<kCluster>();
  }

  for (int f = tid; f < 3 * lanes; f += nt) {
    const int i = f / 3;
    const int c = f - 3 * i;
    const int g = (base + i) << top;
    const float v = sm[(kB + c) * kStride + slot(i)];
    if (top > 0) state[g * kPlanes + kB + c] = v;
    if (g < n) xout[g * 3 + c] = v;
  }
}

enum LevelStep { kGather, kEliminate, kAbsorb, kBack };

// One step of a top level of an m-lane system in device memory, one thread
// a lane: gather (every lane, from D, U, b), eliminate the odd lanes of
// level k, absorb them into the even lanes, or back-substitute the odd
// lanes (and write their x). blockIdx.y picks the system of a batch.
__global__ void __launch_bounds__(kLevelThreads)
bcr_level(const float* __restrict__ Din, const float* __restrict__ Uin,
          const float* __restrict__ bin, float* __restrict__ xout,
          float* __restrict__ state, int n, int m, int k, int step) {
  Din = of_system(Din, 9 * static_cast<size_t>(n));
  Uin = of_system(Uin, 9 * static_cast<size_t>(n - 1));
  bin = of_system(bin, 3 * static_cast<size_t>(n));
  xout = of_system(xout, 3 * static_cast<size_t>(n));
  state = of_system(state, static_cast<size_t>(m) * kPlanes);
  const DeviceLanes ln{state};
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = 1 << (k - 1);
  if (step == kGather) {
    if (j < m) load_lane(ln, Din, Uin, bin, state, ln.at(j), j, n);
    return;
  }
  if (j >= (m >> k)) return;
  if (step == kEliminate) {
    eliminate_odd(ln, h + (j << k));
  } else if (step == kAbsorb) {
    absorb_even(ln, j << k, h);
  } else {
    const int o = h + (j << k);
    back_substitute(ln, o, h, m);
    if (o < n)
#pragma unroll
      for (int c = 0; c < 3; ++c) xout[o * 3 + c] = state[ln.at(o) + kB + c];
  }
}

struct Args {
  const float *D, *U, *b;
  float *x, *state;
  int batch, n, m, log2_lanes, top, threads, smem;
  cudaStream_t stream;
};

// The shared-memory solve of the m >> top lanes left after the top levels.
template <bool kCluster>
cudaError_t launch_shared(const Args& a) {
  auto kernel = bcr_kernel<kCluster>;
  // the attributes are set at the first launch of each device (smem is the
  // same for every launch)
  static int configured = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (configured != device) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err == cudaSuccess && kCluster)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  const int tail = a.m >> a.top;
  if constexpr (!kCluster) {
    kernel<<<dim3(1, a.batch, 1), a.threads, a.smem, a.stream>>>(
        a.D, a.U, a.b, a.x, a.state, a.n, tail, a.log2_lanes, a.top);
    return cudaGetLastError();
  } else {
    const int blocks = tail >> a.log2_lanes;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, a.batch, 1);
    cfg.blockDim = dim3(a.threads, 1, 1);
    cfg.dynamicSmemBytes = a.smem;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, a.D, a.U, a.b, a.x, a.state, a.n,
                             tail, a.log2_lanes, a.top);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
}

cudaError_t launch_level(const Args& a, int k, int step) {
  const int count = step == kGather ? a.m : a.m >> k;
  const int blocks = (count + kLevelThreads - 1) / kLevelThreads;
  bcr_level<<<dim3(blocks, a.batch, 1), kLevelThreads, 0, a.stream>>>(
      a.D, a.U, a.b, a.x, a.state, a.n, a.m, k, step);
  return cudaGetLastError();
}

cudaError_t solve(const Args& a) {
  if (a.top == 0)
    return a.m == 1 << a.log2_lanes ? launch_shared<false>(a)
                                    : launch_shared<true>(a);
  cudaError_t err = launch_level(a, 1, kGather);
  for (int k = 1; k <= a.top && err == cudaSuccess; ++k) {
    err = launch_level(a, k, kEliminate);
    if (err == cudaSuccess) err = launch_level(a, k, kAbsorb);
  }
  if (err == cudaSuccess) err = launch_shared<true>(a);
  for (int k = a.top; k >= 1 && err == cudaSuccess; --k)
    err = launch_level(a, k, kBack);
  return err;
}

// ---- the multi-right-hand-side route (hitl_bcr_solve_multi) ----
//
// S systems of n poses, each against R <= kMaxRhs right-hand sides:
// D [S, n, 3, 3], U [S, n-1, 3, 3], b [S, n, 3, R] -> x [S, n, 3, R]. D,
// U and b advance by their own system strides (in floats); within a system
// each is contiguous, x contiguous throughout.

constexpr int kMaxRhs = 8;
constexpr int kMaxSmem = 232448;

// A lane's floats: D (Dinv once eliminated), L, U at kD, kL, kU, then from
// kB its columns' b (then x), 3R floats in the order of b[g] = [3, R].
__host__ __device__ constexpr int multi_floats(int rhs) { return kB + 3 * rhs; }

// In shared memory the 27 matrix floats are planes of kStride floats, as in
// the lone route; the columns follow lane-major, lane i's 3R floats at
// kColumns + slot(i) * 3R, in their order in device memory, so that filling
// and draining them are straight copies. (3R is odd at odd R, so lanes 2^k
// apart fall in distinct banks.) A block takes multi_floats(R) * kStride
// floats.
constexpr int kColumns = kB * kStride;

// Lane g's floats: its matrices as in SharedLanes, its column c's component
// k at planes(g)[col(at(g)) + k * rhs + c].
template <bool kCluster>
struct MultiShared : SharedLanes<kCluster> {
  int rhs;

  __device__ __forceinline__ int col(int s) const {
    return kColumns + s * 3 * rhs;
  }
};

// the top levels' lane-major state: up to 2^25 lanes of up to 51 floats,
// offsets in 64 bits
struct MultiDevice {
  static constexpr int kStep = 1;
  float* own;
  int floats;
  int rhs;

  __device__ __forceinline__ float* planes(int) const { return own; }
  __device__ __forceinline__ size_t at(int g) const {
    return static_cast<size_t>(g) * floats;
  }
  __device__ __forceinline__ size_t col(size_t s) const { return s + kB; }
};

// column c of the lane at offset s
template <class Ln, class Off>
__device__ __forceinline__ void cld(const Ln& ln, const float* p, Off s, int c,
                                    float* v) {
  const auto o = ln.col(s) + c;
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = p[o + k * ln.rhs];
}

template <class Ln, class Off>
__device__ __forceinline__ void cst(const Ln& ln, float* p, Off s, int c,
                                    const float* v) {
  const auto o = ln.col(s) + c;
#pragma unroll
  for (int k = 0; k < 3; ++k) p[o + k * ln.rhs] = v[k];
}

// The block's lanes [base, base + lanes) of the padded system into shared
// memory: the matrices one thread a lane (as the lone route), the columns
// a warp 32 lanes at a time, a straight copy of their run of 96R floats,
// every load issued before the first store.
template <class Ln>
__device__ __forceinline__ void multi_fill(
    const Ln& ln, const float* __restrict__ Din,
    const float* __restrict__ Uin, const float* __restrict__ bin, float* sm,
    int base, int lanes, int n, int tid, int nt) {
#pragma unroll 2
  for (int i = tid; i < lanes; i += nt)
    load_matrices(ln, Din, Uin, sm, slot(i), base + i, n);
  const int t = tid & 31, w = 3 * ln.rhs;
  for (int c0 = tid & ~31; c0 < lanes; c0 += nt) {
    // slot(c0 + i) = slot(c0) + i for i < 32: the run is contiguous there
    const int g0 = base + c0;
    const int all = min(32, lanes - c0) * w;
    const int real = max(0, min(all, (n - g0) * w));
    const float* src = bin + g0 * w;
    float* dst = sm + kColumns + slot(c0) * w;
    float v[3 * kMaxRhs];
#pragma unroll
    for (int j = 0; j < 3 * kMaxRhs; ++j) {
      const int f = 32 * j + t;
      v[j] = f < real ? src[f] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 3 * kMaxRhs; ++j) {
      const int f = 32 * j + t;
      if (f < all) dst[f] = v[j];
    }
  }
}

// x of the block's lanes [base, base + lanes) (top = 0) from shared memory,
// a warp 32 lanes at a time, as multi_fill copies b.
template <class Ln>
__device__ __forceinline__ void multi_drain(const Ln& ln, const float* sm,
                                            float* __restrict__ xout,
                                            int base, int lanes, int n,
                                            int tid, int nt) {
  const int t = tid & 31, w = 3 * ln.rhs;
  for (int c0 = tid & ~31; c0 < lanes; c0 += nt) {
    const int g0 = base + c0;
    const int real = max(0, min(min(32, lanes - c0), n - g0) * w);
    const float* src = sm + kColumns + slot(c0) * w;
    float* dst = xout + g0 * w;
#pragma unroll
    for (int j = 0; j < 3 * kMaxRhs; ++j) {
      const int f = 32 * j + t;
      if (f < real) dst[f] = src[f];
    }
  }
}

// Odd lane o of a level: Dinv over D. Its L, U stay for the
// back-substitution; its even neighbours form Dinv L, Dinv U, Dinv b from
// them (the lone route stores those products here).
template <class Ln>
__device__ __forceinline__ void multi_eliminate_odd(const Ln& ln, int o) {
  float* p = ln.own;
  const auto so = ln.at(o);
  float Dm[9], Di[9];
  ld<9>(ln, p, kD, so, Dm);
  inv3(Dm, Di);
  st<9>(ln, p, kD, so, Di);
}

// Dinv L and Dinv U of odd lane g (zero for a missing left neighbour).
template <class Ln>
__device__ __forceinline__ void multi_products(const Ln& ln, int g, bool has,
                                               float* DL, float* DU) {
  if (!has) {
    zero<9>(DL);
    zero<9>(DU);
    return;
  }
  const float* q = ln.planes(g);
  const auto s = ln.at(g);
  float Di[9], Lm[9], Um[9];
  ld<9>(ln, q, kD, s, Di);
  ld<9>(ln, q, kL, s, Lm);
  ld<9>(ln, q, kU, s, Um);
  mm3(Di, Lm, DL);
  mm3(Di, Um, DU);
}

// The matrix half of absorb_even: even lane e absorbs its odd neighbours
// l = e - h (none for e == 0) and r = e + h,
//   D_e <- D_e - L_e DinvU_l - U_e DinvL_r   (stored)
//   L_e, U_e <- -L_e DinvL_l, -U_e DinvU_r   (returned: the lane's columns
//                                             still read the old ones)
template <class Ln>
__device__ __forceinline__ void multi_absorb_matrices(const Ln& ln, int e,
                                                      int h, float* Ln_,
                                                      float* Un_) {
  float* p = ln.own;
  const auto se = ln.at(e);
  float Le[9], Ue[9], De[9], DLl[9], DUl[9], DLr[9], DUr[9];
  ld<9>(ln, p, kL, se, Le);
  ld<9>(ln, p, kU, se, Ue);
  ld<9>(ln, p, kD, se, De);
  multi_products(ln, e - h, e > 0, DLl, DUl);
  multi_products(ln, e + h, true, DLr, DUr);
  float T[9], W[9];
  mm3(Le, DUl, T);
  mm3(Ue, DLr, W);
#pragma unroll
  for (int k = 0; k < 9; ++k) De[k] = De[k] - T[k] - W[k];
  st<9>(ln, p, kD, se, De);
  mm3(Le, DLl, Ln_);
  negate<9>(Ln_);
  mm3(Ue, DUr, Un_);
  negate<9>(Un_);
}

template <class Ln>
__device__ __forceinline__ void multi_store_lu(const Ln& ln, int e,
                                               const float* Ln_,
                                               const float* Un_) {
  const auto se = ln.at(e);
  st<9>(ln, ln.own, kL, se, Ln_);
  st<9>(ln, ln.own, kU, se, Un_);
}

// Columns c0, c0 + step, ... < R of even lane e:
// b_e <- b_e - L_e (Dinv_l b_l) - U_e (Dinv_r b_r), the neighbours' Dinv b
// formed here from their Dinv (the same products as the lone route's). The
// lane's L, U and the neighbours' Dinv are read once for the columns.
template <class Ln>
__device__ __forceinline__ void multi_absorb_columns(const Ln& ln, int e,
                                                     int h, int c0, int step) {
  float* p = ln.own;
  const auto se = ln.at(e);
  const float* ql = ln.planes(e > 0 ? e - h : e + h);
  const auto sl = ln.at(e > 0 ? e - h : e + h);
  const float* qr = ln.planes(e + h);
  const auto sr = ln.at(e + h);
  float Le[9], Ue[9], Dil[9], Dir[9];
  ld<9>(ln, p, kL, se, Le);
  ld<9>(ln, p, kU, se, Ue);
  ld<9>(ln, ql, kD, sl, Dil);
  ld<9>(ln, qr, kD, sr, Dir);
  for (int c = c0; c < ln.rhs; c += step) {
    float be[3], v[3], Dbl[3], Dbr[3], t3[3], w3[3];
    cld(ln, p, se, c, be);
    if (e > 0) {
      cld(ln, ql, sl, c, v);
      mv3(Dil, v, Dbl);
    } else {
      zero<3>(Dbl);
    }
    cld(ln, qr, sr, c, v);
    mv3(Dir, v, Dbr);
    mv3(Le, Dbl, t3);
    mv3(Ue, Dbr, w3);
#pragma unroll
    for (int k = 0; k < 3; ++k) be[k] = be[k] - t3[k] - w3[k];
    cst(ln, p, se, c, be);
  }
}

// Columns c0, c0 + step, ... < R of odd lane o of level h:
// x_o = Dinv_o (b_o - L_o x_{o-h} - U_o x_{o+h}), into its b.
template <class Ln>
__device__ __forceinline__ void multi_back_substitute(const Ln& ln, int o,
                                                      int h, int m, int c0,
                                                      int step) {
  float* p = ln.own;
  const auto so = ln.at(o);
  const float* ql = ln.planes(o - h);
  const auto sl = ln.at(o - h);
  const bool right = o + h < m;
  const float* qr = ln.planes(right ? o + h : o - h);
  const auto sr = ln.at(right ? o + h : o - h);
  float Lm[9], Um[9], Di[9];
  ld<9>(ln, p, kL, so, Lm);
  ld<9>(ln, p, kU, so, Um);
  ld<9>(ln, p, kD, so, Di);
  for (int c = c0; c < ln.rhs; c += step) {
    float b[3], xl[3], xr[3], t3[3], w3[3];
    cld(ln, ql, sl, c, xl);
    if (right)
      cld(ln, qr, sr, c, xr);
    else
      zero<3>(xr);
    cld(ln, p, so, c, b);
    mv3(Lm, xl, t3);
    mv3(Um, xr, w3);
#pragma unroll
    for (int k = 0; k < 3; ++k) b[k] = b[k] - t3[k] - w3[k];
    mv3(Di, b, t3);
    cst(ln, p, so, c, t3);
  }
}

// Column c of the root, lane 0 after the last level: x = D^-1 b.
template <class Ln>
__device__ __forceinline__ void multi_root(const Ln& ln, int c) {
  float* p = ln.own;
  const auto s0 = ln.at(0);
  float X[9], Di[9], b[3], x[3];
  ld<9>(ln, p, kD, s0, X);
  inv3(X, Di);
  cld(ln, p, s0, c, b);
  mv3(Di, b, x);
  cst(ln, p, s0, c, x);
}

// log2 of a power of two
__device__ __forceinline__ int log2_of(int v) { return __ffs(v) - 1; }

// The shared-memory solve of the multi route, as bcr_kernel: one block
// (kCluster = false) or one block of a cluster of m / lanes blocks, system
// blockIdx.y. A level is the lone route's two steps: the odd lanes invert
// their D (one thread a lane), then the even lanes' work items, one for
// its matrices and G for its columns (columns g, g + G, ...), G as large as
// the block's threads allow, up to R: one column an item at the deep
// levels, where the chain of steps sets the time, and a lane's columns
// together at the wide ones, where shared-memory traffic does. The matrix
// items fill whole warps of their own, so a deep level's matrix thread and
// its column threads run side by side. A matrix item keeps the new L, U in
// registers and stores them at the next level's odd step, which reads only
// D: by then every column has read the old ones. Each block has at least
// as many threads as even lanes at the first level, so a thread holds at
// most one lane's new L, U. The back-substitution and the root are column
// items only.
template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads, 1)
bcr_multi_kernel(const float* __restrict__ Din, const float* __restrict__ Uin,
                 const float* __restrict__ bin, float* __restrict__ xout,
                 float* __restrict__ state, long long sD, long long sU,
                 long long sb, int n, int rhs, int m, int log2_lanes,
                 int top) {
  using Ln = MultiShared<kCluster>;
  extern __shared__ float sm[];
  const int floats = multi_floats(rhs);
  const int w = 3 * rhs;
  Din = of_system(Din, static_cast<size_t>(sD));
  Uin = of_system(Uin, static_cast<size_t>(sU));
  bin = of_system(bin, static_cast<size_t>(sb));
  xout = of_system(xout, static_cast<size_t>(n) * w);
  state = of_system(state, (static_cast<size_t>(m) << top) * floats);
  const int lanes = 1 << log2_lanes;
  int rank = 0;
  if constexpr (kCluster) rank = static_cast<int>(cg::this_cluster().block_rank());
  const Ln ln{{sm, log2_lanes, rank}, rhs};
  const int base = rank * lanes;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (top == 0) {
    multi_fill(ln, Din, Uin, bin, sm, base, lanes, n, tid, nt);
  } else {
    for (int f = tid; f < lanes * floats; f += nt) {
      const int i = f / floats, q = f - i * floats;
      const float v = state[(static_cast<size_t>(base + i) << top) * floats + q];
      if (q < kB)
        sm[q * kStride + slot(i)] = v;
      else
        sm[ln.col(slot(i)) + q - kB] = v;
    }
  }
  sync_cluster<kCluster>();

  int levels = 0;
  while ((1 << levels) < m) ++levels;

  // ---- downward elimination ----
  float Lnew[9], Unew[9];
  int held = -1;   // the lane whose new L, U this thread holds
  for (int k = 1; k <= levels; ++k) {
    const int h = 1 << (k - 1);
    const int s = 1 << k;
    if (held >= 0) multi_store_lu(ln, held, Lnew, Unew);
    held = -1;
    const Range odd = lanes_of(base, lanes, k, h);
    for (int j = tid; j < odd.count; j += nt)
      multi_eliminate_odd(ln, odd.first + j * s);
    sync_cluster<kCluster>();
    // a block's even lanes are 0 or a power of two
    const Range even = lanes_of(base, lanes, k, 0);
    if (tid < even.count) {
      held = even.first + tid * s;
      multi_absorb_matrices(ln, held, h, Lnew, Unew);
    }
    if (even.count > 0) {
      const int lg = log2_of(even.count);
      const int mat = (even.count + 31) & ~31;
      const int groups = min(rhs, max(1, (nt - mat) >> lg));
      for (int q = tid < mat ? tid + nt : tid;
           q < mat + (groups << lg); q += nt) {
        const int r = q - mat;
        multi_absorb_columns(ln, even.first + (r & (even.count - 1)) * s, h,
                             r >> lg, groups);
      }
    }
    // the next level's odd step reads only its own block's lanes
    __syncthreads();
  }
  // (the last level's new L, U, lane 0's, are read by no one)

  // ---- root: lane 0 ----
  if (rank == 0)
    for (int c = tid; c < rhs; c += nt) multi_root(ln, c);
  sync_cluster<kCluster>();

  // ---- upward back-substitution ----
  for (int k = levels; k >= 1; --k) {
    const int h = 1 << (k - 1);
    const Range odd = lanes_of(base, lanes, k, h);
    if (odd.count > 0) {
      const int lg = log2_of(odd.count);
      const int groups = min(rhs, max(1, nt >> lg));
      for (int q = tid; q < groups << lg; q += nt)
        multi_back_substitute(ln, odd.first + (q & (odd.count - 1)) * (1 << k),
                              h, m, q >> lg, groups);
    }
    sync_cluster<kCluster>();
  }

  if (top == 0) {
    multi_drain(ln, sm, xout, base, lanes, n, tid, nt);
    return;
  }
  for (int i = tid; i < lanes; i += nt) {
    const int g = (base + i) << top;
    for (int q = 0; q < w; ++q) {
      const float v = sm[ln.col(slot(i)) + q];
      state[static_cast<size_t>(g) * floats + kB + q] = v;
      if (g < n) xout[static_cast<size_t>(g) * w + q] = v;
    }
  }
}

// One step of a top level of the multi route, in device memory, one thread
// a lane and its columns in turn (these are the wide levels), as bcr_level;
// an even lane's columns run before its matrices, which overwrite its L, U.
__global__ void __launch_bounds__(kLevelThreads)
bcr_multi_level(const float* __restrict__ Din, const float* __restrict__ Uin,
                const float* __restrict__ bin, float* __restrict__ xout,
                float* __restrict__ state, long long sD, long long sU,
                long long sb, int n, int rhs, int m, int k, int step) {
  const int floats = multi_floats(rhs);
  const int w = 3 * rhs;
  Din = of_system(Din, static_cast<size_t>(sD));
  Uin = of_system(Uin, static_cast<size_t>(sU));
  bin = of_system(bin, static_cast<size_t>(sb));
  xout = of_system(xout, static_cast<size_t>(n) * w);
  state = of_system(state, static_cast<size_t>(m) * floats);
  const MultiDevice ln{state, floats, rhs};
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = 1 << (k - 1);
  if (step == kGather) {
    if (j < m) {
      const size_t s = ln.at(j);
      load_matrices(ln, Din, Uin, state, s, j, n);
      for (int q = 0; q < w; ++q)
        state[ln.col(s) + q] = j < n ? bin[static_cast<size_t>(j) * w + q] : 0.0f;
    }
    return;
  }
  if (j >= (m >> k)) return;
  if (step == kEliminate) {
    multi_eliminate_odd(ln, h + (j << k));
  } else if (step == kAbsorb) {
    const int e = j << k;
    multi_absorb_columns(ln, e, h, 0, 1);
    float Lnew[9], Unew[9];
    multi_absorb_matrices(ln, e, h, Lnew, Unew);
    multi_store_lu(ln, e, Lnew, Unew);
  } else {
    const int o = h + (j << k);
    multi_back_substitute(ln, o, h, m, 0, 1);
    if (o < n) {
      const size_t s = ln.col(ln.at(o));
      for (int q = 0; q < w; ++q)
        xout[static_cast<size_t>(o) * w + q] = state[s + q];
    }
  }
}

struct MultiArgs {
  const float *D, *U, *b;
  float *x, *state;
  long long sD, sU, sb;
  int systems, n, rhs, m, log2_lanes, top, threads, smem;
  cudaStream_t stream;
};

template <bool kCluster>
cudaError_t multi_launch_shared(const MultiArgs& a) {
  auto kernel = bcr_multi_kernel<kCluster>;
  // set at the first launch of each device, to the most a block may have:
  // the plans' shared memory differs with R
  static int configured = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (configured != device) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess && kCluster)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  const int tail = a.m >> a.top;
  const int blocks = tail >> a.log2_lanes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, a.systems, 1);
  cfg.blockDim = dim3(a.threads, 1, 1);
  cfg.dynamicSmemBytes = a.smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  if constexpr (kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a.D, a.U, a.b, a.x, a.state, a.sD,
                           a.sU, a.sb, a.n, a.rhs, tail, a.log2_lanes, a.top);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t multi_launch_level(const MultiArgs& a, int k, int step) {
  const int count = step == kGather ? a.m : a.m >> k;
  const int blocks = (count + kLevelThreads - 1) / kLevelThreads;
  bcr_multi_level<<<dim3(blocks, a.systems, 1), kLevelThreads, 0, a.stream>>>(
      a.D, a.U, a.b, a.x, a.state, a.sD, a.sU, a.sb, a.n, a.rhs, a.m, k,
      step);
  return cudaGetLastError();
}

cudaError_t multi_solve(const MultiArgs& a) {
  if (a.top == 0)
    return a.m == 1 << a.log2_lanes ? multi_launch_shared<false>(a)
                                    : multi_launch_shared<true>(a);
  cudaError_t err = multi_launch_level(a, 1, kGather);
  for (int k = 1; k <= a.top && err == cudaSuccess; ++k) {
    err = multi_launch_level(a, k, kEliminate);
    if (err == cudaSuccess) err = multi_launch_level(a, k, kAbsorb);
  }
  if (err == cudaSuccess) err = multi_launch_shared<true>(a);
  for (int k = a.top; k >= 1 && err == cudaSuccess; --k)
    err = multi_launch_level(a, k, kBack);
  return err;
}

}  // namespace

// Solve B systems of n poses, stacked in D [B, n, 3, 3], U [B, n-1, 3, 3],
// b [B, n, 3] -> x [B, n, 3], with the launch plan the wrapper computed
// (solver/bcr_kernel.py::launch_plan): m = next_pow2(n) lanes a system, of
// which the top `top` levels run in `state` (kPlanes floats a lane of
// device memory, B * m lanes; null when top = 0); the m >> top lanes left
// are solved in shared memory, 2^log2_lanes of them per block, in
// (m >> top) / 2^log2_lanes blocks a system (a cluster when more than one),
// `threads` threads and `smem` bytes of dynamic shared memory per block.
// Returns a CUDA error code; a plan outside the routes, or B outside
// [1, 65535] (gridDim.y), is refused with cudaErrorInvalidValue.
extern "C" int hitl_bcr_solve_batched(const void* D, const void* U,
                                      const void* b, void* x, void* state,
                                      int batch, int n, int m,
                                      int log2_lanes, int top, int threads,
                                      int smem, void* stream) {
  const int lanes = log2_lanes >= 0 && log2_lanes < 31 ? 1 << log2_lanes : 0;
  const int tail = top >= 0 && top < 31 ? m >> top : 0;
  if (batch < 1 || batch > 65535 || n < 1 || m < n || m > kMaxLanes ||
      (m & (m - 1)) != 0 || tail < 1 || lanes < 1 ||
      lanes > kMaxLanesPerBlock || tail % lanes != 0 ||
      tail / lanes > kMaxCluster ||
      (top > 0 && (tail != kMaxSharedLanes || state == nullptr)) ||
      threads < 1 || threads > kMaxThreads || smem != kPlanes * kStride * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(D), static_cast<const float*>(U),
               static_cast<const float*>(b), static_cast<float*>(x),
               static_cast<float*>(state), batch, n, m, log2_lanes, top,
               threads, smem, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(solve(a));
}

// One system: the batched entry at B = 1.
extern "C" int hitl_bcr_solve(const void* D, const void* U, const void* b,
                              void* x, void* state, int n, int m,
                              int log2_lanes, int top, int threads, int smem,
                              void* stream) {
  return hitl_bcr_solve_batched(D, U, b, x, state, 1, n, m, log2_lanes, top,
                                threads, smem, stream);
}

// Solve S systems of n poses, each against R right-hand sides, with the
// launch plan the wrapper computed (solver/bcr_kernel.py::launch_plan(n,
// R)): D [S, n, 3, 3], U [S, n-1, 3, 3], b [S, n, 3, R] with system strides
// sD, sU, sb (floats; the rest of a system contiguous) -> x [S, n, 3, R]
// contiguous. m = next_pow2(n) lanes a system, of which the top `top`
// levels run in `state` (multi_floats(R) floats a lane, S * m lanes; null
// when top = 0); the m >> top lanes left are solved in shared memory,
// 2^log2_lanes per block, in blocks of `threads` threads (at least one for
// each even lane of the first level) and `smem` bytes (at least
// multi_floats(R) planes of kStride floats). Returns a CUDA error
// code; a plan outside the routes, R outside [1, kMaxRhs] or S outside
// [1, 65535] is refused with cudaErrorInvalidValue.
extern "C" int hitl_bcr_solve_multi(const void* D, const void* U,
                                    const void* b, void* x, void* state,
                                    long long sD, long long sU, long long sb,
                                    int systems, int n, int rhs, int m,
                                    int log2_lanes, int top, int threads,
                                    int smem, void* stream) {
  const int lanes = log2_lanes >= 0 && log2_lanes < 31 ? 1 << log2_lanes : 0;
  const int tail = top >= 0 && top < 31 ? m >> top : 0;
  if (rhs < 1 || rhs > kMaxRhs || systems < 1 || systems > 65535 || n < 1 ||
      m < n || m > kMaxLanes || (m & (m - 1)) != 0 || tail < 1 ||
      lanes < 1 || lanes > kMaxLanesPerBlock || tail % lanes != 0 ||
      tail / lanes > kMaxCluster ||
      (top > 0 && (tail != kMaxSharedLanes || state == nullptr)) ||
      threads < ((lanes / 2 + 31) & ~31) || threads > kMaxThreads ||
      smem < multi_floats(rhs) * kStride * 4 || smem > kMaxSmem ||
      sD < 0 || sU < 0 || sb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const MultiArgs a{static_cast<const float*>(D), static_cast<const float*>(U),
                    static_cast<const float*>(b), static_cast<float*>(x),
                    static_cast<float*>(state), sD, sU, sb, systems, n, rhs,
                    m, log2_lanes, top, threads, smem,
                    static_cast<cudaStream_t>(stream)};
  return static_cast<int>(multi_solve(a));
}
