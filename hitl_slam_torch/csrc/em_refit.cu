// One round of the EM endpoint refit, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the refit
// (hitl_slam_tpu/models/hitl/em_input.py::endpoint_adjust_batch, the body of
// its lax.while_loop) to XLA. In the port the same round was ~530 PyTorch
// kernels a trip of the cycle graph's WHILE node: dist_to_segment and the
// weights over all P*N point slots of both strokes, then 25 Newton steps of
// _segfit_theta, each ~17 element-wise kernels and two sums over [S, P*N].
// Only the slots within 0.03 m of a stroke (its inliers) add anything to
// those sums; every other slot adds an exact zero. So what bounds a round is
// one pass of bytes over the map (8 bytes of point and 1 of mask a slot:
// 2.4 MB at 1024 poses x 256 slots, 18.9 MB at 8192 x 256; 0.7 and 5.6 us
// at 3.35 TB/s), then 25 reductions over the inliers alone, each a chain of
// barriers. One launch does the round, as one thread-block cluster of 1 to
// 16 blocks (ops/em_refit.py::launch_plan sizes it from P*N):
//   1. every thread forms each active stroke's midpoint, half length, start
//      angle and segment, in the plain version's operation order;
//   2. select: the map is cut into chunks of kBatch groups of 64 slots,
//      dealt to the cluster's warps in turn, so that every warp meets its
//      share of the walls the strokes lie on (a block's contiguous run
//      left the blocks that held a wall tens of microseconds behind the
//      others). A warp loads a chunk at once (a float4 of two points and a
//      2-byte mask word a lane a group), tests each slot against each
//      active stroke as dist_to_segment does, and keeps each group's two
//      ballots a stroke in scratch. On 16 SMs this walk is bound by its
//      instructions (the test's division and square root), not its bytes;
//   3. the warps' inlier counts are summed over the block and the blocks'
//      over the cluster (integers; each block stores its counts into every
//      block's shared memory), so each warp knows where its inliers go: the
//      warps' in turn, each warp's in the order it walked them. A second
//      walk over the ballots loads only the inliers' points and writes
//      rel = p - cm to a scratch list (sized for every slot an inlier, so
//      no count overflows it);
//   4. each block takes an equal run of each stroke's list: into shared
//      memory where the runs fit there (route "shared"), else read from the
//      L2-resident scratch at every step (route "scratch");
//   5. 25 Newton steps: each thread sums over its inliers in a fixed order,
//      then a butterfly over the warp, over the warps in order, and over the
//      cluster's blocks in rank order (each block stores its sums into
//      every block's shared memory before a cluster barrier, and reads its
//      own after it: no load crosses the cluster), so every thread of every
//      block holds the same bits and takes the same step;
//   6. one thread forms the new endpoints, `moved`, the active select, the
//      loop's `go`, and each active stroke's inlier count and route.
// No atomics: a replay repeats bit for bit. Built with --fmad=false, each
// element rounds as the plain version's separate PyTorch ops, so the inlier
// set is the plain version's bit for bit and only the order of the sums'
// non-zero terms differs.
// On the H100 a round took 0.070 ms at 1024 x 256 slots (~7,600 inliers)
// and 0.171 ms at 8192 x 256 (~170,000): the 25 steps ~2.1-3.0 us each,
// ~1.5 us of it the block and cluster barriers; the rest the select.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxCluster = 16;
constexpr int kMaxStrokes = 2;
// slots a group: 32 lanes of two
constexpr int kGroup = 2 * kWarp;
// groups a warp has in flight in its walks
constexpr int kBatch = 8;
static_assert(kBatch <= 32 && (kBatch & (kBatch - 1)) == 0,
              "a chunk's ballots are one load a lane of a warp");
// the inliers a block holds in shared memory, of both strokes together
constexpr int kSmemBytes = 196608;
constexpr int kSmemInliers = kSmemBytes / 8;
constexpr int kMaxSlots = 1 << 30;
// where the steps read the inliers from (ops/em_refit.py::ROUTES)
enum { kShared = 0, kScratch = 1 };

struct Args {
  const float* pts;      // [M, 2]
  const uint8_t* mask;   // [M]
  float* s;              // [S, 2, 2] the carry's endpoints
  float* moved;          // [S]
  bool* go;
  int* stats;            // [S, 2]: inliers, route
  uint32_t* bits;        // [S, groups, 2]: each group's even and odd ballots
  float2* rel;           // [S, M]: the inliers less the midpoint, walk order
  int M, S, iters;
  float inlier, stable;
};

// PyTorch's clamp and maximum: a NaN stays NaN
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) || isnan(b) ? a + b : fmaxf(a, b);
}

// A stroke as the round sees it: its endpoints, the segment test's terms,
// and the fit's midpoint, half length and angle.
struct Stroke {
  float p1x, p1y, p2x, p2y;
  float dx, dy, denom;
  float cmx, cmy, half, theta;
  bool active;
};

__device__ Stroke load_stroke(const Args& a, int k) {
  Stroke t;
  const float* e = a.s + 4 * k;
  t.p1x = e[0];
  t.p1y = e[1];
  t.p2x = e[2];
  t.p2y = e[3];
  t.active = a.moved[k] > a.stable;
  // dist_to_segment: d = p2 - p1, denom = clamp(sum(d * d), min=1e-20)
  t.dx = t.p2x - t.p1x;
  t.dy = t.p2y - t.p1y;
  t.denom = clamp_nan(t.dx * t.dx + t.dy * t.dy, 1e-20f, INFINITY);
  // cm = 0.5 * (p1 + p2), delta = p1 - p2, half_len = 0.5 * norm2(delta),
  // theta0 = atan2(delta_y, delta_x)
  t.cmx = 0.5f * (t.p1x + t.p2x);
  t.cmy = 0.5f * (t.p1y + t.p2y);
  const float ddx = t.p1x - t.p2x, ddy = t.p1y - t.p2y;
  t.half = 0.5f * sqrtf(ddx * ddx + ddy * ddy);
  t.theta = atan2f(ddy, ddx);
  return t;
}

// dist_to_segment(p1, p2, p) < inlier, in its operation order
__device__ __forceinline__ bool inlier(const Stroke& t, float x, float y,
                                      float limit) {
  float u = ((x - t.p1x) * t.dx + (y - t.p1y) * t.dy) / t.denom;
  u = clamp_nan(u, 0.0f, 1.0f);
  const float ex = x - (t.p1x + u * t.dx);
  const float ey = y - (t.p1y + u * t.dy);
  return sqrtf(ex * ex + ey * ey) < limit;
}

// The two points and mask bytes of a lane in group g: slots 64 g + 2 lane
// and + 1, those past M masked out.
struct Pair {
  float4 p;
  uint32_t m;   // bit 0: the first slot, bit 1: the second
};

__device__ __forceinline__ uint32_t mask_bits(uint16_t w) {
  return ((w & 0xffu) != 0 ? 1u : 0u) | ((w >> 8) != 0 ? 2u : 0u);
}

// A group wholly inside the map: one float4 and one 2-byte load a lane, no
// branch, so that a batch's loads are all in flight before the first use.
__device__ __forceinline__ Pair load_full(const Args& a, int g, int lane) {
  const long long j = static_cast<long long>(g) * kWarp + lane;
  return Pair{__ldg(reinterpret_cast<const float4*>(a.pts) + j),
              mask_bits(__ldg(reinterpret_cast<const uint16_t*>(a.mask) + j))};
}

// The map's last group where it ends inside it.
__device__ Pair load_part(const Args& a, int g, int lane) {
  Pair q{make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0u};
  const long long i = static_cast<long long>(g) * kGroup + 2 * lane;
  if (i < a.M) {
    q.p.x = a.pts[2 * i];
    q.p.y = a.pts[2 * i + 1];
    q.m = a.mask[i] != 0 ? 1u : 0u;
  }
  if (i + 1 < a.M) {
    q.p.z = a.pts[2 * i + 2];
    q.p.w = a.pts[2 * i + 3];
    q.m |= a.mask[i + 1] != 0 ? 2u : 0u;
  }
  return q;
}

// The chunks of kBatch groups a warp walks: chunk c of the map goes to the
// grid's warp c mod (blocks * kWarps), warps numbered block by block, so
// that every warp meets its share of the walls the strokes lie on. The
// warps' inliers are laid out in that order: each warp's after those of
// the warps before it, its own in the order it walks them.
struct Walk {
  int first, stride, chunks;
};

__device__ __forceinline__ Walk warp_walk(int groups, int blocks, int rank,
                                          int warp) {
  return Walk{rank * kWarps + warp, blocks * kWarps,
              (groups + kBatch - 1) / kBatch};
}

// Group g's test against each active stroke: its two ballots a stroke into
// scratch, and the warp's counts.
__device__ __forceinline__ void test_group(const Args& a,
                                           const Stroke (&st)[kMaxStrokes],
                                           int g, int groups, int lane,
                                           const Pair& q,
                                           int (&count)[kMaxStrokes]) {
#pragma unroll
  for (int k = 0; k < kMaxStrokes; ++k) {
    if (k >= a.S || !st[k].active) continue;
    const bool e = (q.m & 1u) && inlier(st[k], q.p.x, q.p.y, a.inlier);
    const bool o = (q.m & 2u) && inlier(st[k], q.p.z, q.p.w, a.inlier);
    const uint32_t be = __ballot_sync(0xffffffffu, e);
    const uint32_t bo = __ballot_sync(0xffffffffu, o);
    if (lane < 2)
      a.bits[2 * (static_cast<long long>(k) * groups + g) + lane] =
          lane ? bo : be;
    count[k] += __popc(be) + __popc(bo);
  }
}

// Walk 1: each group's ballots of each active stroke into scratch; the
// warp's inlier count of each stroke. A chunk's loads are in flight
// together.
__device__ void select_walk(const Args& a, const Stroke (&st)[kMaxStrokes],
                            Walk w, int groups, int lane,
                            int (&count)[kMaxStrokes]) {
  const int full = a.M / kGroup;
  for (int c = w.first; c < w.chunks; c += w.stride) {
    const int g0 = c * kBatch;
    if (g0 + kBatch <= full) {
      Pair q[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) q[u] = load_full(a, g0 + u, lane);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        test_group(a, st, g0 + u, groups, lane, q[u], count);
    } else {
      for (int g = g0; g < min(groups, g0 + kBatch); ++g)
        test_group(a, st, g, groups, lane,
                   g < full ? load_full(a, g, lane) : load_part(a, g, lane),
                   count);
    }
  }
}

// Walk 2: the inliers' rel = p - cm, written to the list of their stroke
// from the warp's first place `at`, in the order of walk 1. A chunk's
// ballots come in one load a lane; only its groups that hold an inlier
// load their points, all in flight together.
__device__ void gather_walk(const Args& a, const Stroke (&st)[kMaxStrokes],
                            Walk w, int groups, int lane,
                            int (&at)[kMaxStrokes]) {
  const uint32_t below = (1u << lane) - 1u;
  const int full = a.M / kGroup;
  for (int c = w.first; c < w.chunks; c += w.stride) {
    const int g0 = c * kBatch;
    const int g = g0 + (lane & (kBatch - 1));
    uint32_t be[kMaxStrokes], bo[kMaxStrokes];
    bool any = false;
#pragma unroll
    for (int k = 0; k < kMaxStrokes; ++k) {
      be[k] = bo[k] = 0u;
      if (lane < kBatch && g < groups && k < a.S && st[k].active) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            a.bits + 2 * (static_cast<long long>(k) * groups + g));
        be[k] = b.x;
        bo[k] = b.y;
      }
      any = any || (be[k] | bo[k]) != 0u;
    }
    if (!__any_sync(0xffffffffu, any)) continue;
    uint32_t e[kBatch][kMaxStrokes], o[kBatch][kMaxStrokes];
    Pair q[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      uint32_t mine = 0u;
#pragma unroll
      for (int k = 0; k < kMaxStrokes; ++k) {
        e[u][k] = __shfl_sync(0xffffffffu, be[k], u);
        o[u][k] = __shfl_sync(0xffffffffu, bo[k], u);
        mine |= e[u][k] | o[u][k];
      }
      q[u] = Pair{make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0u};
      if (((mine >> lane) & 1u) && g0 + u < full)
        q[u] = load_full(a, g0 + u, lane);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (g0 + u >= full && g0 + u < groups) q[u] = load_part(a, g0 + u, lane);
#pragma unroll
      for (int k = 0; k < kMaxStrokes; ++k) {
        const uint32_t eu = e[u][k], ou = o[u][k];
        if ((eu | ou) == 0u) continue;
        float2* list = a.rel + static_cast<long long>(k) * a.M;
        int i = at[k] + __popc(eu & below) + __popc(ou & below);
        if ((eu >> lane) & 1u)
          list[i++] = make_float2(q[u].p.x - st[k].cmx, q[u].p.y - st[k].cmy);
        if ((ou >> lane) & 1u)
          list[i] = make_float2(q[u].p.z - st[k].cmx, q[u].p.w - st[k].cmy);
        at[k] += __popc(eu) + __popc(ou);
      }
    }
  }
}

// A butterfly over the warp: every lane ends with the same bits (each step
// adds the same two values on both lanes of a pair).
template <int kN>
__device__ __forceinline__ void warp_sum(float (&v)[kN]) {
#pragma unroll
  for (int o = kWarp / 2; o; o >>= 1)
#pragma unroll
    for (int n = 0; n < kN; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
}

// An exclusive prefix and the total of one int a lane, over the warp.
__device__ __forceinline__ int warp_scan(int v, int lane, int* total) {
  int inc = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  *total = __shfl_sync(0xffffffffu, inc, kWarp - 1);
  return inc - v;
}

constexpr int kSums = 2 * kMaxStrokes;   // num, den of each stroke
constexpr int kLanes = 4;                 // running sums a thread keeps
static_assert(kSums == 4 && kLanes == 4, "the sums are added as four");

// One inlier's terms of _segfit_theta's sums, in its operation order:
// t = rel.a, perp = rel.n, tc = clip(t, -L, L); num += -perp * tc,
// den += |t * tc|.
__device__ __forceinline__ void newton_terms(float2 r, float c, float s,
                                             float lo, float hi, float& num,
                                             float& den) {
  const float t = r.x * c + r.y * s;
  const float perp = r.y * c - r.x * s;
  const float tc = clamp_nan(t, lo, hi);
  num += -perp * tc;
  den += fabsf(t * tc);
}

__global__ void __launch_bounds__(kThreads, 1) em_refit_kernel(const Args a) {
  extern __shared__ float2 held[];
  __shared__ int warp_count[kWarps][kMaxStrokes];
  __shared__ float part[2][kWarps][kSums];
  // what the cluster's blocks store here, by rank, before a cluster
  // barrier: their inlier counts, and each step's sums (by step parity)
  __shared__ int peer_count[kMaxCluster][kMaxStrokes];
  __shared__ __align__(16) float peer_sum[2][kMaxCluster][kSums];

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  // this block has started: its wait before the first store into another
  // block's shared memory (step 3) finds every block started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  Stroke st[kMaxStrokes];
#pragma unroll
  for (int k = 0; k < kMaxStrokes; ++k) {
    if (k < a.S) {
      st[k] = load_stroke(a, k);
    } else {
      st[k] = Stroke{};
      st[k].active = false;
    }
  }
  const int groups = (a.M + kGroup - 1) / kGroup;
  const Walk walk = warp_walk(groups, blocks, rank, warp);

  // 1-2. select, and count
  int count[kMaxStrokes] = {};
  select_walk(a, st, walk, groups, lane, count);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < kMaxStrokes; ++k) warp_count[warp][k] = count[k];
  __syncthreads();

  // 3. where each warp's inliers go: the warps before it in the block, the
  // blocks before it in the cluster
  int at[kMaxStrokes], total[kMaxStrokes];
#pragma unroll
  for (int k = 0; k < kMaxStrokes; ++k) {
    int in_block;
    const int before = warp_scan(lane < kWarps ? warp_count[lane][k] : 0,
                                 lane, &in_block);
    at[k] = __shfl_sync(0xffffffffu, before, warp);
    total[k] = in_block;
  }
  // each block stores its counts into every block's table, then reads its
  // own after the barrier: no load crosses the cluster
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (warp == 0 && lane < blocks) {
    int* dst = cluster.map_shared_rank(&peer_count[rank][0],
                                       static_cast<unsigned>(lane));
#pragma unroll
    for (int k = 0; k < kMaxStrokes; ++k) dst[k] = total[k];
  }
  cluster.sync();
#pragma unroll
  for (int k = 0; k < kMaxStrokes; ++k) {
    const int before = warp_scan(lane < blocks ? peer_count[lane][k] : 0,
                                 lane, &total[k]);
    at[k] += __shfl_sync(0xffffffffu, before, rank);
  }
  gather_walk(a, st, walk, groups, lane, at);
  cluster.sync();

  // 4. this block's run of each list, and where the steps read it from
  const float2* src[kMaxStrokes];
  int mine[kMaxStrokes];
  int route = kShared, used = 0;
#pragma unroll
  for (int k = 0; k < kMaxStrokes; ++k) {
    const int share = (total[k] + blocks - 1) / blocks;
    const int first = min(total[k], rank * share);
    mine[k] = min(total[k], first + share) - first;
    src[k] = a.rel + static_cast<long long>(k) * a.M + first;
    if (share > kSmemInliers - used) route = kScratch;
    used += share;
  }
  if (route == kShared) {
    int off = 0;
#pragma unroll
    for (int k = 0; k < kMaxStrokes; ++k) {
      for (int i = threadIdx.x; i < mine[k]; i += kThreads)
        held[off + i] = __ldcg(src[k] + i);
      src[k] = held + off;
      off += (total[k] + blocks - 1) / blocks;
    }
    __syncthreads();
  }

  // 5. the Newton steps, on every thread of every block alike
  float lo[kMaxStrokes], hi[kMaxStrokes], theta[kMaxStrokes];
#pragma unroll
  for (int k = 0; k < kMaxStrokes; ++k) {
    lo[k] = -st[k].half;
    hi[k] = st[k].half;
    theta[k] = st[k].theta;
  }
  for (int it = 0; it < a.iters; ++it) {
    const int parity = it & 1;
    float v[kSums];
#pragma unroll
    for (int k = 0; k < kMaxStrokes; ++k) {
      // a thread's inliers i, i + T, ... in four running sums (j mod 4),
      // added in one order at the end
      float num[kLanes] = {}, den[kLanes] = {};
      if (st[k].active) {
        const float c = cosf(theta[k]), s = sinf(theta[k]);
        int i = threadIdx.x;
        for (; i + (kLanes - 1) * kThreads < mine[k]; i += kLanes * kThreads)
#pragma unroll
          for (int j = 0; j < kLanes; ++j)
            newton_terms(src[k][i + j * kThreads], c, s, lo[k], hi[k],
                         num[j], den[j]);
#pragma unroll
        for (int j = 0; j < kLanes - 1; ++j)
          if (i + j * kThreads < mine[k])
            newton_terms(src[k][i + j * kThreads], c, s, lo[k], hi[k],
                         num[j], den[j]);
      }
      v[2 * k] = (num[0] + num[1]) + (num[2] + num[3]);
      v[2 * k + 1] = (den[0] + den[1]) + (den[2] + den[3]);
    }
    warp_sum(v);
    if (lane == 0)
#pragma unroll
      for (int n = 0; n < kSums; ++n) part[parity][warp][n] = v[n];
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kSums; ++n)
      v[n] = lane < kWarps ? part[parity][lane][n] : 0.0f;
    warp_sum(v);
    // the block's sums stored into every block's table, then the cluster's
    // summed from the own table in rank order
    if (warp == 0 && lane < blocks)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(
          &peer_sum[parity][rank][0], static_cast<unsigned>(lane))) =
          make_float4(v[0], v[1], v[2], v[3]);
    cluster.sync();
#pragma unroll
    for (int n = 0; n < kSums; ++n)
      v[n] = lane < blocks ? peer_sum[parity][lane][n] : 0.0f;
    warp_sum(v);
#pragma unroll
    for (int k = 0; k < kMaxStrokes; ++k)
      if (st[k].active)
        theta[k] = theta[k] -
                   v[2 * k] / clamp_nan(v[2 * k + 1], 1e-9f, INFINITY);
  }
  // no block touches another's shared memory after the last barrier, so
  // each may leave when it is done

  // 6. the carry, by one thread
  if (rank == 0 && threadIdx.x == 0) {
    bool go = false;
#pragma unroll
    for (int k = 0; k < kMaxStrokes; ++k) {
      if (k >= a.S) break;
      float moved = 0.0f;
      if (st[k].active) {
        const Stroke& t = st[k];
        const float ax = cosf(theta[k]), ay = sinf(theta[k]);
        const float n1x = t.cmx + t.half * ax, n1y = t.cmy + t.half * ay;
        const float n2x = t.cmx - t.half * ax, n2y = t.cmy - t.half * ay;
        const float e1x = n1x - t.p1x, e1y = n1y - t.p1y;
        const float e2x = n2x - t.p2x, e2y = n2y - t.p2y;
        moved = max_nan(sqrtf(e1x * e1x + e1y * e1y),
                        sqrtf(e2x * e2x + e2y * e2y));
        float* e = a.s + 4 * k;
        e[0] = n1x;
        e[1] = n1y;
        e[2] = n2x;
        e[3] = n2y;
        if (a.stats) {
          a.stats[2 * k] = total[k];
          a.stats[2 * k + 1] = route;
        }
      }
      a.moved[k] = moved;
      go = go || moved > a.stable;
    }
    *a.go = go;
  }
}

cudaError_t configure() {
  // set at the first launch of each device
  static int configured = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || configured == device) return err;
  err = cudaFuncSetAttribute(em_refit_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(em_refit_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess) configured = device;
  return err;
}

cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
  cudaError_t err = configure();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, em_refit_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One refit round with the launch plan the wrapper computed
// (ops/em_refit.py::launch_plan): a cluster of `blocks` blocks of 512
// threads. The pointers, in order: pts [M, 2] (16-byte aligned),
// mask [M] (2-byte aligned), s [S, 2, 2], moved [S], go, stats [S, 2] (may
// be null), bits [S, ceil(M / 64), 2] and rel [S, M] (scratch of any
// contents). f: the inlier and stable thresholds. n: M, S, the Newton steps,
// blocks. Returns a CUDA error code; a plan or a buffer the kernel does not
// take is refused with cudaErrorInvalidValue.
extern "C" int hitl_em_refit(void* const* p, const float* f, const int* n,
                             void* stream) {
  const int M = n[0], S = n[1], iters = n[2], blocks = n[3];
  bool ok = M >= 1 && M <= kMaxSlots && S >= 1 && S <= kMaxStrokes &&
            iters >= 0 && blocks >= 1 && blocks <= kMaxCluster;
  static const int kRequired[] = {0, 1, 2, 3, 4, 6, 7};
  for (int k : kRequired) ok = ok && p[k] != nullptr;
  ok = ok && reinterpret_cast<uintptr_t>(p[0]) % 16 == 0 &&
       reinterpret_cast<uintptr_t>(p[1]) % 2 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(p[0]),
               static_cast<const uint8_t*>(p[1]),
               static_cast<float*>(p[2]),
               static_cast<float*>(p[3]),
               static_cast<bool*>(p[4]),
               static_cast<int*>(p[5]),
               static_cast<uint32_t*>(p[6]),
               static_cast<float2*>(p[7]),
               M, S, iters, f[0], f[1]};
  return static_cast<int>(launch(a, blocks, static_cast<cudaStream_t>(stream)));
}
