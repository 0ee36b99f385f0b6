// EM selection sweep for Hopper (sm_90a).
//
// Replaces: hitl_slam_tpu/ops/pallas_em.py::_kernel (entry em_scan), the
// Pallas TPU kernel that streams the padded point map once and produces
//   - counts[p, 0|1]: masked points of pose p whose squared distance to
//     segment sel[0]-sel[1] (resp. sel[2]-sel[3]) is < t2, with the
//     projection parameter clamped to [0, 1] and the denominator clamped at
//     1e-20;
//   - min_d2[k]: the minimum over all masked points of the squared distance
//     to clicked point sel[k], masked points counting as 1e30.
//
// What bounds it on this card: bytes, and below them latency. One call
// reads P*N*(8 + 1) bytes (1.2 MB for 1024 poses x 128 points), about a
// third of a microsecond at HBM rate, and does ~60 flops per point, so the
// time is launch, two round trips to memory (the selection, the points) and
// the reduction. The design:
//   - ONE launch per call, with nothing to fill beforehand. Each block
//     writes its 4 minima as one 16-byte row of a per-call scratch that
//     needs no initial value, then draws a ticket from a counter with an
//     acquire-release atomicAdd; the block that draws the last ticket folds
//     every row into min_d2 and sets the counter back to 0. The wrapper
//     zeroes one counter per device and stream once and keeps it; every
//     call leaves it at 0. The min is order-independent, so the result
//     does not depend on the order in which blocks finish. The fold puts
//     three dependent round trips to L2 behind the last block (the row's
//     release, the ticket, the rows), about a microsecond, more the more
//     blocks draw tickets;
//   - 16-byte loads: the point map is cut into chunks of 4 points on
//     multiples of 4 of the flat point index, so a chunk is two float4 loads
//     of coordinates and one 32-bit word of mask bytes. A chunk that
//     straddles a row end (N not a multiple of 4) is read point by point,
//     with the points outside the row masked out. A lane's first chunk is
//     requested before the selection, so the two round trips overlap, and
//     each later chunk one step ahead of its use;
//   - a grid one wave deep: `lanes_per_pose` lanes (a power of two <= 32,
//     enough for one chunk each when N <= 128) share a pose, and a block of
//     8 warps holds 8 * 32 / lanes_per_pose poses, so P = 1024, N = 128
//     runs as 128 blocks of 256 threads, one on each of 128 of the 132 SMs.
//     Blocks of 4 to 6 warps (more blocks than SMs) measured no faster for
//     the sweep, which is latency-bound, and slower for the fold, where
//     more blocks contend for the ticket;
//   - counts are summed as exact integers by warp shuffles within each
//     pose's lanes.
//
// Exactness: this file is compiled with --fmad=false and every expression
// keeps the operation order of pallas_em.py:40-62, so each per-point d2 is
// bit-identical to the plain torch version's separate ops: counts are exact
// at the threshold and the minima are bit-equal.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr float kBig = 1e30f;

struct Seg {
  float x1, y1, dx, dy, denom;
};

__device__ __forceinline__ Seg make_seg(float x1, float y1, float x2,
                                        float y2) {
  Seg s;
  s.x1 = x1;
  s.y1 = y1;
  s.dx = x2 - x1;
  s.dy = y2 - y1;
  s.denom = fmaxf(s.dx * s.dx + s.dy * s.dy, 1e-20f);
  return s;
}

__device__ __forceinline__ float seg_d2(const Seg& s, float x, float y) {
  float t = ((x - s.x1) * s.dx + (y - s.y1) * s.dy) / s.denom;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  const float px = s.x1 + t * s.dx;
  const float py = s.y1 + t * s.dy;
  const float ex = x - px;
  const float ey = y - py;
  return ex * ex + ey * ey;
}

struct Sweep {
  Seg a, b;
  float sel[8];
  float t2;
  int ca = 0, cb = 0;
  float mn[4] = {kBig, kBig, kBig, kBig};

  __device__ __forceinline__ void point(float x, float y, bool m) {
    ca += (m && seg_d2(a, x, y) < t2) ? 1 : 0;
    cb += (m && seg_d2(b, x, y) < t2) ? 1 : 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float ex = x - sel[2 * k];
      const float ey = y - sel[2 * k + 1];
      const float d2 = ex * ex + ey * ey;
      mn[k] = fminf(mn[k], m ? d2 : kBig);
    }
  }
};

// The 4 points of chunk c (flat points 4c .. 4c+3) restricted to the row
// [q0, q1): coordinates, and one mask byte each that is 0 outside the row.
struct Chunk {
  float4 u, v;
  uint32_t m;
};

__device__ __forceinline__ Chunk load_chunk(const float* __restrict__ world,
                                            const uint8_t* __restrict__ mask,
                                            long long c, long long q0,
                                            long long q1) {
  Chunk k;
  const long long q = c << 2;
  if (q >= q0 && q + 4 <= q1) {
    k.u = __ldg(reinterpret_cast<const float4*>(world) + 2 * c);
    k.v = __ldg(reinterpret_cast<const float4*>(world) + 2 * c + 1);
    k.m = __ldg(reinterpret_cast<const uint32_t*>(mask) + c);
  } else {
    float w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    k.m = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (q + j >= q0 && q + j < q1) {
        w[2 * j] = world[2 * (q + j)];
        w[2 * j + 1] = world[2 * (q + j) + 1];
        k.m |= static_cast<uint32_t>(mask[q + j] != 0) << (8 * j);
      }
    }
    k.u = make_float4(w[0], w[1], w[2], w[3]);
    k.v = make_float4(w[4], w[5], w[6], w[7]);
  }
  return k;
}

__global__ void __launch_bounds__(kThreads)
em_scan_kernel(const float* __restrict__ world,
               const uint8_t* __restrict__ mask,
               const float* __restrict__ sel, float t2, int P, int N,
               int lanes_per_pose, int* __restrict__ counts,
               float* __restrict__ min_d2, float4* __restrict__ block_min,
               unsigned int* __restrict__ ticket) {
  __shared__ float smin[kWarps][4];
  __shared__ bool last;
  const int L = lanes_per_pose;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane & (L - 1);
  const int p = (blockIdx.x * kWarps + threadIdx.x / kWarp) * (kWarp / L) +
                lane / L;
  // flat points [q0, q1) of pose p, in chunks of 4 on multiples of 4
  const long long q0 = static_cast<long long>(p) * N;
  const long long q1 = q0 + N;
  const long long c_end = p < P ? (q1 + 3) >> 2 : 0;
  long long c = (q0 >> 2) + sub;
  Chunk next = {};
  if (c < c_end) next = load_chunk(world, mask, c, q0, q1);

  Sweep sw;
#pragma unroll
  for (int k = 0; k < 8; ++k) sw.sel[k] = sel[k];
  sw.a = make_seg(sw.sel[0], sw.sel[1], sw.sel[2], sw.sel[3]);
  sw.b = make_seg(sw.sel[4], sw.sel[5], sw.sel[6], sw.sel[7]);
  sw.t2 = t2;

  while (c < c_end) {
    const Chunk k = next;
    c += L;
    if (c < c_end) next = load_chunk(world, mask, c, q0, q1);
    sw.point(k.u.x, k.u.y, (k.m & 0xffu) != 0);
    sw.point(k.u.z, k.u.w, (k.m & 0xff00u) != 0);
    sw.point(k.v.x, k.v.y, (k.m & 0xff0000u) != 0);
    sw.point(k.v.z, k.v.w, (k.m & 0xff000000u) != 0);
  }

#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    if (off < L) {
      sw.ca += __shfl_down_sync(0xffffffffu, sw.ca, off, L);
      sw.cb += __shfl_down_sync(0xffffffffu, sw.cb, off, L);
    }
  }
  if (sub == 0 && p < P)
    reinterpret_cast<int2*>(counts)[p] = make_int2(sw.ca, sw.cb);

  // minima: over the warp, then the block, into the block's scratch row
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sw.mn[k] = fminf(sw.mn[k], __shfl_xor_sync(0xffffffffu, sw.mn[k], off));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 4; ++k) smin[threadIdx.x / kWarp][k] = sw.mn[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = smin[0][k];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v[k] = fminf(v[k], smin[w][k]);
    }
    block_min[blockIdx.x] = make_float4(v[0], v[1], v[2], v[3]);
    // release: the row is visible to whoever draws a later ticket;
    // acquire: the last block sees every earlier block's row
    last = cuda::atomic_ref<unsigned int, cuda::thread_scope_device>(*ticket)
               .fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: every row is written; fold them (all of a thread's
  // rows in flight at once), then over the warp and the warps
  float4 v = make_float4(kBig, kBig, kBig, kBig);
#pragma unroll 4
  for (int r = threadIdx.x; r < static_cast<int>(gridDim.x); r += kThreads) {
    const float4 w = __ldcg(block_min + r);
    v = make_float4(fminf(v.x, w.x), fminf(v.y, w.y), fminf(v.z, w.z),
                    fminf(v.w, w.w));
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v.x = fminf(v.x, __shfl_xor_sync(0xffffffffu, v.x, off));
    v.y = fminf(v.y, __shfl_xor_sync(0xffffffffu, v.y, off));
    v.z = fminf(v.z, __shfl_xor_sync(0xffffffffu, v.z, off));
    v.w = fminf(v.w, __shfl_xor_sync(0xffffffffu, v.w, off));
  }
  if (lane == 0) {
    smin[threadIdx.x / kWarp][0] = v.x;
    smin[threadIdx.x / kWarp][1] = v.y;
    smin[threadIdx.x / kWarp][2] = v.z;
    smin[threadIdx.x / kWarp][3] = v.w;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float w = smin[0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) w = fminf(w, smin[q][threadIdx.x]);
    min_d2[threadIdx.x] = w;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

// One sweep with the launch plan the wrapper computed (ops/em_scan.py::
// launch_plan): `blocks` blocks of 128 threads, `lanes_per_pose` lanes a
// pose. block_min is a 16-byte aligned scratch of 4 * blocks floats with
// any contents;
// ticket is a counter that holds 0 before the launch and again after it,
// used by no other launch at the same time. world must be 16-byte and mask
// 4-byte aligned. Returns a CUDA error code.
extern "C" int hitl_em_scan(const void* world, const void* mask,
                            const void* sel, float t2, int P, int N,
                            int lanes_per_pose, int blocks, void* counts,
                            void* min_d2, void* block_min, void* ticket,
                            void* stream) {
  const int L = lanes_per_pose;
  if (P < 0 || N < 0 || L < 1 || L > kWarp || (L & (L - 1)) != 0 ||
      blocks < 1 ||
      static_cast<long long>(blocks) * kWarps * (kWarp / L) < P)
    return static_cast<int>(cudaErrorInvalidValue);
  em_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(world), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(sel), t2, P, N, L, static_cast<int*>(counts),
      static_cast<float*>(min_d2), static_cast<float4*>(block_min),
      static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hitl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
