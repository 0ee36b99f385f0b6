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
// What bounds it on this card: bytes, and below them launch latency. One
// call reads P*N*(8 + 1) bytes (1.2 MB for 1024 poses x 128 points), a
// fraction of a microsecond at HBM rate, and does ~40 flops per point.
// The design keeps every intermediate in registers and writes only the
// counts and four minima: one warp per pose (8 poses per 256-thread block),
// lanes striding over the point axis with coalesced float2 loads; counts
// are summed as exact integers by warp shuffles; each block folds its four
// minima through shared memory and issues 4 atomicMin on the float bit
// pattern. Every value is >= 0 (or the 1e30 sentinel), so the int order of
// the bits is the float order and the result does not depend on the order
// in which blocks finish. The wrapper initialises the minima to 1e30.
//
// Exactness: this file is compiled with --fmad=false and every expression
// keeps the operation order of pallas_em.py:40-62, so each per-point d2 is
// bit-identical to the plain torch version's separate ops: counts are exact
// at the threshold and the minima are bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPosesPerBlock = 8;  // one warp per pose
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

__global__ void __launch_bounds__(kPosesPerBlock * kWarp)
em_scan_kernel(const float2* __restrict__ world,
               const uint8_t* __restrict__ mask,
               const float* __restrict__ sel, float t2, int P, int N,
               int* __restrict__ counts, int* __restrict__ min_bits) {
  __shared__ float smin[kPosesPerBlock][4];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int p = blockIdx.x * kPosesPerBlock + warp;

  float s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = sel[k];
  const Seg a = make_seg(s[0], s[1], s[2], s[3]);
  const Seg b = make_seg(s[4], s[5], s[6], s[7]);

  int ca = 0, cb = 0;
  float mn[4] = {kBig, kBig, kBig, kBig};
  if (p < P) {
    const float2* row = world + static_cast<size_t>(p) * N;
    const uint8_t* mrow = mask + static_cast<size_t>(p) * N;
    for (int j = lane; j < N; j += kWarp) {
      const float2 w = row[j];
      const bool m = mrow[j] != 0;
      ca += (m && seg_d2(a, w.x, w.y) < t2) ? 1 : 0;
      cb += (m && seg_d2(b, w.x, w.y) < t2) ? 1 : 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float ex = w.x - s[2 * k];
        const float ey = w.y - s[2 * k + 1];
        const float d2 = ex * ex + ey * ey;
        mn[k] = fminf(mn[k], m ? d2 : kBig);
      }
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    ca += __shfl_down_sync(0xffffffffu, ca, off);
    cb += __shfl_down_sync(0xffffffffu, cb, off);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      mn[k] = fminf(mn[k], __shfl_down_sync(0xffffffffu, mn[k], off));
  }
  if (lane == 0) {
    if (p < P) {
      counts[2 * p] = ca;
      counts[2 * p + 1] = cb;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) smin[warp][k] = mn[k];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int k = threadIdx.x;
    float v = smin[0][k];
#pragma unroll
    for (int w = 1; w < kPosesPerBlock; ++w) v = fminf(v, smin[w][k]);
    atomicMin(&min_bits[k], __float_as_int(v));
  }
}

}  // namespace

extern "C" int hitl_em_scan(const void* world, const void* mask,
                            const void* sel, float t2, int P, int N,
                            void* counts, void* min_d2, void* stream) {
  if (P <= 0) return 0;
  const dim3 grid((P + kPosesPerBlock - 1) / kPosesPerBlock);
  em_scan_kernel<<<grid, kPosesPerBlock * kWarp, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(world), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(sel), t2, P, N, static_cast<int*>(counts),
      static_cast<int*>(min_d2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hitl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
