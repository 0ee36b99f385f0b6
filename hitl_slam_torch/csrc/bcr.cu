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
// What bounds it on this card: latency, not bytes or flops. A solve at
// n = 1024 moves ~250 KB and does ~0.3 MFLOP, but its 2*log2(m) + log2(m)
// phases are serially dependent, each a few hundred dependent flops deep.
// The design is therefore a single thread block (up to 512 threads, more
// registers per thread than 1024 would leave) that runs the whole solve in
// ONE launch, with a __syncthreads() between phases instead of a kernel
// boundary:
//   - init: the block reads D, U, b once and lays them out as per-lane
//     planes (D, L = U[i-1]^T, U: 9 floats each; b: 3) in a global scratch
//     buffer, identity/zero padded to m lanes;
//   - each downward level runs one phase in which every odd lane computes
//     Dinv, Dinv L, Dinv U and Dinv b, then one phase in which every even
//     lane absorbs its two odd neighbours; eliminated lanes keep their
//     rows (and their Dinv), which is all back-substitution needs;
//   - the root lane solves, then each upward level recovers its odd lanes.
// The scratch buffer (63 floats per lane, 258 KB at m = 1024, 4 MB at
// m = 16384) stays resident in the 50 MB L2, so the exchange through it
// costs L2 latency. Staging the planes in shared memory, several blocks
// per solve, and tensor-core formulations are later work. Every n >= 1 is
// accepted: there is no size gate.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;

enum Plane {
  kD = 0,
  kL = 9,
  kU = 18,
  kB = 27,
  kDinv = 30,
  kDinvL = 39,
  kDinvU = 48,
  kDinvB = 57,
  kX = 60,
  kPlanes = 63  // scratch floats per lane (the wrapper allocates 63*m)
};

template <int K>
__device__ __forceinline__ void load(const float* ws, int plane, int m,
                                     int lane, float* o) {
#pragma unroll
  for (int k = 0; k < K; ++k) o[k] = ws[(plane + k) * m + lane];
}

template <int K>
__device__ __forceinline__ void store(float* ws, int plane, int m, int lane,
                                      const float* v) {
#pragma unroll
  for (int k = 0; k < K; ++k) ws[(plane + k) * m + lane] = v[k];
}

template <int K>
__device__ __forceinline__ void zero(float* o) {
#pragma unroll
  for (int k = 0; k < K; ++k) o[k] = 0.0f;
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

__global__ void __launch_bounds__(kMaxThreads)
bcr_kernel(const float* __restrict__ Din, const float* __restrict__ Uin,
           const float* __restrict__ bin, float* __restrict__ xout,
           float* ws, int n, int m) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // ---- lay out the padded planes ----
  for (int i = tid; i < m; i += nt) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      ws[(kD + k) * m + i] =
          i < n ? Din[i * 9 + k] : ((k % 4 == 0) ? 1.0f : 0.0f);
      ws[(kU + k) * m + i] = i < n - 1 ? Uin[i * 9 + k] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)  // L[i] = U[i-1]^T
        ws[(kL + 3 * r + c) * m + i] =
            (i >= 1 && i < n) ? Uin[(i - 1) * 9 + 3 * c + r] : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      ws[(kB + k) * m + i] = i < n ? bin[i * 3 + k] : 0.0f;
  }
  __syncthreads();

  int levels = 0;
  while ((1 << levels) < m) ++levels;

  // ---- downward elimination ----
  for (int k = 1; k <= levels; ++k) {
    const int h = 1 << (k - 1);
    const int s = 1 << k;
    const int cnt = m >> k;
    for (int j = tid; j < cnt; j += nt) {  // odd lanes: Dinv products
      const int o = j * s + h;
      float Dm[9], Di[9], X[9], T[9], b[3], tb[3];
      load<9>(ws, kD, m, o, Dm);
      inv3(Dm, Di);
      store<9>(ws, kDinv, m, o, Di);
      load<9>(ws, kL, m, o, X);
      mm3(Di, X, T);
      store<9>(ws, kDinvL, m, o, T);
      load<9>(ws, kU, m, o, X);
      mm3(Di, X, T);
      store<9>(ws, kDinvU, m, o, T);
      load<3>(ws, kB, m, o, b);
      mv3(Di, b, tb);
      store<3>(ws, kDinvB, m, o, tb);
    }
    __syncthreads();
    for (int j = tid; j < cnt; j += nt) {  // even lanes absorb neighbours
      const int e = j * s;
      const int l = e - h;  // left odd neighbour (none for e == 0)
      const int r = e + h;  // right odd neighbour (always < m)
      float Le[9], Ue[9], Nl[9], Nr[9], T[9], W[9], v[3], t3[3], w3[3];
      load<9>(ws, kL, m, e, Le);
      load<9>(ws, kU, m, e, Ue);
      // D_e <- D_e - L_e DinvU_l - U_e DinvL_r
      if (e > 0) load<9>(ws, kDinvU, m, l, Nl);
      else zero<9>(Nl);
      load<9>(ws, kDinvL, m, r, Nr);
      mm3(Le, Nl, T);
      mm3(Ue, Nr, W);
      load<9>(ws, kD, m, e, Nr);
#pragma unroll
      for (int q = 0; q < 9; ++q) Nr[q] = Nr[q] - T[q] - W[q];
      store<9>(ws, kD, m, e, Nr);
      // b_e <- b_e - L_e Dinvb_l - U_e Dinvb_r
      if (e > 0) load<3>(ws, kDinvB, m, l, v);
      else zero<3>(v);
      mv3(Le, v, t3);
      load<3>(ws, kDinvB, m, r, v);
      mv3(Ue, v, w3);
      load<3>(ws, kB, m, e, v);
#pragma unroll
      for (int q = 0; q < 3; ++q) v[q] = v[q] - t3[q] - w3[q];
      store<3>(ws, kB, m, e, v);
      // L_e <- -L_e DinvL_l ;  U_e <- -U_e DinvU_r
      if (e > 0) load<9>(ws, kDinvL, m, l, Nl);
      else zero<9>(Nl);
      mm3(Le, Nl, T);
#pragma unroll
      for (int q = 0; q < 9; ++q) T[q] = -T[q];
      store<9>(ws, kL, m, e, T);
      load<9>(ws, kDinvU, m, r, Nr);
      mm3(Ue, Nr, T);
#pragma unroll
      for (int q = 0; q < 9; ++q) T[q] = -T[q];
      store<9>(ws, kU, m, e, T);
    }
    __syncthreads();
  }

  // ---- root ----
  if (tid == 0) {
    float Dm[9], Di[9], b[3], x[3];
    load<9>(ws, kD, m, 0, Dm);
    inv3(Dm, Di);
    store<9>(ws, kDinv, m, 0, Di);
    load<3>(ws, kB, m, 0, b);
    mv3(Di, b, x);
    store<3>(ws, kX, m, 0, x);
  }
  __syncthreads();

  // ---- upward back-substitution ----
  for (int k = levels; k >= 1; --k) {
    const int h = 1 << (k - 1);
    const int s = 1 << k;
    const int cnt = m >> k;
    for (int j = tid; j < cnt; j += nt) {
      const int o = j * s + h;
      float X[9], xl[3], xr[3], b[3], t3[3], w3[3];
      load<3>(ws, kX, m, o - h, xl);
      if (o + h < m) load<3>(ws, kX, m, o + h, xr);
      else zero<3>(xr);
      load<9>(ws, kL, m, o, X);
      mv3(X, xl, t3);
      load<9>(ws, kU, m, o, X);
      mv3(X, xr, w3);
      load<3>(ws, kB, m, o, b);
#pragma unroll
      for (int q = 0; q < 3; ++q) b[q] = b[q] - t3[q] - w3[q];
      load<9>(ws, kDinv, m, o, X);
      mv3(X, b, t3);
      store<3>(ws, kX, m, o, t3);
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += nt)
#pragma unroll
    for (int k = 0; k < 3; ++k) xout[i * 3 + k] = ws[(kX + k) * m + i];
}

}  // namespace

extern "C" int hitl_bcr_solve(const void* D, const void* U, const void* b,
                              void* x, void* ws, int n, int m,
                              void* stream) {
  if (n <= 0) return 0;
  int threads = ((m / 2 + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  bcr_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(D), static_cast<const float*>(U),
      static_cast<const float*>(b), static_cast<float*>(x),
      static_cast<float*>(ws), n, m);
  return static_cast<int>(cudaGetLastError());
}
