// Device functions shared by the two Newton kernels (K3 newton_pyr.cu,
// K4 newton_generic.cu): the generic row penalties of MuJoCo's soft
// constraints, a two-value block reduction, and the regularised Cholesky
// solve for the Newton direction.  One block of kThreads threads works on
// one env; every function here is called by all threads of the block.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void penalty_se(float r, float D, float fl,
                                           float ones, float fric, float& g,
                                           float& c) {
  const float gq = D * r;
  const bool active = (r < 0.f) || (ones <= 0.f);
  const float lim = fric > 0.f ? fl : 1e30f;
  const bool inq = fabsf(gq) <= lim;
  const float sgn = r > 0.f ? 1.f : (r < 0.f ? -1.f : 0.f);
  g = inq ? gq : sgn * lim;
  c = inq ? D : 0.f;
  if (!active || (fric > 0.f && fl <= 0.f)) {
    g = 0.f;
    c = 0.f;
  }
}

__device__ __forceinline__ float penalty_cost(float r, float D, float fl,
                                              float ones, float fric) {
  const bool active = (r < 0.f) || (ones <= 0.f);
  const float lim = fric > 0.f ? fl : 1e30f;
  const bool inq = fabsf(D * r) <= lim;
  const float quad = 0.5f * D * r * r;
  const float tail = fl * fabsf(r) - 0.5f * fl * fl / fmaxf(D, 1e-12f);
  if (!active || (fric > 0.f && fl <= 0.f)) return 0.f;
  return inq ? quad : tail;
}

// sums of (a, b) over the block, returned to every thread
__device__ __forceinline__ void block_sum2(float& a, float& b, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    a += red[w];
    b += red[kWarps + w];
  }
}

// dx = -(H + reg I)^-1 grad for the block's nv x nv matrix H in shared
// memory, reg = 1e-6 max(diag H) + 1e-12 (scale-aware Tikhonov term).
// Right-looking Cholesky with the pivot clamped at 1e-12 and rsqrt, threads
// over the rows of one column, serial over columns; L[i][j] is left at
// H[i * nv + j] (i > j).  The two triangular solves run on one thread.  H
// and grad must be complete on entry (a barrier before the call); dx is
// complete on return.  dj, col, y are nv floats of scratch each.
__device__ __forceinline__ void regularized_newton_direction(
    float* H, int nv, const float* grad, float* dx, float* dj, float* col,
    float* y) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    float dmax = 0.f;  // max over H * eye, whose off-diagonal zeros count
    for (int a = 0; a < nv; ++a) dmax = fmaxf(dmax, H[a * nv + a]);
    const float reg = 1e-6f * dmax + 1e-12f;
    for (int a = 0; a < nv; ++a) H[a * nv + a] += reg;
  }
  __syncthreads();

  for (int j = 0; j < nv; ++j) {
    const float dj2 = fmaxf(H[j * nv + j], 1e-12f);
    const float inv = rsqrtf(dj2);
    for (int i = j + tid; i < nv; i += kThreads) col[i] = H[j * nv + i] * inv;
    if (tid == 0) dj[j] = dj2 * inv;
    __syncthreads();
    const int m = nv - j - 1;
    for (int p = tid; p < m * m; p += kThreads) {
      const int a = j + 1 + p / m, b = j + 1 + p % m;
      H[a * nv + b] -= col[b] * col[a];
    }
    for (int i = j + 1 + tid; i < nv; i += kThreads) H[i * nv + j] = col[i];
    __syncthreads();
  }
  if (tid == 0) {
    for (int i = 0; i < nv; ++i) y[i] = grad[i];
    for (int j = 0; j < nv; ++j) {
      const float yj = y[j] / dj[j];
      y[j] = yj;
      for (int i = j + 1; i < nv; ++i) y[i] -= H[i * nv + j] * yj;
    }
    for (int j = nv - 1; j >= 0; --j) {
      float t = 0.f;
      for (int i = j + 1; i < nv; ++i) t += H[i * nv + j] * col[i];
      col[j] = (y[j] - t) / dj[j];  // col now holds the solution
    }
    for (int a = 0; a < nv; ++a) dx[a] = -col[a];
  }
  __syncthreads();
}

}  // namespace
