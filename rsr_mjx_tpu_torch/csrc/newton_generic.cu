// K4: generic-row fixed-iteration Newton solve of MuJoCo's soft-constraint
// problem, for sm_90a.
//
// Replaces the Pallas TPU kernel _newton_kernel / _newton_lanes_core
// (rsr_mjx_tpu/physics/linalg_kernels.py:247-358, :878-974): the solve of
// every model whose contacts are expanded into constraint rows, which is
// every model without top-k contact selection (the Go2 family).
//
// Per env it minimises  1/2 (x-a0)^T M (x-a0) + sum_i s_i(J_i x - aref_i)
// over R rows J (nv, R), each with the penalty of its static kind, given as
// two row masks: equality rows two-sided quadratic (ones = 0, fric = 0),
// dof-friction rows Huber with bound floss, inert when floss <= 0
// (fric = 1), limit and contact rows quadratic on r < 0 only (ones = 1).
// Fixed schedule: iters Newton steps, each with ls_iters exact 1-D Newton
// steps on phi(t) from t = 1.  Gradient M(x-a0) + J^T s'; Hessian
// H = M + J^T diag(s'') J from the (a, b >= a) triangle, mirrored; Tikhonov
// term 1e-6 max(diag H) + 1e-12; Cholesky with the pivot clamped at 1e-12
// and rsqrt; t clipped to [0, 4] with the denominator floored at 1e-12; a
// monotone accept: the step is taken only when the cost change is < 0, so
// a NaN step is rejected; the residual r = J x - aref is carried.  Outputs
// x (nv), force = -s'(r) (R) and qfrc = J^T force (nv).
//
// All arrays are float32 with the batch B in the trailing axis.
//
// What bounds it on the H100: at the Go2 schedule (1 x 5, nv 18, R 58) the
// bytes, ~6 KB read once per env against ~30 kFLOP; at a 6 x 6 schedule on
// wide systems (nv 20, R 181) the fp32 arithmetic outside the tensor cores,
// nv(nv+1)/2 R multiply-adds per Hessian.
//
// Design: one block (128 threads) per env.  J, M and H live in shared
// memory (~10 KB on Go2); threads run over rows for the matvecs, over
// (a, b) pairs for the Hessian and over rows within one column for the
// Cholesky (newton_common.cuh, shared with K3).  Line-search and cost sums
// are block-wide reductions.  Rows are not padded to 8 with inert friction
// rows and the batch is not padded to 128 with identity systems, as the
// TPU wrapper did.  The launcher refuses a system whose working set
// exceeds the 227 KB of shared memory a block may use.

#include <cuda_runtime.h>

#include "newton_common.cuh"

namespace {

struct Layout {
  int M, H, J, aref, D, fl, onem, fricm, r, jdx, sg, sc, x, a0, xa, grad, dx,
      mdx, dj, col, y, red, total;
  __host__ __device__ Layout(int nv, int R) {
    int o = 0;
    M = o; o += nv * nv;
    H = o; o += nv * nv;
    J = o; o += nv * R;
    aref = o; o += R;
    D = o; o += R;
    fl = o; o += R;
    onem = o; o += R;
    fricm = o; o += R;
    r = o; o += R;
    jdx = o; o += R;
    sg = o; o += R;
    sc = o; o += R;
    x = o; o += nv;
    a0 = o; o += nv;
    xa = o; o += nv;
    grad = o; o += nv;
    dx = o; o += nv;
    mdx = o; o += nv;
    dj = o; o += nv;
    col = o; o += nv;
    y = o; o += nv;
    red = o; o += 2 * kWarps;
    total = o;
  }
};

__global__ void newton_generic_kernel(
    const float* __restrict__ M_, const float* __restrict__ a0_,
    const float* __restrict__ x0_, const float* __restrict__ J_,
    const float* __restrict__ aref_, const float* __restrict__ D_,
    const float* __restrict__ fl_, const float* __restrict__ ones_,
    const float* __restrict__ fric_, float* __restrict__ x_out,
    float* __restrict__ f_out, float* __restrict__ qf_out, int nv, int R,
    int iters, int ls_iters, int B) {
  extern __shared__ float smem[];
  const Layout L(nv, R);
  float* M = smem + L.M;
  float* H = smem + L.H;
  float* J = smem + L.J;  // J[a * R + r]
  float* aref = smem + L.aref;
  float* D = smem + L.D;
  float* fl = smem + L.fl;
  float* onem = smem + L.onem;
  float* fricm = smem + L.fricm;
  float* r = smem + L.r;
  float* jdx = smem + L.jdx;
  float* sg = smem + L.sg;
  float* sc = smem + L.sc;
  float* x = smem + L.x;
  float* a0 = smem + L.a0;
  float* xa = smem + L.xa;
  float* grad = smem + L.grad;
  float* dx = smem + L.dx;
  float* mdx = smem + L.mdx;
  float* dj = smem + L.dj;
  float* col = smem + L.col;
  float* y = smem + L.y;
  float* red = smem + L.red;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t Bs = (size_t)B;

  for (int i = tid; i < nv * nv; i += kThreads) M[i] = M_[i * Bs + e];
  for (int i = tid; i < nv * R; i += kThreads) J[i] = J_[i * Bs + e];
  for (int i = tid; i < R; i += kThreads) {
    aref[i] = aref_[i * Bs + e];
    D[i] = D_[i * Bs + e];
    fl[i] = fl_[i * Bs + e];
    onem[i] = ones_[i];
    fricm[i] = fric_[i];
  }
  for (int a = tid; a < nv; a += kThreads) {
    x[a] = x0_[a * Bs + e];
    a0[a] = a0_[a * Bs + e];
  }
  __syncthreads();

  for (int i = tid; i < R; i += kThreads) {
    float s = 0.f;
    for (int a = 0; a < nv; ++a) s += J[a * R + i] * x[a];
    r[i] = s - aref[i];
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // penalty derivatives of every row
    for (int i = tid; i < R; i += kThreads)
      penalty_se(r[i], D[i], fl[i], onem[i], fricm[i], sg[i], sc[i]);
    for (int a = tid; a < nv; a += kThreads) xa[a] = x[a] - a0[a];
    __syncthreads();

    // gradient M (x - a0) + J^T s'
    for (int a = tid; a < nv; a += kThreads) {
      float g1 = 0.f, g2 = 0.f;
      for (int b = 0; b < nv; ++b) g1 += M[a * nv + b] * xa[b];
      for (int i = 0; i < R; ++i) g2 += J[a * R + i] * sg[i];
      grad[a] = g1 + g2;
    }
    // H = M + J^T diag(s'') J from the (a, b >= a) triangle, mirrored
    for (int p = tid; p < nv * nv; p += kThreads) {
      const int a = p / nv, b = p % nv;
      if (b < a) continue;
      float t = 0.f;
      for (int i = 0; i < R; ++i) t += J[a * R + i] * (J[b * R + i] * sc[i]);
      H[a * nv + b] = t + M[a * nv + b];
      if (b != a) H[b * nv + a] = t + M[b * nv + a];
    }
    __syncthreads();
    // Tikhonov term, Cholesky and dx = -H^-1 grad
    regularized_newton_direction(H, nv, grad, dx, dj, col, y);

    // directional quantities of the line search
    for (int a = tid; a < nv; a += kThreads) {
      float s = 0.f;
      for (int b = 0; b < nv; ++b) s += M[a * nv + b] * dx[b];
      mdx[a] = s;
    }
    for (int i = tid; i < R; i += kThreads) {
      float s = 0.f;
      for (int a = 0; a < nv; ++a) s += J[a * R + i] * dx[a];
      jdx[i] = s;
    }
    __syncthreads();
    float g0 = 0.f, h0 = 0.f;
    for (int a = 0; a < nv; ++a) {
      g0 += xa[a] * mdx[a];
      h0 += dx[a] * mdx[a];
    }

    float t = 1.f;
    for (int ls = 0; ls < ls_iters; ++ls) {
      float p1 = 0.f, p2 = 0.f;
      for (int i = tid; i < R; i += kThreads) {
        float g, c;
        penalty_se(r[i] + t * jdx[i], D[i], fl[i], onem[i], fricm[i], g, c);
        p1 += g * jdx[i];
        p2 += c * jdx[i] * jdx[i];
      }
      block_sum2(p1, p2, red);
      const float dphi = g0 + t * h0 + p1;
      const float ddphi = h0 + p2;
      t = fminf(fmaxf(t - dphi / fmaxf(ddphi, 1e-12f), 0.f), 4.f);
    }

    // monotone accept on the cost change
    float so = 0.f, sn = 0.f;
    for (int i = tid; i < R; i += kThreads) {
      so += penalty_cost(r[i], D[i], fl[i], onem[i], fricm[i]);
      sn += penalty_cost(r[i] + t * jdx[i], D[i], fl[i], onem[i], fricm[i]);
    }
    block_sum2(so, sn, red);
    const float delta = t * g0 + 0.5f * t * t * h0 + sn - so;
    if (delta < 0.f) {
      for (int a = tid; a < nv; a += kThreads) x[a] += t * dx[a];
      for (int i = tid; i < R; i += kThreads) r[i] += t * jdx[i];
    }
    __syncthreads();
  }

  // forces at the solution and qfrc = J^T force
  for (int i = tid; i < R; i += kThreads) {
    float g, c;
    penalty_se(r[i], D[i], fl[i], onem[i], fricm[i], g, c);
    sg[i] = -g;
    f_out[i * Bs + e] = -g;
  }
  __syncthreads();
  for (int a = tid; a < nv; a += kThreads) {
    float q = 0.f;
    for (int i = 0; i < R; ++i) q += J[a * R + i] * sg[i];
    qf_out[a * Bs + e] = q;
    x_out[a * Bs + e] = x[a];
  }
}

}  // namespace

extern "C" int newton_generic_launch(
    const float* M, const float* a0, const float* x0, const float* J,
    const float* aref, const float* D, const float* fl, const float* ones,
    const float* fric, float* x_out, float* f_out, float* qf_out, int nv,
    int R, int iters, int ls_iters, int B, cudaStream_t stream) {
  if (nv < 1 || nv > 64 || R < 1 || B < 1 || iters < 0 || ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Layout(nv, R).total * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        newton_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  newton_generic_kernel<<<B, kThreads, smem, stream>>>(
      M, a0, x0, J, aref, D, fl, ones, fric, x_out, f_out, qf_out, nv, R,
      iters, ls_iters, B);
  return (int)cudaGetLastError();
}
