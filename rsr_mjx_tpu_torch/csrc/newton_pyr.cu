// K3: pyramid-basis fixed-iteration Newton solve of MuJoCo's
// soft-constraint problem, for sm_90a.
//
// Replaces the Pallas TPU kernel _newton_kernel_pyr / newton_lanes_pyr_t
// (rsr_mjx_tpu/physics/linalg_kernels.py:500-828).
//
// Per env it minimises  1/2 (x-a0)^T M (x-a0) + sum_i s_i(J_i x - aref_i):
//   structured rows [equality | dof friction | limits]: Js (nv, Rs) with the
//     generic penalty (two-sided quadratic, Huber with friction loss, or
//     one-sided quadratic, by the row-kind masks);
//   contacts: the pyramid basis U (nv, (naxes+1) C) = [Jn | mu_1 A_1 | ...];
//     contact c's 2 naxes rows are Jn_c +- mu_i A_i_c, each a one-sided
//     quadratic with stiffness Dc[c].
// Fixed schedule: iters Newton steps, each with ls_iters 1-D Newton
// line-search steps.  Hessian H = M + J^T C J built from the lower triangle,
// Tikhonov term 1e-6 max(diag H) + 1e-12, Cholesky with the pivot clamped
// at 1e-12 and rsqrt, line-search step t clipped to [0, 4], and a monotone
// accept: the step is taken only when the cost change is < 0, so a NaN step
// is rejected.  Outputs x (nv), structured forces fs (Rs), contact forces
// fc grouped [axis, +-, contact] (2 naxes C) and qfrc = J^T f (nv).
//
// All arrays are float32 with the batch B in the trailing axis.
//
// What bounds it on the H100: fp32 arithmetic outside the tensor cores.
// Per env and iteration the Hessian alone is nv(nv+1)/2 (Rs + NU)
// multiply-adds (210 x 133 on cube-push), against ~12 KB of input per env.
//
// The row penalties, the block reduction and the regularised Cholesky
// direction are shared with K4 (newton_common.cuh).
//
// Design: one block (128 threads) per env.  J, U, W = U S, M and H live in
// shared memory (~26 KB on cube-push); threads run over rows for the
// matvecs, over (a, b) pairs for the Hessian and over rows within one
// column for the Cholesky, which is serial over columns; the triangular
// solves run on one thread (n = 20).  Line-search and cost sums are
// block-wide reductions.  No rows are padded: the TPU's 8-row and 128-lane
// tiles have no counterpart here.

#include <cuda_runtime.h>

#include "newton_common.cuh"

namespace {

// one-sided quadratic of a contact row: (s', s'')
__device__ __forceinline__ void con_se(float r, float Dc, float& g,
                                       float& c) {
  const float act = r < 0.f ? 1.f : 0.f;
  g = Dc * r * act;
  c = Dc * act;
}

struct Layout {
  int M, H, J, U, W, arefs, Ds, fls, onem, fricm, rs, jdx, sg, sc, arefU, rU,
      u, w, Dc, coef, x, a0, xa, grad, dx, mdx, dj, col, y, red, total;
  __host__ __device__ Layout(int nv, int Rs, int C, int naxes) {
    const int NU = (naxes + 1) * C;
    int o = 0;
    M = o; o += nv * nv;
    H = o; o += nv * nv;
    J = o; o += nv * Rs;
    U = o; o += nv * NU;
    W = o; o += nv * NU;
    arefs = o; o += Rs;
    Ds = o; o += Rs;
    fls = o; o += Rs;
    onem = o; o += Rs;
    fricm = o; o += Rs;
    rs = o; o += Rs;
    jdx = o; o += Rs;
    sg = o; o += Rs;
    sc = o; o += Rs;
    arefU = o; o += NU;
    rU = o; o += NU;
    u = o; o += NU;
    w = o; o += NU;
    Dc = o; o += C;
    coef = o; o += C * (1 + 2 * naxes);
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

__global__ void newton_pyr_kernel(
    const float* __restrict__ M_, const float* __restrict__ a0_,
    const float* __restrict__ x0_, const float* __restrict__ Js_,
    const float* __restrict__ arefs_, const float* __restrict__ Ds_,
    const float* __restrict__ fls_, const float* __restrict__ ones_,
    const float* __restrict__ fric_, const float* __restrict__ U_,
    const float* __restrict__ arefU_, const float* __restrict__ Dc_,
    float* __restrict__ x_out, float* __restrict__ fs_out,
    float* __restrict__ fc_out, float* __restrict__ qf_out, int nv, int Rs,
    int C, int naxes, int iters, int ls_iters, int B) {
  extern __shared__ float smem[];
  const Layout L(nv, Rs, C, naxes);
  const int NU = (naxes + 1) * C;
  float* M = smem + L.M;
  float* H = smem + L.H;
  float* J = smem + L.J;  // J[a * Rs + r]
  float* U = smem + L.U;  // U[a * NU + k]
  float* W = smem + L.W;
  float* arefs = smem + L.arefs;
  float* Ds = smem + L.Ds;
  float* fls = smem + L.fls;
  float* onem = smem + L.onem;
  float* fricm = smem + L.fricm;
  float* rs = smem + L.rs;
  float* jdx = smem + L.jdx;
  float* sg = smem + L.sg;
  float* sc = smem + L.sc;
  float* arefU = smem + L.arefU;
  float* rU = smem + L.rU;
  float* u = smem + L.u;
  float* w = smem + L.w;
  float* Dc = smem + L.Dc;
  float* coef = smem + L.coef;  // [S00 | S0i ... | Sii ...], each C
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
  for (int i = tid; i < nv * Rs; i += kThreads) J[i] = Js_[i * Bs + e];
  for (int i = tid; i < nv * NU; i += kThreads) U[i] = U_[i * Bs + e];
  for (int r = tid; r < Rs; r += kThreads) {
    arefs[r] = arefs_[r * Bs + e];
    Ds[r] = Ds_[r * Bs + e];
    fls[r] = fls_[r * Bs + e];
    onem[r] = ones_[r];
    fricm[r] = fric_[r];
  }
  for (int k = tid; k < NU; k += kThreads) arefU[k] = arefU_[k * Bs + e];
  for (int c = tid; c < C; c += kThreads) Dc[c] = Dc_[c * Bs + e];
  for (int a = tid; a < nv; a += kThreads) {
    x[a] = x0_[a * Bs + e];
    a0[a] = a0_[a * Bs + e];
  }
  __syncthreads();

  for (int r = tid; r < Rs; r += kThreads) {
    float s = 0.f;
    for (int a = 0; a < nv; ++a) s += J[a * Rs + r] * x[a];
    rs[r] = s - arefs[r];
  }
  for (int k = tid; k < NU; k += kThreads) {
    float s = 0.f;
    for (int a = 0; a < nv; ++a) s += U[a * NU + k] * x[a];
    rU[k] = s - arefU[k];
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // penalty derivatives: structured rows, then the contact basis
    for (int r = tid; r < Rs; r += kThreads)
      penalty_se(rs[r], Ds[r], fls[r], onem[r], fricm[r], sg[r], sc[r]);
    for (int c = tid; c < C; c += kThreads) {
      const float rn = rU[c];
      float wn = 0.f, s00 = 0.f;
      for (int i = 0; i < naxes; ++i) {
        const float ri = rU[(1 + i) * C + c];
        float gp, cp, gm, cm;
        con_se(rn + ri, Dc[c], gp, cp);
        con_se(rn - ri, Dc[c], gm, cm);
        wn = wn + (gp + gm);
        w[(1 + i) * C + c] = gp - gm;
        s00 = s00 + (cp + cm);
        coef[(1 + i) * C + c] = cp - cm;
        coef[(1 + naxes + i) * C + c] = cp + cm;
      }
      w[c] = wn;
      coef[c] = s00;
    }
    for (int a = tid; a < nv; a += kThreads) xa[a] = x[a] - a0[a];
    __syncthreads();

    // W = U S (per-contact 1+naxes basis blocks) and the gradient
    for (int idx = tid; idx < nv * C; idx += kThreads) {
      const int a = idx / C, c = idx % C;
      const float un = U[a * NU + c];
      float wn = coef[c] * un;
      for (int i = 0; i < naxes; ++i) {
        const float ui = U[a * NU + (1 + i) * C + c];
        const float s0i = coef[(1 + i) * C + c];
        const float sii = coef[(1 + naxes + i) * C + c];
        wn = wn + s0i * ui;
        W[a * NU + (1 + i) * C + c] = s0i * un + sii * ui;
      }
      W[a * NU + c] = wn;
    }
    for (int a = tid; a < nv; a += kThreads) {
      float g1 = 0.f, g2 = 0.f, g3 = 0.f;
      for (int b = 0; b < nv; ++b) g1 += M[a * nv + b] * xa[b];
      for (int r = 0; r < Rs; ++r) g2 += J[a * Rs + r] * sg[r];
      for (int k = 0; k < NU; ++k) g3 += U[a * NU + k] * w[k];
      grad[a] = g1 + g2 + g3;
    }
    __syncthreads();

    // H = M + J^T C J from the (a, b >= a) triangle, mirrored
    for (int p = tid; p < nv * nv; p += kThreads) {
      const int a = p / nv, b = p % nv;
      if (b < a) continue;
      float t1 = 0.f, t2 = 0.f;
      for (int r = 0; r < Rs; ++r) t1 += J[a * Rs + r] * (J[b * Rs + r] * sc[r]);
      for (int k = 0; k < NU; ++k) t2 += W[a * NU + k] * U[b * NU + k];
      const float t = t1 + t2;
      H[a * nv + b] = t + M[a * nv + b];
      if (b != a) H[b * nv + a] = t + M[b * nv + a];
    }
    __syncthreads();
    // Tikhonov term, Cholesky and dx = -H^-1 grad (newton_common.cuh)
    regularized_newton_direction(H, nv, grad, dx, dj, col, y);

    // directional quantities of the line search
    for (int a = tid; a < nv; a += kThreads) {
      float s = 0.f;
      for (int b = 0; b < nv; ++b) s += M[a * nv + b] * dx[b];
      mdx[a] = s;
    }
    for (int r = tid; r < Rs; r += kThreads) {
      float s = 0.f;
      for (int a = 0; a < nv; ++a) s += J[a * Rs + r] * dx[a];
      jdx[r] = s;
    }
    for (int k = tid; k < NU; k += kThreads) {
      float s = 0.f;
      for (int a = 0; a < nv; ++a) s += U[a * NU + k] * dx[a];
      u[k] = s;
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
      for (int r = tid; r < Rs; r += kThreads) {
        float g, c;
        penalty_se(rs[r] + t * jdx[r], Ds[r], fls[r], onem[r], fricm[r], g, c);
        p1 += g * jdx[r];
        p2 += c * jdx[r] * jdx[r];
      }
      for (int c = tid; c < C; c += kThreads) {
        const float un = u[c];
        const float rtn = rU[c] + t * un;
        for (int i = 0; i < naxes; ++i) {
          const float ui = u[(1 + i) * C + c];
          const float rti = rU[(1 + i) * C + c] + t * ui;
          const float jp = un + ui, jm = un - ui;
          float gp, cp, gm, cm;
          con_se(rtn + rti, Dc[c], gp, cp);
          con_se(rtn - rti, Dc[c], gm, cm);
          p1 += gp * jp + gm * jm;
          p2 += cp * jp * jp + cm * jm * jm;
        }
      }
      block_sum2(p1, p2, red);
      const float dphi = g0 + t * h0 + p1;
      const float ddphi = h0 + p2;
      t = fminf(fmaxf(t - dphi / fmaxf(ddphi, 1e-12f), 0.f), 4.f);
    }

    // monotone accept on the cost change
    float so = 0.f, sn = 0.f;
    for (int r = tid; r < Rs; r += kThreads) {
      so += penalty_cost(rs[r], Ds[r], fls[r], onem[r], fricm[r]);
      sn += penalty_cost(rs[r] + t * jdx[r], Ds[r], fls[r], onem[r], fricm[r]);
    }
    for (int c = tid; c < C; c += kThreads) {
      const float rn = rU[c];
      const float rtn = rn + t * u[c];
      for (int i = 0; i < naxes; ++i) {
        const float ri = rU[(1 + i) * C + c];
        const float rti = ri + t * u[(1 + i) * C + c];
        const float ro[2] = {rn + ri, rn - ri};
        const float rw[2] = {rtn + rti, rtn - rti};
        for (int s = 0; s < 2; ++s) {
          so += 0.5f * Dc[c] * ro[s] * ro[s] * (ro[s] < 0.f ? 1.f : 0.f);
          sn += 0.5f * Dc[c] * rw[s] * rw[s] * (rw[s] < 0.f ? 1.f : 0.f);
        }
      }
    }
    block_sum2(so, sn, red);
    const float delta = t * g0 + 0.5f * t * t * h0 + sn - so;
    if (delta < 0.f) {
      for (int a = tid; a < nv; a += kThreads) x[a] += t * dx[a];
      for (int r = tid; r < Rs; r += kThreads) rs[r] += t * jdx[r];
      for (int k = tid; k < NU; k += kThreads) rU[k] += t * u[k];
    }
    __syncthreads();
  }

  // forces at the solution and qfrc = Js^T fs + U^T wf
  for (int r = tid; r < Rs; r += kThreads) {
    float g, c;
    penalty_se(rs[r], Ds[r], fls[r], onem[r], fricm[r], g, c);
    sg[r] = -g;
    fs_out[r * Bs + e] = -g;
  }
  for (int c = tid; c < C; c += kThreads) {
    const float rn = rU[c];
    float wfn = 0.f;
    for (int i = 0; i < naxes; ++i) {
      const float ri = rU[(1 + i) * C + c];
      float gp, gm, unused;
      con_se(rn + ri, Dc[c], gp, unused);
      con_se(rn - ri, Dc[c], gm, unused);
      fc_out[((size_t)(2 * i) * C + c) * Bs + e] = -gp;
      fc_out[((size_t)(2 * i + 1) * C + c) * Bs + e] = -gm;
      wfn = wfn + (-gp) + (-gm);
      w[(1 + i) * C + c] = (-gp) - (-gm);
    }
    w[c] = wfn;
  }
  __syncthreads();
  for (int a = tid; a < nv; a += kThreads) {
    float q1 = 0.f, q2 = 0.f;
    for (int r = 0; r < Rs; ++r) q1 += J[a * Rs + r] * sg[r];
    for (int k = 0; k < NU; ++k) q2 += U[a * NU + k] * w[k];
    qf_out[a * Bs + e] = q1 + q2;
    x_out[a * Bs + e] = x[a];
  }
}

}  // namespace

extern "C" int newton_pyr_launch(
    const float* M, const float* a0, const float* x0, const float* Js,
    const float* arefs, const float* Ds, const float* fls, const float* ones,
    const float* fric, const float* U, const float* arefU, const float* Dc,
    float* x_out, float* fs_out, float* fc_out, float* qf_out, int nv, int Rs,
    int C, int naxes, int iters, int ls_iters, int B, cudaStream_t stream) {
  if (nv < 1 || nv > 32 || Rs < 1 || C < 1 || naxes < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Layout(nv, Rs, C, naxes).total * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        newton_pyr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  newton_pyr_kernel<<<B, kThreads, smem, stream>>>(
      M, a0, x0, Js, arefs, Ds, fls, ones, fric, U, arefU, Dc, x_out, fs_out,
      fc_out, qf_out, nv, Rs, C, naxes, iters, ls_iters, B);
  return (int)cudaGetLastError();
}
