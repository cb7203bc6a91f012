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
// line-search steps.  Hessian H = M + J^T C J on the lower triangle,
// Tikhonov term 1e-6 max(diag H) + 1e-12, Cholesky with the pivot clamped
// at 1e-12 and rsqrt, line-search step t clipped to [0, 4] with the
// denominator floored at 1e-12, and a monotone accept: the step is taken
// only when the cost change is < 0, so a NaN step is rejected.  Outputs
// x (nv), structured forces fs (Rs), contact forces fc grouped
// [axis, +-, contact] (2 naxes C) and qfrc = J^T f (nv).
//
// All arrays are float32 with the batch B in the trailing axis.
//
// What bounds it on the H100: fp32 arithmetic outside the tensor cores.
// Per env and iteration the Hessian alone is nv(nv+1)/2 (Rs + NU)
// multiply-adds (210 x 133 on cube-push), against ~12 KB of input per env.
//
// Design (newton_common.cuh, shared with K4): a warp per env, E consecutive
// envs per block, loads and stores with the env index fastest across
// neighbouring threads.  The Hessian comes from 4 x 4 register tiles of its
// lower triangle (15 tiles at nv 20, each tile's columns split over two
// lanes): per structured row two float4 loads feed 16 multiply-adds; per
// contact the tile reads the 1 + naxes basis columns of its rows and of its
// columns, forms W = U S for its 4 columns from the 1 + 2 naxes
// coefficients in registers and adds the (1 + naxes) outer products, so W
// is never stored.  The Cholesky has a lane per row, both triangular solves
// are column-oriented with a shuffle broadcast; rows and contacts of the
// line search run over the lanes with one pair of shuffle reductions per
// step.  Nothing in the Newton loop passes a block barrier.  No tensor
// cores: the physics runs in true fp32 with TF32 off, and a 20 x 133 by
// 133 x 20 product per env is far from a wgmma tile.  No rows are padded:
// the TPU's 8-row and 128-lane tiles have no counterpart here.
//
// Shared memory per env, words: J^T Rs nvp, U^T NU nvp, eight dof vectors
// of nvp, the 128 words of the J^T s shares, M and H nv ldm each (both
// stay: M is read by the gradient and the line search of every step), seven
// structured-row vectors, four basis vectors, Dc and the 1 + 2 naxes
// coefficients per contact (nvp = nv rounded up to 4, ldm = nv | 1), at a
// stride rounded up to 4 mod 32; the two row masks once per block.  On
// cube-push (nv 20, Rs 37, C 24, naxes 3): 4623 words, 18576 bytes per env
// (W would add 7680), E = 8 in 148904 bytes, one block
// (8 envs, 8 warps) per SM; 2048 envs are two rounds of the 132 SMs at any
// E, since an SM holds at most 12 envs.  The launcher refuses a system whose
// working set at the given E exceeds the 232448 bytes a block may use.  The
// widths 18 and 20 with naxes = 3 (the pyramid of the elliptic cone with
// torsional friction, the served path's) are compiled in: loops unroll and
// the Cholesky keeps a lane's row of H in registers; any other system runs
// the same source with nv and naxes at run time and the Cholesky in shared
// memory.

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

// word offsets of one env's working set; J, U, the dof vectors and the
// structured-row vectors' start are 16-byte aligned
struct Layout {
  int nvp, ldm, NU, J, U, x, a0, xa, grad, dx, mdx, dj, col, part, M, H, arefs,
      Ds, fls, rs, jdx, sc, sg, w, arefU, rU, u, Dc, coef, words;
  __host__ __device__ Layout(int nv, int Rs, int C, int naxes) {
    nvp = round_up4(nv);
    ldm = nv | 1;
    NU = (naxes + 1) * C;
    int o = 0;
    J = o; o += Rs * nvp;
    U = o; o += NU * nvp;
    x = o; o += nvp;
    a0 = o; o += nvp;
    xa = o; o += nvp;
    grad = o; o += nvp;
    dx = o; o += nvp;
    mdx = o; o += nvp;
    dj = o; o += nvp;
    col = o; o += nvp;
    part = o; o += kPartWords;
    M = o; o += nv * ldm;
    H = o; o += nv * ldm;
    arefs = o; o += Rs;
    Ds = o; o += Rs;
    fls = o; o += Rs;
    rs = o; o += Rs;
    jdx = o; o += Rs;
    sc = o; o += Rs;
    sg = o; o += Rs;  // [sg | w] is one vector over the rows of [J^T | U^T]
    w = o; o += NU;
    arefU = o; o += NU;
    rU = o; o += NU;
    u = o; o += NU;
    Dc = o; o += C;
    coef = o; o += C * (1 + 2 * naxes);
    words = o;
  }
  __host__ __device__ size_t bytes(int E, int Rs) const {
    return sizeof(float) * ((size_t)E * env_stride(words, E) + 2 * (size_t)Rs);
  }
};

// contacts c = h, h + KS, ... < C of the basis U^T: acc += U_c[rows of the
// tile] (S_c U_c[columns of the tile])^T over the contact's 1 + naxes basis
// columns, S_c = [[S00, S0i ...], [S0i, Sii] ...] from coef
__device__ __forceinline__ void tile_contacts(float (&acc)[4][4],
                                              const Tile& t, const float* Ut,
                                              const float* coef, int C,
                                              int naxes, int nvp, int KS) {
  const float* pa = Ut + 4 * t.ti;
  const float* pb = Ut + 4 * t.tj;
  for (int c = t.h; c < C; c += KS) {
    const float4 an = *reinterpret_cast<const float4*>(pa + c * nvp);
    const float4 bn = *reinterpret_cast<const float4*>(pb + c * nvp);
    float4 wn = scale4(bn, coef[c]);
#pragma unroll  // whole when naxes is known at compile time
    for (int i = 0; i < naxes; ++i) {
      const int k = (1 + i) * C + c;
      const float4 ai = *reinterpret_cast<const float4*>(pa + k * nvp);
      const float4 bi = *reinterpret_cast<const float4*>(pb + k * nvp);
      const float s0i = coef[k];
      const float sii = coef[(1 + naxes + i) * C + c];
      wn.x += s0i * bi.x;
      wn.y += s0i * bi.y;
      wn.z += s0i * bi.z;
      wn.w += s0i * bi.w;
      const float4 wi = make_float4(s0i * bn.x + sii * bi.x,
                                    s0i * bn.y + sii * bi.y,
                                    s0i * bn.z + sii * bi.z,
                                    s0i * bn.w + sii * bi.w);
      outer4(acc, ai, wi);
    }
    outer4(acc, an, wn);
  }
}

template <int NV, int NAXES>
__global__ void __launch_bounds__(256) newton_pyr_kernel(
    const float* __restrict__ M_, const float* __restrict__ a0_,
    const float* __restrict__ x0_, const float* __restrict__ Js_,
    const float* __restrict__ arefs_, const float* __restrict__ Ds_,
    const float* __restrict__ fls_, const float* __restrict__ ones_,
    const float* __restrict__ fric_, const float* __restrict__ U_,
    const float* __restrict__ arefU_, const float* __restrict__ Dc_,
    float* __restrict__ x_out, float* __restrict__ fs_out,
    float* __restrict__ fc_out, float* __restrict__ qf_out, int nv_arg, int Rs,
    int C, int naxes_arg, int iters, int ls_iters, int B, int logE) {
  extern __shared__ __align__(16) float smem[];
  // NV, NAXES > 0: the width and the axes at compile time
  const int nv = NV > 0 ? NV : nv_arg;
  const int naxes = NAXES > 0 ? NAXES : naxes_arg;
  constexpr int NVP = (NV + 3) & ~3;
  const Layout L(nv, Rs, C, naxes);
  const int nvp = L.nvp, ldm = L.ldm, NU = L.NU;
  const int E = 1 << logE, S = env_stride(L.words, E);
  const float* onem = smem + E * S;
  const float* fricm = onem + Rs;

  // -- load: env fastest across threads, transposed into env-major
  const BlockIo io(logE, S, B);
  io.load_mat(smem, L.M, M_, nv, nv, ldm, 1);
  io.load_mat(smem, L.J, Js_, nv, Rs, 1, nvp);
  io.load_mat(smem, L.U, U_, nv, NU, 1, nvp);
  io.load_vec(smem, L.arefs, arefs_, Rs);
  io.load_vec(smem, L.Ds, Ds_, Rs);
  io.load_vec(smem, L.fls, fls_, Rs);
  io.load_vec(smem, L.arefU, arefU_, NU);
  io.load_vec(smem, L.Dc, Dc_, C);
  io.load_vec(smem, L.x, x0_, nv);
  io.load_vec(smem, L.a0, a0_, nv);
  for (int i = threadIdx.x; i < Rs; i += blockDim.x) {
    smem[E * S + i] = ones_[i];
    smem[E * S + Rs + i] = fric_[i];
  }

  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  float* s = smem + wp * S;
  float* Jt = s + L.J;  // Jt[r * nvp + a]
  float* Ut = s + L.U;  // Ut[k * nvp + a]
  float* M = s + L.M;   // M[a * ldm + b]
  float* H = s + L.H;
  float* arefs = s + L.arefs;
  float* Ds = s + L.Ds;
  float* fls = s + L.fls;
  float* rs = s + L.rs;
  float* jdx = s + L.jdx;
  float* sg = s + L.sg;
  float* sc = s + L.sc;
  float* arefU = s + L.arefU;
  float* rU = s + L.rU;
  float* u = s + L.u;
  float* w = s + L.w;
  float* Dc = s + L.Dc;
  float* coef = s + L.coef;  // [S00 | S0i ... | Sii ...], each C
  float* x = s + L.x;
  float* a0 = s + L.a0;
  float* xa = s + L.xa;
  float* grad = s + L.grad;
  float* dx = s + L.dx;
  float* mdx = s + L.mdx;
  float* dj = s + L.dj;
  float* col = s + L.col;
  float* part = s + L.part;

  // zero pads of the rows of J^T, U^T and of the vectors read as float4
  if (nvp != nv) {
    for (int k = lane; k < Rs + NU; k += 32)  // U^T follows J^T
      for (int a = nv; a < nvp; ++a) Jt[k * nvp + a] = 0.f;
    if (lane < nvp - nv) {
      x[nv + lane] = 0.f;
      dx[nv + lane] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const bool valid = (size_t)blockIdx.x * E + wp < (size_t)B;
  if (valid) {
    const int lks = tile_log_shares(nvp), KS = 1 << lks;
    const int T = nvp >> 2, ntiles = T * (T + 1) / 2;
    const int items = lks ? 32 : ntiles;  // one round unless KS = 1

    rows_dot<NVP>(Jt, x, arefs, rs, Rs, nvp, lane);
    rows_dot<NVP>(Ut, x, arefU, rU, NU, nvp, lane);
    __syncwarp();

    for (int it = 0; it < iters; ++it) {
      // penalty derivatives: structured rows, then the contact basis
      for (int r = lane; r < Rs; r += 32)
        penalty_se(rs[r], Ds[r], fls[r], onem[r], fricm[r], sg[r], sc[r]);
      for (int c = lane; c < C; c += 32) {
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
      for (int a = lane; a < nv; a += 32) xa[a] = x[a] - a0[a];
      __syncwarp();

      // gradient M (x - a0) + Js^T s' + U^T w
      cols_partial(Jt, sg, Rs + NU, nvp, part, lane);
      __syncwarp();
      for (int a = lane; a < nv; a += 32)
        grad[a] = mat_row_dot(M, xa, nv, ldm, a) + cols_sum(part, nvp, a);
      // H = M + J^T C J on the lower triangle, from register tiles
      for (int base = 0; base < items; base += 32) {
        const Tile t = tile_of(base + lane, ntiles, lks);
        float acc[4][4] = {};
        if (t.active) {
          tile_rows(acc, t, Jt, sc, Rs, nvp, KS);
          tile_contacts(acc, t, Ut, coef, C, naxes, nvp, KS);
        }
        tile_finish(acc, t, M, H, nv, ldm, KS);
      }
      __syncwarp();
      // Tikhonov term, Cholesky and dx = -H^-1 grad (newton_common.cuh)
      if constexpr (NV > 0)
        warp_newton_direction_reg<NV>(H, ldm, grad, dx, lane);
      else
        warp_newton_direction(H, ldm, nv, grad, dx, dj, col, lane);
      __syncwarp();

      // directional quantities of the line search
      for (int a = lane; a < nv; a += 32)
        mdx[a] = mat_row_dot(M, dx, nv, ldm, a);
      rows_dot<NVP>(Jt, dx, nullptr, jdx, Rs, nvp, lane);
      rows_dot<NVP>(Ut, dx, nullptr, u, NU, nvp, lane);
      __syncwarp();
      float g0 = 0.f, h0 = 0.f;
      for (int a = lane; a < nv; a += 32) {
        g0 += xa[a] * mdx[a];
        h0 += dx[a] * mdx[a];
      }
      warp_sum2(g0, h0);

      float t = 1.f;
      for (int ls = 0; ls < ls_iters; ++ls) {
        float p1 = 0.f, p2 = 0.f;
        for (int r = lane; r < Rs; r += 32) {
          float g, c;
          penalty_se(rs[r] + t * jdx[r], Ds[r], fls[r], onem[r], fricm[r], g,
                     c);
          p1 += g * jdx[r];
          p2 += c * jdx[r] * jdx[r];
        }
        for (int c = lane; c < C; c += 32) {
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
        warp_sum2(p1, p2);
        const float dphi = g0 + t * h0 + p1;
        const float ddphi = h0 + p2;
        t = fminf(fmaxf(t - dphi / fmaxf(ddphi, 1e-12f), 0.f), 4.f);
      }

      // monotone accept on the cost change
      float so = 0.f, sn = 0.f;
      for (int r = lane; r < Rs; r += 32) {
        so += penalty_cost(rs[r], Ds[r], fls[r], onem[r], fricm[r]);
        sn += penalty_cost(rs[r] + t * jdx[r], Ds[r], fls[r], onem[r],
                           fricm[r]);
      }
      for (int c = lane; c < C; c += 32) {
        const float rn = rU[c];
        const float rtn = rn + t * u[c];
        for (int i = 0; i < naxes; ++i) {
          const float ri = rU[(1 + i) * C + c];
          const float rti = ri + t * u[(1 + i) * C + c];
          const float ro[2] = {rn + ri, rn - ri};
          const float rw[2] = {rtn + rti, rtn - rti};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            so += 0.5f * Dc[c] * ro[q] * ro[q] * (ro[q] < 0.f ? 1.f : 0.f);
            sn += 0.5f * Dc[c] * rw[q] * rw[q] * (rw[q] < 0.f ? 1.f : 0.f);
          }
        }
      }
      warp_sum2(so, sn);
      const float delta = t * g0 + 0.5f * t * t * h0 + sn - so;
      if (delta < 0.f) {
        for (int a = lane; a < nv; a += 32) x[a] += t * dx[a];
        for (int r = lane; r < Rs; r += 32) rs[r] += t * jdx[r];
        for (int k = lane; k < NU; k += 32) rU[k] += t * u[k];
      }
      __syncwarp();
    }

    // forces at the solution: fs staged in sg, fc in coef (2 naxes C of its
    // (1 + 2 naxes) C words), qfrc = Js^T fs + U^T wf in grad
    for (int r = lane; r < Rs; r += 32) {
      float g, c;
      penalty_se(rs[r], Ds[r], fls[r], onem[r], fricm[r], g, c);
      sg[r] = -g;
    }
    for (int c = lane; c < C; c += 32) {
      const float rn = rU[c];
      float wfn = 0.f;
      for (int i = 0; i < naxes; ++i) {
        const float ri = rU[(1 + i) * C + c];
        float gp, gm, unused;
        con_se(rn + ri, Dc[c], gp, unused);
        con_se(rn - ri, Dc[c], gm, unused);
        coef[(2 * i) * C + c] = -gp;  // fc, grouped [axis, +-, contact]
        coef[(2 * i + 1) * C + c] = -gm;
        wfn = wfn + (-gp) + (-gm);
        w[(1 + i) * C + c] = (-gp) - (-gm);
      }
      w[c] = wfn;
    }
    __syncwarp();
    cols_partial(Jt, sg, Rs + NU, nvp, part, lane);
    __syncwarp();
    for (int a = lane; a < nv; a += 32) grad[a] = cols_sum(part, nvp, a);
  }
  __syncthreads();

  // -- store: the same way out
  io.store_vec(smem, L.x, x_out, nv);
  io.store_vec(smem, L.sg, fs_out, Rs);
  io.store_vec(smem, L.coef, fc_out, 2 * naxes * C);
  io.store_vec(smem, L.grad, qf_out, nv);
}

}  // namespace

// E envs per block (1, 2, 4 or 8), chosen by the caller.
extern "C" int newton_pyr_launch(
    const float* M, const float* a0, const float* x0, const float* Js,
    const float* arefs, const float* Ds, const float* fls, const float* ones,
    const float* fric, const float* U, const float* arefU, const float* Dc,
    float* x_out, float* fs_out, float* fc_out, float* qf_out, int nv, int Rs,
    int C, int naxes, int iters, int ls_iters, int B, int E,
    cudaStream_t stream) {
  if (nv < 1 || nv > 32 || Rs < 1 || C < 1 || naxes < 1 || B < 1 ||
      iters < 0 || ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int logE = log2_envs(E);
  if (logE < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(nv, Rs, C, naxes).bytes(E, Rs);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  // the widths of the served paths at compile time, any other at run time
  auto kernel = naxes != 3 ? newton_pyr_kernel<0, 0>
                : (nv == 18 ? newton_pyr_kernel<18, 3>
                            : (nv == 20 ? newton_pyr_kernel<20, 3>
                                        : newton_pyr_kernel<0, 0>));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + E - 1) / E, 32 * E, smem, stream>>>(
      M, a0, x0, Js, arefs, Ds, fls, ones, fric, U, arefU, Dc, x_out, fs_out,
      fc_out, qf_out, nv, Rs, C, naxes, iters, ls_iters, B, logE);
  return (int)cudaGetLastError();
}
