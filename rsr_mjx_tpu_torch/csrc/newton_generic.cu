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
// H = M + J^T diag(s'') J on the lower triangle; Tikhonov term
// 1e-6 max(diag H) + 1e-12; Cholesky with the pivot clamped at 1e-12 and
// rsqrt; t clipped to [0, 4] with the denominator floored at 1e-12; a
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
// Design (newton_common.cuh, shared with K3): a warp per env, E consecutive
// envs per block.  For the bytes: the block loads and stores with the env
// index fastest across neighbouring threads, so each 32-byte sector of the
// batch-minor arrays is used whole at E = 8 (a block of one env uses 4 bytes
// of each).  For the operations: the Hessian comes from 4 x 4 register
// tiles of its lower triangle, two float4 loads of J^T per 16
// multiply-adds, the tile's columns split over two lanes at nv 18 and 20
// so that 30 of 32 lanes work; the Cholesky has a lane per row and both
// triangular solves are column-oriented with a shuffle broadcast, nv steps
// each; the line search's sums are one pair of shuffle reductions per step.
// Nothing in the Newton loop passes a block barrier.  No tensor cores: the
// physics runs in true fp32 with TF32 off, and nv x R by R x nv per env is
// far from a wgmma tile.
//
// Shared memory per env, words: J^T R nvp, eight dof vectors of nvp, the
// 128 words of the J^T s shares, M and H nv ldm each (both stay: M is read
// by the gradient and the line search of every step), seven row vectors
// (nvp = nv rounded up to 4, ldm = nv | 1), at a stride rounded up to 4 mod
// 32; the two row masks once per block.  nv 18, R 58: 2538 words, 10256
// bytes per env, E = 8 in 82512 bytes, two blocks
// (16 envs, 16 warps) per SM.  nv 20, R 181: 6015 words, 24080 bytes, E = 8
// in 194088 bytes, one block (8 envs) per SM.  The launcher refuses a system
// whose working set at the given E exceeds the 232448 bytes a block may
// use; E = 1 takes any system whose single env fits, nv <= 64 (a lane owns
// rows i and i + 32 of H past nv 32).  The widths of the served paths (18,
// 20) are compiled in: loops unroll and the Cholesky keeps a lane's row of
// H in registers; any other width runs the same source with nv at run time
// and the Cholesky in shared memory.

#include <cuda_runtime.h>

#include "newton_common.cuh"

namespace {

// word offsets of one env's working set; J, the dof vectors and the row
// vectors' start are 16-byte aligned
struct Layout {
  int nvp, ldm, J, x, a0, xa, grad, dx, mdx, dj, col, part, M, H, aref, D, fl,
      r, jdx, sg, sc, words;
  __host__ __device__ Layout(int nv, int R) {
    nvp = round_up4(nv);
    ldm = nv | 1;
    int o = 0;
    J = o; o += R * nvp;
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
    aref = o; o += R;
    D = o; o += R;
    fl = o; o += R;
    r = o; o += R;
    jdx = o; o += R;
    sg = o; o += R;
    sc = o; o += R;
    words = o;
  }
  // bytes of a block of E envs: the envs and the two row masks
  __host__ __device__ size_t bytes(int E, int R) const {
    return sizeof(float) * ((size_t)E * env_stride(words, E) + 2 * (size_t)R);
  }
};

template <int NV>
__global__ void __launch_bounds__(256) newton_generic_kernel(
    const float* __restrict__ M_, const float* __restrict__ a0_,
    const float* __restrict__ x0_, const float* __restrict__ J_,
    const float* __restrict__ aref_, const float* __restrict__ D_,
    const float* __restrict__ fl_, const float* __restrict__ ones_,
    const float* __restrict__ fric_, float* __restrict__ x_out,
    float* __restrict__ f_out, float* __restrict__ qf_out, int nv_arg, int R,
    int iters, int ls_iters, int B, int logE) {
  extern __shared__ __align__(16) float smem[];
  const int nv = NV > 0 ? NV : nv_arg;  // NV > 0: the width at compile time
  constexpr int NVP = (NV + 3) & ~3;
  const Layout L(nv, R);
  const int nvp = L.nvp, ldm = L.ldm;
  const int E = 1 << logE, S = env_stride(L.words, E);
  const float* onem = smem + E * S;
  const float* fricm = onem + R;

  // -- load: env fastest across threads, transposed into env-major
  const BlockIo io(logE, S, B);
  io.load_mat(smem, L.M, M_, nv, nv, ldm, 1);
  io.load_mat(smem, L.J, J_, nv, R, 1, nvp);
  io.load_vec(smem, L.aref, aref_, R);
  io.load_vec(smem, L.D, D_, R);
  io.load_vec(smem, L.fl, fl_, R);
  io.load_vec(smem, L.x, x0_, nv);
  io.load_vec(smem, L.a0, a0_, nv);
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    smem[E * S + i] = ones_[i];
    smem[E * S + R + i] = fric_[i];
  }

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* s = smem + w * S;
  float* Jt = s + L.J;  // Jt[k * nvp + a]
  float* M = s + L.M;   // M[a * ldm + b]
  float* H = s + L.H;
  float* aref = s + L.aref;
  float* D = s + L.D;
  float* fl = s + L.fl;
  float* r = s + L.r;
  float* jdx = s + L.jdx;
  float* sg = s + L.sg;
  float* sc = s + L.sc;
  float* x = s + L.x;
  float* a0 = s + L.a0;
  float* xa = s + L.xa;
  float* grad = s + L.grad;
  float* dx = s + L.dx;
  float* mdx = s + L.mdx;
  float* dj = s + L.dj;
  float* col = s + L.col;
  float* part = s + L.part;

  // zero pads of the rows of J^T and of the vectors read as float4
  if (nvp != nv) {
    for (int k = lane; k < R; k += 32)
      for (int a = nv; a < nvp; ++a) Jt[k * nvp + a] = 0.f;
    if (lane < nvp - nv) {
      x[nv + lane] = 0.f;
      dx[nv + lane] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const bool valid = (size_t)blockIdx.x * E + w < (size_t)B;
  if (valid) {
    const int lks = tile_log_shares(nvp), KS = 1 << lks;
    const int T = nvp >> 2, ntiles = T * (T + 1) / 2;
    const int items = lks ? 32 : ntiles;  // one round unless KS = 1

    rows_dot<NVP>(Jt, x, aref, r, R, nvp, lane);
    __syncwarp();

    for (int it = 0; it < iters; ++it) {
      // penalty derivatives of every row
      for (int i = lane; i < R; i += 32)
        penalty_se(r[i], D[i], fl[i], onem[i], fricm[i], sg[i], sc[i]);
      for (int a = lane; a < nv; a += 32) xa[a] = x[a] - a0[a];
      __syncwarp();

      // gradient M (x - a0) + J^T s'
      cols_partial(Jt, sg, R, nvp, part, lane);
      __syncwarp();
      for (int a = lane; a < nv; a += 32)
        grad[a] = mat_row_dot(M, xa, nv, ldm, a) + cols_sum(part, nvp, a);
      // H = M + J^T diag(s'') J on the lower triangle, from register tiles
      for (int base = 0; base < items; base += 32) {
        const Tile t = tile_of(base + lane, ntiles, lks);
        float acc[4][4] = {};
        if (t.active) tile_rows(acc, t, Jt, sc, R, nvp, KS);
        tile_finish(acc, t, M, H, nv, ldm, KS);
      }
      __syncwarp();
      // Tikhonov term, Cholesky and dx = -H^-1 grad
      if constexpr (NV > 0)
        warp_newton_direction_reg<NV>(H, ldm, grad, dx, lane);
      else
        warp_newton_direction(H, ldm, nv, grad, dx, dj, col, lane);
      __syncwarp();

      // directional quantities of the line search
      for (int a = lane; a < nv; a += 32)
        mdx[a] = mat_row_dot(M, dx, nv, ldm, a);
      rows_dot<NVP>(Jt, dx, nullptr, jdx, R, nvp, lane);
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
        for (int i = lane; i < R; i += 32) {
          float g, c;
          penalty_se(r[i] + t * jdx[i], D[i], fl[i], onem[i], fricm[i], g, c);
          p1 += g * jdx[i];
          p2 += c * jdx[i] * jdx[i];
        }
        warp_sum2(p1, p2);
        const float dphi = g0 + t * h0 + p1;
        const float ddphi = h0 + p2;
        t = fminf(fmaxf(t - dphi / fmaxf(ddphi, 1e-12f), 0.f), 4.f);
      }

      // monotone accept on the cost change
      float so = 0.f, sn = 0.f;
      for (int i = lane; i < R; i += 32) {
        so += penalty_cost(r[i], D[i], fl[i], onem[i], fricm[i]);
        sn += penalty_cost(r[i] + t * jdx[i], D[i], fl[i], onem[i], fricm[i]);
      }
      warp_sum2(so, sn);
      const float delta = t * g0 + 0.5f * t * t * h0 + sn - so;
      if (delta < 0.f) {
        for (int a = lane; a < nv; a += 32) x[a] += t * dx[a];
        for (int i = lane; i < R; i += 32) r[i] += t * jdx[i];
      }
      __syncwarp();
    }

    // forces at the solution (staged in sg) and qfrc = J^T force (in grad)
    for (int i = lane; i < R; i += 32) {
      float g, c;
      penalty_se(r[i], D[i], fl[i], onem[i], fricm[i], g, c);
      sg[i] = -g;
    }
    __syncwarp();
    cols_partial(Jt, sg, R, nvp, part, lane);
    __syncwarp();
    for (int a = lane; a < nv; a += 32) grad[a] = cols_sum(part, nvp, a);
  }
  __syncthreads();

  // -- store: the same way out
  io.store_vec(smem, L.x, x_out, nv);
  io.store_vec(smem, L.sg, f_out, R);
  io.store_vec(smem, L.grad, qf_out, nv);
}

}  // namespace

// E envs per block (1, 2, 4 or 8), chosen by the caller.
extern "C" int newton_generic_launch(
    const float* M, const float* a0, const float* x0, const float* J,
    const float* aref, const float* D, const float* fl, const float* ones,
    const float* fric, float* x_out, float* f_out, float* qf_out, int nv,
    int R, int iters, int ls_iters, int B, int E, cudaStream_t stream) {
  if (nv < 1 || nv > 64 || R < 1 || B < 1 || iters < 0 || ls_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int logE = log2_envs(E);
  if (logE < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(nv, R).bytes(E, R);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  // the widths of the served paths at compile time, any other at run time
  auto kernel = nv == 18 ? newton_generic_kernel<18>
                         : (nv == 20 ? newton_generic_kernel<20>
                                     : newton_generic_kernel<0>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + E - 1) / E, 32 * E, smem, stream>>>(
      M, a0, x0, J, aref, D, fl, ones, fric, x_out, f_out, qf_out, nv, R,
      iters, ls_iters, B, logE);
  return (int)cudaGetLastError();
}
