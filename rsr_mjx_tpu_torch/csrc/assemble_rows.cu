// K5: the generic route's contact rows (J, aref, D, floss) of the constraint
// assembly, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package's lanes assembly
// (rsr_mjx_tpu/physics/lanes_assembly.py) expands every contact into its
// pyramid rows with array operations that XLA fuses inside the step's jit;
// the port ran the same operations as eager ATen kernels, each over a full
// (contacts, nv, B) tensor, about 14 GB of traffic a substep on the Go2
// full-collision scene.  This kernel is that expansion in one pass.
//
// Per env and contact slot (a row of ``tab``: the slot read from the inputs,
// its first row after ``row0``, its condim) it writes:
//   condim 1: one row, the normal Jacobian Jn;
//   condim 3, 4, 6: 2 (condim - 1) rows Jn + mu_i a_i, Jn - mu_i a_i for the
//     axes a = t1, t2, torsion, roll1, roll2 (the first condim - 1), where
//     Jn, t1, t2 contract the translational Jacobian with the contact frame's
//     rows and torsion, roll1, roll2 the rotational one;
// and for each row aref = -b (J qvel) - k imp dist, D = 1 / R and floss 0,
// with imp, k, b from solimp and solref (MuJoCo's soft-constraint math) and
// R from imp and the contact's diagonal approximation (invweight, and for
// condim >= 3 2 mu_0^2 / impratio); aref and D are 0 where dist >= 0.
//
// Inputs (float32, batch B in the trailing axis; ``tab`` int32):
//   tab      (nc, 3)          slot, first row, condim of each contact
//   qvel     (nv, B)
//   cdof     (nv, 6, B)       rotational (0:3) and translational (3:6) motion
//   anchor   (nv, 3, B)       the point each cdof's translation refers to
//   dist     (ncon, B), pos (ncon, 3, B), frame (ncon, 9, B)
//   friction (ncon, 5, Bf), solref (ncon, 2, Bs), solimp (ncon, 5, Bi),
//   invw     (ncon, Bw), dmask (ncon, nv, Bd)
// Each B* is 1 (shared by every env: stride 0) or B (per env: stride 1).
// Outputs: J (nv, R, B), aref, D, floss (R, B); rows row0 + tab rows.
//
// Numerics: the operations of the plain version (linalg_kernels.
// assemble_rows_plain) in its order, each rounded on its own (__fmul_rn,
// __fadd_rn: no contraction into FMAs), so J is bit-equal to the plain
// version on the card; J qvel is summed over the dofs in order, where the
// plain version's torch.sum has an order of its own.
//
// What bounds it on the H100: the write of J.  On the full scene (156 slots,
// 324 contact rows of 366, nv 18) at B 8192 it writes 191 MB of J and
// reads and writes 104 MB else, 0.088 ms at 3.35 TB/s; its arithmetic,
// ~30 FLOPs per row and dof, is far from the fp32 peak.
//
// Design for that bound: 32 consecutive envs per block, the env index
// fastest across a warp's lanes, so that every store of one (dof, row)
// entry is one 128-byte run of the batch-minor J, and every read of a
// contact's data one such run too.  The block stages its envs' cdof, anchor
// and qvel (nv x 10 words an env) in shared memory once; its warps then take
// the contacts in turn, each contact's rows for all dofs in registers, the
// velocity sums in registers too, so J is written once and never read back.
// No block barrier past the staging; nothing is allocated, nothing synced.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kLanes = 32;     // envs per block
constexpr int kMaxWarps = 16;  // warps per block, splitting the contacts
constexpr int kWords = 10;     // staged words per dof and env
constexpr int kSmemLimit = 232448;

// float32 of the plain version's constants (constraint.py)
constexpr float kMinVal = static_cast<float>(1e-15);
constexpr float kMinImp = static_cast<float>(0.0001);
constexpr float kMaxImp = static_cast<float>(0.9999);

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp: a NaN passes through
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// constraint._impedance of one row
__device__ float impedance(const float si[5], float pos) {
  const float dmin = clamp2(si[0], kMinImp, kMaxImp);
  const float dmax = clamp2(si[1], kMinImp, kMaxImp);
  const float width = clamp_lo(si[2], kMinVal);
  const float mid = clamp2(si[3], kMinImp, kMaxImp);
  const float power = clamp_lo(si[4], 1.f);
  const float x = clamp2(dvd(fabsf(pos), width), 0.f, 1.f);
  const float pm1 = sub(power, 1.f);
  const float a = dvd(1.f, powf(mid, pm1));
  const float b = dvd(1.f, powf(sub(1.f, mid), pm1));
  const float y = x <= mid ? mul(a, powf(x, power))
                           : sub(1.f, mul(b, powf(sub(1.f, x), power)));
  return clamp2(add(dmin, mul(y, sub(dmax, dmin))), kMinImp, kMaxImp);
}

// constraint._kbi of one row; dmax is the raw solimp[1]
__device__ void kbi(float timeconst, float dampratio, float dmax, float& k,
                    float& b) {
  if (timeconst > 0.f) {
    const float tc = clamp_lo(timeconst, kMinVal);
    const float dr = clamp_lo(dampratio, kMinVal);
    const float p = mul(mul(mul(mul(mul(dmax, dmax), tc), tc), dr), dr);
    k = dvd(1.f, clamp_lo(p, kMinVal));
    b = mul(dvd(1.f, clamp_lo(mul(dmax, tc), kMinVal)), 2.f);
  } else {
    k = dvd(-timeconst, clamp_lo(mul(dmax, dmax), kMinVal));
    b = dvd(-dampratio, clamp_lo(dmax, kMinVal));
  }
}

// sum_k jac[k] * frame[off + k], as Python's sum() adds them from 0
__device__ __forceinline__ float contract(const float jac[3],
                                          const float f[9], int off) {
  return add(add(add(0.f, mul(jac[0], f[off])), mul(jac[1], f[off + 1])),
             mul(jac[2], f[off + 2]));
}

struct Args {
  const int* tab;
  const float *qvel, *cdof, *anchor, *dist, *pos, *frame;
  const float *fr, *sr, *si, *iw, *dm;
  float *J, *aref, *D, *fl;
  int nc, nv, R, row0, B;
  int Bf, Bs, Bi, Bw, Bd;
  float inv_imp;
};

// the rows of one contact in one env; NF friction axes (0 for condim 1)
template <int NF>
__device__ void contact(const Args& a, const float* __restrict__ stage,
                        int slot, int row, int e) {
  constexpr int NR = NF ? 2 * NF : 1;
  const size_t B = a.B;
  const float d = a.dist[slot * B + e];
  float p[3], f[9];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = a.pos[(slot * 3 + k) * B + e];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = a.frame[(slot * 9 + k) * B + e];
  const size_t ef = a.Bf > 1 ? e : 0;
  float mu[NF ? NF : 1];
  mu[0] = a.fr[(size_t)slot * 5 * a.Bf + ef];
#pragma unroll
  for (int i = 1; i < NF; ++i) mu[i] = a.fr[(slot * 5 + i) * (size_t)a.Bf + ef];
  const float* dm = a.dm + (size_t)slot * a.nv * a.Bd + (a.Bd > 1 ? e : 0);
  float* Jr = a.J + (size_t)(a.row0 + row) * B + e;
  const size_t Jv = (size_t)a.R * B;  // J's stride between dofs

  float vel[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) vel[r] = 0.f;
  for (int v = 0; v < a.nv; ++v) {
    const float* s = stage + v * kWords * kLanes;
    float ang[3], lin[3], anc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ang[k] = s[k * kLanes];
      lin[k] = s[(3 + k) * kLanes];
      anc[k] = s[(6 + k) * kLanes];
    }
    const float q = s[9 * kLanes];
    const float m = dm[(size_t)v * a.Bd];
    float jp[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
      const float t = add(lin[k], mul(ang[k1], sub(p[k2], anc[k2])));
      jp[k] = mul(sub(t, mul(ang[k2], sub(p[k1], anc[k1]))), m);
    }
    const float jn = contract(jp, f, 0);
    float* out = Jr + v * Jv;
    if constexpr (NF == 0) {
      out[0] = jn;
      vel[0] = add(vel[0], mul(jn, q));
    } else {
      float ax[NF];
      ax[0] = contract(jp, f, 3);
      if constexpr (NF > 1) ax[1] = contract(jp, f, 6);
      if constexpr (NF > 2) {
        float jr[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) jr[k] = mul(ang[k], m);
        ax[2] = contract(jr, f, 0);
        if constexpr (NF > 3) ax[3] = contract(jr, f, 3);
        if constexpr (NF > 4) ax[4] = contract(jr, f, 6);
      }
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const float t = mul(mu[i], ax[i]);
        const float hi = add(jn, t), lo = sub(jn, t);
        out[(2 * i) * B] = hi;
        out[(2 * i + 1) * B] = lo;
        vel[2 * i] = add(vel[2 * i], mul(hi, q));
        vel[2 * i + 1] = add(vel[2 * i + 1], mul(lo, q));
      }
    }
  }

  // the soft-constraint terms, shared by the contact's rows
  const size_t es = a.Bs > 1 ? e : 0, ei = a.Bi > 1 ? e : 0;
  float si[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) si[k] = a.si[(slot * 5 + k) * (size_t)a.Bi + ei];
  const float tc = a.sr[(size_t)slot * 2 * a.Bs + es];
  const float dr = a.sr[(slot * 2 + 1) * (size_t)a.Bs + es];
  const float w = a.iw[(size_t)slot * a.Bw + (a.Bw > 1 ? e : 0)];
  const float imp = impedance(si, d);
  float kk, bb;
  kbi(tc, dr, si[1], kk, bb);
  const float diag =
      NF ? mul(mul(mul(w, 2.f), clamp_lo(mul(mu[0], mu[0]), kMinVal)),
               a.inv_imp)
         : w;
  const float rreg = clamp_lo(
      mul(dvd(sub(1.f, imp), clamp_lo(imp, kMinVal)), diag), kMinVal);
  const bool off = d >= 0.f;
  const float Dr = off ? 0.f : dvd(1.f, rreg);
  const float kid = mul(mul(kk, imp), d);
  const size_t o = (size_t)(a.row0 + row) * B + e;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    a.aref[o + r * B] = off ? 0.f : sub(mul(-bb, vel[r]), kid);
    a.D[o + r * B] = Dr;
    a.fl[o + r * B] = 0.f;
  }
}

__global__ void __launch_bounds__(kLanes * kMaxWarps)
    assemble_rows_kernel(Args a) {
  extern __shared__ float stage[];  // [nv][kWords][kLanes]
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int warps = blockDim.x / kLanes;
  const int e0 = blockIdx.x * kLanes;
  const size_t B = a.B;

  // -- stage the block's cdof, anchor and qvel, env index fastest
  const int words = a.nv * kWords * kLanes;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int v = i / (kWords * kLanes), k = (i / kLanes) % kWords;
    const int e = e0 + i % kLanes;
    float x = 0.f;
    if (e < a.B) {
      x = k < 6 ? a.cdof[(v * 6 + k) * B + e]
                : (k < 9 ? a.anchor[(v * 3 + k - 6) * B + e]
                         : a.qvel[v * B + e]);
    }
    stage[i] = x;
  }
  __syncthreads();

  const int e = e0 + lane;
  if (e >= a.B) return;
  const float* st = stage + lane;
  for (int c = warp; c < a.nc; c += warps) {
    const int slot = a.tab[3 * c], row = a.tab[3 * c + 1];
    switch (a.tab[3 * c + 2]) {
      case 1: contact<0>(a, st, slot, row, e); break;
      case 3: contact<2>(a, st, slot, row, e); break;
      case 4: contact<3>(a, st, slot, row, e); break;
      case 6: contact<5>(a, st, slot, row, e); break;
      default: break;  // the wrapper admits no other condim
    }
  }
}

}  // namespace

extern "C" int assemble_rows_launch(
    const int* tab, const float* qvel, const float* cdof, const float* anchor,
    const float* dist, const float* pos, const float* frame,
    const float* friction, const float* solref, const float* solimp,
    const float* invw, const float* dmask, float* J, float* aref, float* D,
    float* floss, int nc, int nv, int R, int row0, int B, int Bf, int Bs,
    int Bi, int Bw, int Bd, float inv_impratio, cudaStream_t stream) {
  if (nc < 1 || nv < 1 || nv > 64 || B < 1 || row0 < 0 || R < row0)
    return (int)cudaErrorInvalidValue;
  const int env_dims[5] = {Bf, Bs, Bi, Bw, Bd};
  for (int b : env_dims)
    if (b != 1 && b != B) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * nv * kWords * kLanes;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a{tab,  qvel, cdof, anchor, dist, pos, frame, friction, solref,
         solimp, invw, dmask, J, aref, D, floss, nc, nv, R, row0, B,
         Bf,   Bs,   Bi,   Bw,     Bd,   inv_impratio};
  const int warps = nc < kMaxWarps ? nc : kMaxWarps;
  assemble_rows_kernel<<<(B + kLanes - 1) / kLanes, kLanes * warps, smem,
                         stream>>>(a);
  return (int)cudaGetLastError();
}
