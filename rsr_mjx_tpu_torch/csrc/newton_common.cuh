// Device functions shared by the two Newton kernels (K3 newton_pyr.cu,
// K4 newton_generic.cu), on top of lanes_common.cuh: a warp works on one
// env, a block holds E consecutive envs, loaded and stored with the env
// index fastest across neighbouring threads.
//
// Layout of one env's matrices in shared memory: the constraint Jacobian is
// kept transposed, Jt[k * nvp + a] (row k's nv coefficients contiguous,
// nvp = nv rounded up to 4, pads zero), so that a lane reads one row as
// float4s for J x products, neighbouring lanes read neighbouring dofs for
// J^T s products, and the Hessian walker reads 4 dofs of a row in one load.
// M and H have the odd row stride ldm = nv | 1, free of bank conflicts when
// lane a reads row a.
//
// This header holds: the generic row penalties of MuJoCo's soft
// constraints, the products of one env by its warp, the register-tiled
// Hessian walker and the regularised Newton direction (the Cholesky solve
// of lanes_common.cuh with its Tikhonov term).

#pragma once

#include <cuda_runtime.h>

#include "lanes_common.cuh"

namespace {

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

// -- products of one env, by its warp

// out[k] = Jt[k] . v - sub[k] (sub may be null) for k < n, lanes over rows;
// rows and v are nvp entries, 16-byte aligned, pads zero, summed in index
// order.  With NVP known at compile time v is read into registers once.
template <int NVP>
__device__ __forceinline__ void rows_dot(const float* Jt, const float* v,
                                         const float* sub, float* out, int n,
                                         int nvp, int lane) {
  if constexpr (NVP > 0) {
    float4 v4[NVP / 4];
#pragma unroll
    for (int q = 0; q < NVP / 4; ++q)
      v4[q] = reinterpret_cast<const float4*>(v)[q];
    for (int k = lane; k < n; k += 32) {
      const float4* row = reinterpret_cast<const float4*>(Jt + k * NVP);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NVP / 4; ++q) {
        const float4 r4 = row[q];
        s += r4.x * v4[q].x;
        s += r4.y * v4[q].y;
        s += r4.z * v4[q].z;
        s += r4.w * v4[q].w;
      }
      out[k] = sub ? s - sub[k] : s;
    }
  } else {
    for (int k = lane; k < n; k += 32) {
      float s = 0.f;
      for (int q = 0; q < nvp; q += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(Jt + k * nvp + q);
        const float4 v4 = *reinterpret_cast<const float4*>(v + q);
        s += r4.x * v4.x;
        s += r4.y * v4.y;
        s += r4.z * v4.z;
        s += r4.w * v4.w;
      }
      out[k] = sub ? s - sub[k] : s;
    }
  }
}

// J^T s for one env: sum_k Jt[k * nvp + a] * s[k].  The warp is cut into
// Q = nvp / 4 groups of four dofs times G = 32 / Q shares of the rows (nv 18
// and 20: 5 x 6, 30 lanes at work); a lane reads its four dofs of a row as
// one float4 and keeps four sums.  cols_partial leaves the G shares in
// part[g * nvp + a] (kPartWords floats, 16-byte aligned); after a
// __syncwarp(), cols_sum(part, nvp, a) adds them for dof a.
constexpr int kPartWords = 128;

__device__ __forceinline__ void cols_partial(const float* Jt, const float* s,
                                             int n, int nvp, float* part,
                                             int lane) {
  const int Q = nvp >> 2, G = 32 / Q;
  const int g = lane / Q, q = lane - g * Q;
  if (g >= G) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = Jt + 4 * q;
  for (int k = g; k < n; k += G) {
    const float4 j4 = *reinterpret_cast<const float4*>(p + k * nvp);
    const float sk = s[k];
    acc.x += j4.x * sk;
    acc.y += j4.y * sk;
    acc.z += j4.z * sk;
    acc.w += j4.w * sk;
  }
  *reinterpret_cast<float4*>(part + g * nvp + 4 * q) = acc;
}

__device__ __forceinline__ float cols_sum(const float* part, int nvp, int a) {
  const int G = 32 / (nvp >> 2);
  float t = 0.f;
  for (int g = 0; g < G; ++g) t += part[g * nvp + a];
  return t;
}

// sum_b M[a * ldm + b] * v[b]
__device__ __forceinline__ float mat_row_dot(const float* M, const float* v,
                                             int nv, int ldm, int a) {
  float t = 0.f;
  for (int b = 0; b < nv; ++b) t += M[a * ldm + b] * v[b];
  return t;
}

// -- the Hessian walker.  The lower triangle of H is cut into 4 x 4 tiles
// (T = nvp / 4 tile rows, T (T + 1) / 2 tiles); a lane owns one tile and
// one of KS interleaved shares of the columns, keeps the tile's 16 sums in
// registers and walks its columns once: two float4 loads feed 16
// multiply-adds.  KS is the largest of {4, 2, 1} with KS tiles <= 32 (nv 18
// and 20: 15 tiles, KS 2, 30 lanes at work); share h of tile t is lane
// h (32 / KS) + t, so that the lanes of one quarter-warp read the same row.
// With more than 32 tiles (KS 1) the warp takes several rounds.  The KS
// shares are added by shuffles, then the share-0 lane adds M and writes the
// tile's part of the lower triangle.

struct Tile {
  int ti, tj, h;
  bool active;
};

__host__ __device__ inline int tile_log_shares(int nvp) {
  const int T = nvp >> 2, ntiles = T * (T + 1) / 2;
  return 4 * ntiles <= 32 ? 2 : (2 * ntiles <= 32 ? 1 : 0);
}

// item = base + lane of a round; ntiles tiles, 1 << lks shares
__device__ __forceinline__ Tile tile_of(int item, int ntiles, int lks) {
  Tile t;
  const int slot = lks ? (item & ((32 >> lks) - 1)) : item;
  t.active = slot < ntiles;
  const int tile = t.active ? slot : 0;
  t.h = lks ? item >> (5 - lks) : 0;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
  t.ti = ti;
  t.tj = tile - ti * (ti + 1) / 2;
  return t;
}

// acc[r][c] += a[r] * b[c]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * bv[c];
}

__device__ __forceinline__ float4 scale4(const float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// rows k = h, h + KS, ... < n of Jt with curvature sc[k]: acc += (sc[k]
// J_k[rows of the tile]) J_k[columns of the tile]^T
__device__ __forceinline__ void tile_rows(float (&acc)[4][4], const Tile& t,
                                          const float* Jt, const float* sc,
                                          int n, int nvp, int KS) {
  const float* pa = Jt + 4 * t.ti;
  const float* pb = Jt + 4 * t.tj;
#pragma unroll 4  // the loads of four rows ahead of their multiply-adds
  for (int k = t.h; k < n; k += KS) {
    const float4 a4 = *reinterpret_cast<const float4*>(pa + k * nvp);
    const float4 b4 = *reinterpret_cast<const float4*>(pb + k * nvp);
    outer4(acc, scale4(a4, sc[k]), b4);
  }
}

// add the KS shares, then H[a][b] = acc + M[b][a] on the tile's part of the
// lower triangle (b <= a < nv); M's upper entry, as the plain version's
// Cholesky reads row j's entries i >= j
__device__ __forceinline__ void tile_finish(float (&acc)[4][4], const Tile& t,
                                            const float* M, float* H, int nv,
                                            int ldm, int KS) {
  for (int off = 32 / KS; off < 32; off <<= 1) {  // no stage at KS = 1
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] += __shfl_xor_sync(kFull, acc[r][c], off);
  }
  if (!t.active || t.h != 0) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int a = 4 * t.ti + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = 4 * t.tj + c;
      if (a < nv && b <= a) H[a * ldm + b] = acc[r][c] + M[b * ldm + a];
    }
  }
}

// -- dx = -(H + reg I)^-1 grad for one env's nv x nv matrix (lower triangle
// in shared memory, row stride ld), reg = 1e-6 max(diag H) + 1e-12, pivot
// clamp 1e-12: the Cholesky solve of lanes_common.cuh, in shared memory for
// a width at run time (dj and col are nv floats of scratch each) and in
// registers for a width NV <= 32 known at compile time.  H and grad must be
// complete on entry (a __syncwarp() before the call); dx is written for
// a < nv, visible after the caller's next __syncwarp().
__device__ __forceinline__ void warp_newton_direction(float* H, int ld, int nv,
                                                      const float* grad,
                                                      float* dx, float* dj,
                                                      float* col, int lane) {
  float y0, y1;
  warp_chol_solve<true>(H, ld, nv, grad, 1e-12f, dj, col, lane, y0, y1);
  if (lane < nv) dx[lane] = -y0;
  if (lane + 32 < nv) dx[lane + 32] = -y1;
}

template <int NV>
__device__ __forceinline__ void warp_newton_direction_reg(float* H, int ld,
                                                          const float* grad,
                                                          float* dx,
                                                          int lane) {
  const float y = warp_chol_solve_reg<NV, true>(H, ld, grad, 1e-12f, lane);
  if (lane < NV) dx[lane] = -y;
}

}  // namespace
