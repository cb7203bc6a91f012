// Device functions shared by the two Newton kernels (K3 newton_pyr.cu,
// K4 newton_generic.cu).
//
// One warp works on one env; a block holds E consecutive envs (E in
// {1, 2, 4, 8}, 32 E threads).  The block loads its envs' systems with the
// env index fastest across neighbouring threads, so that element i of the
// E envs is one run of 4 E bytes of the batch-minor arrays, and stores
// each env's system env-major in shared memory (per-env stride = 4 mod 32
// words).  After that load an env's stages are ordered by __syncwarp() and
// its sums are shuffle reductions returned to every lane; no block barrier
// is passed until the outputs, staged in shared memory, leave the same way.
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
// constraints, the warp reductions, the coalesced transposing loads and
// stores, the register-tiled Hessian walker and the regularised Cholesky
// direction inside a warp.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;  // bytes one block may use on sm_90

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

// -- warp reductions, the result returned to every lane (bitwise the same
// on every lane: each butterfly stage adds the same two values on both
// sides, so branches taken on a sum are uniform across the warp)

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(kFull, a, off);
    b += __shfl_xor_sync(kFull, b, off);
  }
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
  return a;
}

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// per-env stride in words for a working set of `words` in a block of E
// envs: the next value that is 4 mod 32, so that the E envs' copies of one
// element fall into different banks and float4 reads stay aligned; a
// single env is only rounded up to 4
__host__ __device__ inline int env_stride(int words, int E) {
  return E == 1 ? round_up4(words) : ((words + 27) / 32) * 32 + 4;
}

// -- block-level loads and stores (all 32 E threads; el = the env within
// the block, fastest across threads; nvalid = envs of this block inside B).
// A load is a 4-byte cp.async per element: a thread keeps all its copies
// in flight at once and spends no registers on them; cp_async_wait_all()
// and a block barrier follow the last load.

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct BlockIo {
  int el, j, nvalid, S;
  size_t B, e0;
  __device__ BlockIo(int logE, int S_, int B_) : S(S_), B((size_t)B_) {
    const int E = 1 << logE;
    el = threadIdx.x & (E - 1);
    j = threadIdx.x >> logE;  // 0..31
    e0 = (size_t)blockIdx.x * E;
    const long left = (long)B_ - (long)e0;
    nvalid = left < E ? (int)left : E;
  }
  // g (n, B) -> smem[el * S + off + i]
  __device__ __forceinline__ void load_vec(float* smem, int off,
                                           const float* __restrict__ g,
                                           int n) const {
    if (el >= nvalid) return;
    float* dst = smem + el * S + off;
    const float* src = g + e0 + el;
    for (int i = j; i < n; i += 32) cp_async4(dst + i, src + (size_t)i * B);
  }
  // g (nrow, ncol, B) -> smem[el * S + off + a * sa + k * sk]: rows kept
  // with (sa, sk) = (ld, 1), transposed with (1, ld)
  __device__ __forceinline__ void load_mat(float* smem, int off,
                                           const float* __restrict__ g,
                                           int nrow, int ncol, int sa,
                                           int sk) const {
    if (el >= nvalid) return;
    float* dst = smem + el * S + off;
    const float* src = g + e0 + el;
    int a = j / ncol, k = j - a * ncol;  // the one division of the load
    const int n = nrow * ncol;
    for (int i = j; i < n; i += 32) {
      cp_async4(dst + a * sa + k * sk, src + (size_t)i * B);
      k += 32;
      while (k >= ncol) {
        k -= ncol;
        ++a;
      }
    }
  }
  // smem[el * S + off + i] -> g (n, B)
  __device__ __forceinline__ void store_vec(const float* smem, int off,
                                            float* __restrict__ g,
                                            int n) const {
    if (el >= nvalid) return;
    const float* src = smem + el * S + off;
    float* dst = g + e0 + el;
    for (int i = j; i < n; i += 32) dst[(size_t)i * B] = src[i];
  }
};

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
// in shared memory, row stride ld), reg = 1e-6 max(diag H) + 1e-12
// (scale-aware Tikhonov term), inside the warp.  Right-looking Cholesky
// with the pivot clamped at 1e-12 and rsqrt: lane i owns row i (and row
// i + 32 when nv > 32); for column j the pivot is read by every lane, each
// lane scales its row's entry and updates its own row's trailing entries.
// L[i][j] is left at H[i * ld + j] (i > j).  Forward and back substitution
// are column-oriented, nv steps each with every lane at work: the solved
// entry is broadcast by a shuffle and each lane updates its own entry.
// H and grad must be complete on entry (a __syncwarp() before the call);
// dx is written for a < nv, visible after the caller's next __syncwarp().
// dj and col are nv floats of scratch each.
__device__ __forceinline__ void warp_newton_direction(float* H, int ld, int nv,
                                                      const float* grad,
                                                      float* dx, float* dj,
                                                      float* col, int lane) {
  float dmax = 0.f;  // max over H * eye, whose off-diagonal zeros count
  for (int a = lane; a < nv; a += 32) dmax = fmaxf(dmax, H[a * ld + a]);
  dmax = warp_max(dmax);
  const float reg = 1e-6f * dmax + 1e-12f;
  for (int a = lane; a < nv; a += 32) H[a * ld + a] += reg;
  __syncwarp();

  for (int j = 0; j < nv; ++j) {
    const float dj2 = fmaxf(H[j * ld + j], 1e-12f);
    const float inv = rsqrtf(dj2);
    for (int i = lane; i < nv; i += 32)
      if (i > j) col[i] = H[i * ld + j] * inv;
    if (lane == 0) dj[j] = dj2 * inv;
    __syncwarp();
    for (int i = lane; i < nv; i += 32) {
      if (i <= j) continue;
      const float ci = col[i];
      float* Hi = H + i * ld;
      for (int b = j + 1; b <= i; ++b) Hi[b] -= col[b] * ci;
      Hi[j] = ci;
    }
    __syncwarp();
  }

  const int r0 = lane, r1 = lane + 32;
  float y0 = r0 < nv ? grad[r0] : 0.f;
  float y1 = r1 < nv ? grad[r1] : 0.f;
  for (int j = 0; j < nv; ++j) {
    const float yj = __shfl_sync(kFull, j < 32 ? y0 : y1, j & 31) / dj[j];
    if (r0 == j) y0 = yj;
    else if (r0 > j && r0 < nv) y0 -= H[r0 * ld + j] * yj;
    if (r1 == j) y1 = yj;
    else if (r1 > j && r1 < nv) y1 -= H[r1 * ld + j] * yj;
  }
  for (int j = nv - 1; j >= 0; --j) {
    const float xj = __shfl_sync(kFull, j < 32 ? y0 : y1, j & 31) / dj[j];
    if (r0 == j) y0 = xj;
    else if (r0 < j) y0 -= H[j * ld + r0] * xj;
    if (r1 == j) y1 = xj;
    else if (r1 < j) y1 -= H[j * ld + r1] * xj;
  }
  if (r0 < nv) dx[r0] = -y0;
  if (r1 < nv) dx[r1] = -y1;
}

// The same direction with row i of H in lane i's registers, for a width NV
// known at compile time (NV <= 32): the pivot and the column entries travel
// by shuffles, every lane updates its row's trailing entries, nothing goes
// through shared memory until L is written back for the back substitution,
// which reads it transposed (lane i needs column i of L).  Entries above
// the diagonal of a lane's row are never read.  Arithmetic as above, op for
// op: regularisation, clamp, rsqrt, L[i][j] = H[i][j] * inv,
// H[a][b] -= L[b][j] * L[a][j], y_j / L[j][j].
template <int NV>
__device__ __forceinline__ void warp_newton_direction_reg(float* H, int ld,
                                                          const float* grad,
                                                          float* dx,
                                                          int lane) {
  static_assert(NV >= 1 && NV <= 32, "a lane per row");
  const bool own = lane < NV;
  float row[NV];
#pragma unroll
  for (int b = 0; b < NV; ++b)
    row[b] = (own && b < lane) ? H[lane * ld + b] : 0.f;
  // a lane's own diagonal entry is kept beside its row, so that the next
  // pivot leaves its lane one shuffle earlier (the same multiply-add as the
  // row's entry gets)
  float diag = own ? H[lane * ld + lane] : 0.f;
  const float dmax = warp_max(fmaxf(diag, 0.f));
  diag += 1e-6f * dmax + 1e-12f;

  // the forward substitution runs beside the factorisation: column j of L
  // is used as soon as it exists, and the two dependent chains overlap
  float y = own ? grad[lane] : 0.f;
  float djv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float dj2 = fmaxf(__shfl_sync(kFull, diag, j), 1e-12f);
    const float inv = rsqrtf(dj2);
    djv[j] = dj2 * inv;
    const float c = row[j] * inv;
    diag -= c * c;
    const float yj = __shfl_sync(kFull, y, j) / djv[j];
    if (lane == j) y = yj;
    else if (lane > j) y -= c * yj;
#pragma unroll
    for (int b = j + 1; b < NV; ++b) row[b] -= __shfl_sync(kFull, c, b) * c;
    row[j] = c;
  }
#pragma unroll
  for (int b = 0; b < NV; ++b)
    if (own && b < lane) H[lane * ld + b] = row[b];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < NV; ++j)
    row[j] = (own && j > lane) ? H[j * ld + lane] : 0.f;  // column of L
#pragma unroll
  for (int j = NV - 1; j >= 0; --j) {
    const float xj = __shfl_sync(kFull, y, j) / djv[j];
    if (lane == j) y = xj;
    else if (lane < j) y -= row[j] * xj;
  }
  if (own) dx[lane] = -y;
}

}  // namespace
