// Device functions shared by every kernel that gives an env to a warp and
// E consecutive envs to a block (K1 spd_solve.cu, K2 contact_select.cu and,
// through newton_common.cuh, K3 and K4): the warp reductions, the coalesced
// block loads and stores of batch-minor arrays, and the Cholesky solve
// inside a warp.
//
// A block holds E envs (E in {1, 2, 4, 8}, 32 E threads).  It loads its
// envs' arrays with the env index fastest across neighbouring threads, so
// that element i of the E envs is one run of 4 E bytes of a batch-minor
// array (a whole 32-byte sector at E = 8), and keeps each env's working set
// env-major in shared memory (per-env stride = 4 mod 32 words).  After that
// load an env's stages are ordered by __syncwarp() and its sums are shuffle
// reductions; no block barrier is passed until the outputs, staged in
// shared memory, leave the same way.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;  // bytes one block may use on sm_90

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

// log2 of E for E in {1, 2, 4, 8}, -1 for any other value
__host__ inline int log2_envs(int E) {
  return E == 1 ? 0 : (E == 2 ? 1 : (E == 4 ? 2 : (E == 8 ? 3 : -1)));
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
  // the triangle b >= a of g (n, n, B), and no other entry, transposed:
  // g[a][b] -> smem[el * S + off + b * ld + a], the lower triangle of the
  // copy.  Row a of the triangle holds n - a entries; k counts within it.
  __device__ __forceinline__ void load_tri(float* smem, int off,
                                           const float* __restrict__ g, int n,
                                           int ld) const {
    if (el >= nvalid) return;
    float* dst = smem + el * S + off;
    const float* src = g + e0 + el;
    int a = 0, k = j;
    while (a < n) {
      if (k >= n - a) {
        k -= n - a;
        ++a;
        continue;
      }
      const int b = a + k;
      cp_async4(dst + b * ld + a, src + (size_t)(a * n + b) * B);
      k += 32;
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

// -- y = (H + reg I)^-1 rhs for one env's nv x nv matrix (lower triangle in
// shared memory, row stride ld), inside the warp.  With TIKHONOV the
// scale-aware term reg = 1e-6 max(diag H) + 1e-12 is added first (the Newton
// kernels), without it reg = 0 (the plain SPD solve).  Right-looking
// Cholesky with the pivot clamped at eps and rsqrt: lane i owns row i (and
// row i + 32 when nv > 32); for column j the pivot is read by every lane,
// each lane scales its row's entry and updates its own row's trailing
// entries.  L[i][j] is left at H[i * ld + j] (i > j).  Forward and back
// substitution are column-oriented, nv steps each with every lane at work:
// the solved entry is broadcast by a shuffle and each lane updates its own
// entry.  H and rhs must be complete on entry (a __syncwarp() before the
// call); the lane's entries of y are returned in y0 (row lane) and y1 (row
// lane + 32).  dj and col are nv floats of scratch each.
template <bool TIKHONOV>
__device__ __forceinline__ void warp_chol_solve(float* H, int ld, int nv,
                                                const float* rhs, float eps,
                                                float* dj, float* col,
                                                int lane, float& y0,
                                                float& y1) {
  if constexpr (TIKHONOV) {
    float dmax = 0.f;  // max over H * eye, whose off-diagonal zeros count
    for (int a = lane; a < nv; a += 32) dmax = fmaxf(dmax, H[a * ld + a]);
    dmax = warp_max(dmax);
    const float reg = 1e-6f * dmax + 1e-12f;
    for (int a = lane; a < nv; a += 32) H[a * ld + a] += reg;
    __syncwarp();
  }

  for (int j = 0; j < nv; ++j) {
    const float dj2 = fmaxf(H[j * ld + j], eps);
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
  y0 = r0 < nv ? rhs[r0] : 0.f;
  y1 = r1 < nv ? rhs[r1] : 0.f;
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
}

// The same solve with row i of H in lane i's registers, for a width NV
// known at compile time (NV <= 32): the pivot and the column entries travel
// by shuffles, every lane updates its row's trailing entries, nothing goes
// through shared memory until L is written back for the back substitution,
// which reads it transposed (lane i needs column i of L).  Entries above
// the diagonal of a lane's row are never read.  Arithmetic as above, op for
// op: regularisation, clamp, rsqrt, L[i][j] = H[i][j] * inv,
// H[a][b] -= L[b][j] * L[a][j], y_j / L[j][j].  Returns the lane's entry of
// y (0 for lane >= NV).
template <int NV, bool TIKHONOV>
__device__ __forceinline__ float warp_chol_solve_reg(float* H, int ld,
                                                     const float* rhs,
                                                     float eps, int lane) {
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
  if constexpr (TIKHONOV) {
    const float dmax = warp_max(fmaxf(diag, 0.f));
    diag += 1e-6f * dmax + 1e-12f;
  }

  // the forward substitution runs beside the factorisation: column j of L
  // is used as soon as it exists, and the two dependent chains overlap
  float y = own ? rhs[lane] : 0.f;
  float djv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const float dj2 = fmaxf(__shfl_sync(kFull, diag, j), eps);
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
  return y;
}

}  // namespace
