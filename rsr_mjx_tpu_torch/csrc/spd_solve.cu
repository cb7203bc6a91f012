// K1: batched small SPD solve x = A^-1 b in lanes layout, for sm_90a.
//
// Replaces the Pallas TPU kernel _spd_kernel / spd_solve_lanes
// (rsr_mjx_tpu/physics/linalg_kernels.py:103-130).
//
// Layout: A is (n, n, B) and b, x are (n, B), float32, batch in the
// trailing axis (the JAX lanes layout, kept at the public function).
//
// The function: a right-looking Cholesky, one column per step (rsqrt of the
// pivot clamped at eps, dj = dj2 * inv, then a rank-1 update), and two
// triangular solves that divide by dj.  Column j reads row j's entries
// i >= j of the running matrix, which depend only on the input entries
// A[a][b] with b >= a: the other triangle never reaches x, and this kernel
// does not read it (n (n + 1) / 2 of the n^2 entries).
//
// What bounds it on the H100: bytes.  Per env the work is a 20 x 20
// Cholesky and two triangular solves (~6 kFLOP) on 0.9 KB of input, far
// below the card's 20 FLOP/byte fp32 balance point.
//
// Design: two decompositions, chosen by the caller from the batch.
//  - A warp per env, E <= 8 consecutive envs per block (lanes_common.cuh,
//    shared with K3 and K4).  For the bytes: the block loads the triangle
//    and b with the env index fastest across neighbouring threads, every
//    element a 4-byte cp.async in flight at once, so each 32-byte sector of
//    the batch-minor arrays is used whole at E = 8; x leaves the same way.
//    For the latency: at the widths of the served paths (18, 20, compiled
//    in) lane i keeps row i of the matrix in registers, the pivot and the
//    column travel by shuffles, and the forward substitution runs inside
//    the factorisation; the back substitution is column-oriented.  Any
//    other width n <= 32 runs the same solve in shared memory with n at run
//    time.  Shared memory is otherwise only the staging buffer.  Every env
//    costs a whole warp's work with 18 or 20 of 32 lanes busy, so this
//    route is bound by the dispatch and shuffle rates once the batch fills the
//    card; it is the faster one while a warp of 32 envs per SM is not
//    available.
//  - A thread per env, 32 envs per block (E = 32), widths 18 and 20 only:
//    the lanes layout is the interleaved batched layout, so thread e's
//    loads A[idx * B + e] are coalesced as they stand; the triangle lives in
//    the thread's registers, fully unrolled (255 registers and ~1 KB of
//    spills at n 20), no lane idles and nothing is exchanged.  One thread
//    runs ~2 k operations in a mostly dependent chain, so it needs the
//    batch to give every SM a warp (B >= 32 SMs).
//
// Shared memory per env, words: the matrix n ld (ld = n | 1: lane i reads
// row i free of bank conflicts), b (x in its place) and the two scratch
// vectors of the run-time route, n each; at a stride rounded up to 4 mod
// 32.  n 20: 480 words, E = 8 in 15488 bytes.

#include <cuda_runtime.h>

#include "lanes_common.cuh"

namespace {

// word offsets of one env's working set
struct Layout {
  int ld, H, rhs, dj, col, words;
  __host__ __device__ explicit Layout(int n) {
    ld = n | 1;
    int o = 0;
    H = o; o += n * ld;
    rhs = o; o += n;
    dj = o; o += n;
    col = o; o += n;
    words = o;
  }
  __host__ __device__ size_t bytes(int E) const {
    return sizeof(float) * (size_t)E * env_stride(words, E);
  }
};

template <int NV>
__global__ void __launch_bounds__(256) spd_solve_kernel(
    const float* __restrict__ A, const float* __restrict__ b,
    float* __restrict__ x, int n_arg, int B, float eps, int logE) {
  extern __shared__ __align__(16) float smem[];
  const int n = NV > 0 ? NV : n_arg;  // NV > 0: the width at compile time
  const Layout L(n);
  const int E = 1 << logE, S = env_stride(L.words, E);

  const BlockIo io(logE, S, B);
  io.load_tri(smem, L.H, A, n, L.ld);
  io.load_vec(smem, L.rhs, b, n);
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if ((size_t)blockIdx.x * E + w < (size_t)B) {
    float* s = smem + w * S;
    if constexpr (NV > 0) {
      const float y =
          warp_chol_solve_reg<NV, false>(s + L.H, L.ld, s + L.rhs, eps, lane);
      if (lane < NV) s[L.rhs + lane] = y;
    } else {
      float y0, y1;
      warp_chol_solve<false>(s + L.H, L.ld, n, s + L.rhs, eps, s + L.dj,
                             s + L.col, lane, y0, y1);
      if (lane < n) s[L.rhs + lane] = y0;
    }
  }
  __syncthreads();
  io.store_vec(smem, L.rhs, x, n);
}

// The thread-per-env route: S[a][c], c >= a, is the triangle, row j of which
// becomes column j of L; the other entries are never touched.  Same
// operations as above; the back substitution is column-oriented.
template <int N>
__global__ void __launch_bounds__(32) spd_solve_thread_kernel(
    const float* __restrict__ A, const float* __restrict__ b,
    float* __restrict__ x, int B, float eps) {
  const int e = blockIdx.x * 32 + threadIdx.x;
  if (e >= B) return;
  const size_t Bs = (size_t)B;
  float S[N][N];
  float g[N];
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int c = a; c < N; ++c) S[a][c] = A[(size_t)(a * N + c) * Bs + e];
#pragma unroll
  for (int i = 0; i < N; ++i) g[i] = b[(size_t)i * Bs + e];

#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float dj2 = fmaxf(S[j][j], eps);
    const float inv = rsqrtf(dj2);
    const float dj = dj2 * inv;
    S[j][j] = dj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) S[j][i] *= inv;  // L[i][j]
    const float yj = g[j] / dj;  // the forward substitution, column j
    g[j] = yj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) g[i] -= S[j][i] * yj;
#pragma unroll
    for (int a = j + 1; a < N; ++a)
#pragma unroll
      for (int c = a; c < N; ++c) S[a][c] -= S[j][c] * S[j][a];
  }
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    const float xj = g[j] / S[j][j];
    g[j] = xj;
#pragma unroll
    for (int i = 0; i < j; ++i) g[i] -= S[i][j] * xj;  // L[j][i]
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[(size_t)i * Bs + e] = g[i];
}

}  // namespace

// E envs per block, chosen by the caller: 1, 2, 4 or 8 with a warp per env
// (n <= 32), or 32 with a thread per env (n 18 or 20).
extern "C" int spd_solve_lanes_launch(const float* A, const float* b,
                                      float* x, int n, int B, float eps,
                                      int E, cudaStream_t stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  if (E == 32) {
    if (n == 18)
      spd_solve_thread_kernel<18><<<(B + 31) / 32, 32, 0, stream>>>(A, b, x, B,
                                                                    eps);
    else if (n == 20)
      spd_solve_thread_kernel<20><<<(B + 31) / 32, 32, 0, stream>>>(A, b, x, B,
                                                                    eps);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  const int logE = log2_envs(E);
  if (n < 1 || n > 32 || logE < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(n).bytes(E);  // at most 36 KB: no attribute
  // the widths of the served paths at compile time, any other at run time
  auto kernel = n == 18 ? spd_solve_kernel<18>
                        : (n == 20 ? spd_solve_kernel<20>
                                   : spd_solve_kernel<0>);
  kernel<<<(B + E - 1) / E, 32 * E, smem, stream>>>(A, b, x, n, B, eps, logE);
  return (int)cudaGetLastError();
}
