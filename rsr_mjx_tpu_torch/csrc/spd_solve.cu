// K1: batched small SPD solve x = A^-1 b in lanes layout, for sm_90a.
//
// Replaces the Pallas TPU kernel _spd_kernel / spd_solve_lanes
// (rsr_mjx_tpu/physics/linalg_kernels.py:103-130).
//
// Layout: A is (n, n, B) and b, x are (n, B), float32, batch in the
// trailing axis (the JAX lanes layout, kept at the public function).
//
// What bounds it on the H100: bytes.  Per env the work is a 20x20 Cholesky
// and two triangular solves (~6 kFLOP) on 1.7 KB of input, far below the
// card's 20 FLOP/byte fp32 balance point.
//
// Design: one warp per env.  The warp copies its matrix into shared
// memory, then factors it right-looking, one column per step as the TPU
// kernel does (rsqrt of the pivot clamped at eps, then a rank-1 update of
// the trailing block), with lane i owning row i.  L is kept in the lower
// triangle of the same buffer; the forward and back solves keep one entry
// per lane in registers and use warp shuffles.  n <= 32.  Loads read one
// env's entries at stride B (not coalesced); a later PR can stage 32 envs
// per block to coalesce them.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;

__global__ void spd_solve_kernel(const float* __restrict__ A,
                                 const float* __restrict__ b,
                                 float* __restrict__ x, int n, int B,
                                 float eps) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= B) return;  // the whole warp leaves together
  float* S = smem + warp * (n * n + 2 * n);
  float* c = S + n * n;  // current column
  float* dj = c + n;     // L[j][j]

  for (int idx = lane; idx < n * n; idx += 32)
    S[idx] = A[(size_t)idx * B + e];
  __syncwarp();

  for (int j = 0; j < n; ++j) {
    const float dj2 = fmaxf(S[j * n + j], eps);
    const float inv = rsqrtf(dj2);
    if (lane >= j && lane < n) c[lane] = S[j * n + lane] * inv;
    if (lane == 0) dj[j] = dj2 * inv;
    __syncwarp();
    if (lane > j && lane < n) {
      S[lane * n + j] = c[lane];  // L[lane][j]; column j is never read again
      const float ca = c[lane];
      for (int bb = j + 1; bb < n; ++bb) S[lane * n + bb] -= c[bb] * ca;
    }
    __syncwarp();
  }

  // forward: L y = b
  float g = lane < n ? b[(size_t)lane * B + e] : 0.f;
  float y = 0.f;
  for (int j = 0; j < n; ++j) {
    const float yj = __shfl_sync(0xffffffffu, g, j) / dj[j];
    if (lane == j) y = yj;
    if (lane > j && lane < n) g -= S[lane * n + j] * yj;
  }
  // back: L^T x = y
  float xv = 0.f;
  for (int j = n - 1; j >= 0; --j) {
    float t = (lane > j && lane < n) ? S[lane * n + j] * xv : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    const float yj = __shfl_sync(0xffffffffu, y, j);
    if (lane == j) xv = (yj - t) / dj[j];
  }
  if (lane < n) x[(size_t)lane * B + e] = xv;
}

}  // namespace

extern "C" int spd_solve_lanes_launch(const float* A, const float* b,
                                      float* x, int n, int B, float eps,
                                      cudaStream_t stream) {
  if (n < 1 || n > 32 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kWarps * (n * n + 2 * n) * sizeof(float);
  const int grid = (B + kWarps - 1) / kWarps;
  spd_solve_kernel<<<grid, kWarps * 32, smem, stream>>>(A, b, x, n, B, eps);
  return (int)cudaGetLastError();
}
