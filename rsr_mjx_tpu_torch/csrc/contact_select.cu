// K2: top-nsel contact selection with feature gather, for sm_90a.
//
// Replaces the Pallas TPU kernel _select_kernel / contact_select_lanes
// (rsr_mjx_tpu/physics/linalg_kernels.py:377-475).
//
// Inputs (float32 unless noted, batch B in the trailing axis):
//   dist       (ncon, B)       signed distance of every contact slot
//   feat       (ncon, Fd, B)   per-slot dynamic features
//   ptab       (Ptot, nst)     static per-pair columns (one row per pair)
//   slot_pair  (ncon,) int32   pair row of each slot
// Output:
//   out        (nsel, Fd + nst, B): row j = features of the j-th nearest slot
//
// Order: ascending dist, ties to the LOWEST slot index, exactly
// lax.top_k's order, as the TPU kernel's masked-min extraction gives.
// Most of the 480 slots are far apart and tie or near-tie, so the index
// tie-break decides most of the selection.  A NaN dist sorts after every
// number (the TPU kernel leaves that case undefined).
//
// What bounds it on the H100: bytes (dist is read once, 24 features rows
// gathered; a handful of compares per slot).
//
// Design: one block per env.  dist goes to shared memory; each of the nsel
// picks is one block-wide (min dist, min index) reduction (warp shuffles,
// then one value per warp through shared memory), after which the pick's
// dynamic features and its pair's static row are gathered at once.  The
// pair row is slot_pair[slot] (slot // slots_per_pair within its group),
// where the TPU kernel reduced a one-hot selection mask at pair level.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void contact_select_kernel(const float* __restrict__ dist,
                                      const float* __restrict__ feat,
                                      const float* __restrict__ ptab,
                                      const int* __restrict__ slot_pair,
                                      float* __restrict__ out, int ncon,
                                      int Fd, int nsel, int nst, int B) {
  extern __shared__ float smem[];
  float* d = smem;  // (ncon) dist, NaN as +inf
  unsigned char* taken = (unsigned char*)(d + ncon);
  __shared__ float wv[kWarpsPerBlock];
  __shared__ int wi[kWarpsPerBlock];
  __shared__ int pick;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int F = Fd + nst;

  for (int s = tid; s < ncon; s += kThreads) {
    const float v = dist[(size_t)s * B + e];
    d[s] = isnan(v) ? CUDART_INF_F : v;
    taken[s] = 0;
  }
  __syncthreads();

  for (int j = 0; j < nsel; ++j) {
    float bv = CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int s = tid; s < ncon; s += kThreads)
      if (!taken[s] && better(d[s], s, bv, bi)) { bv = d[s]; bi = s; }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { wv[warp] = bv; wi[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
      float v = wv[0];
      int i = wi[0];
      for (int w = 1; w < kWarpsPerBlock; ++w)
        if (better(wv[w], wi[w], v, i)) { v = wv[w]; i = wi[w]; }
      pick = i;
      taken[i] = 1;
    }
    __syncthreads();
    const int s = pick;
    float* o = out + (size_t)j * F * B + e;
    for (int f = tid; f < F; f += kThreads) {
      const float v = f < Fd ? feat[((size_t)s * Fd + f) * B + e]
                             : ptab[(size_t)slot_pair[s] * nst + (f - Fd)];
      o[(size_t)f * B] = v;
    }
  }
}

}  // namespace

extern "C" int contact_select_launch(const float* dist, const float* feat,
                                     const float* ptab, const int* slot_pair,
                                     float* out, int ncon, int Fd, int nsel,
                                     int nst, int B, cudaStream_t stream) {
  if (ncon < 1 || nsel < 1 || nsel > ncon || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ncon * (sizeof(float) + 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  contact_select_kernel<<<B, kThreads, smem, stream>>>(
      dist, feat, ptab, slot_pair, out, ncon, Fd, nsel, nst, B);
  return (int)cudaGetLastError();
}
