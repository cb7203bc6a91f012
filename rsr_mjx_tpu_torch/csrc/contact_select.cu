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
// Outputs:
//   out        (nsel, Fd + nst, B): row j = features of the j-th nearest slot
//   picks      (nsel, B) int32: that slot (the backward scatters through it)
//
// Order: ascending dist, ties to the LOWEST slot index, exactly
// lax.top_k's order, as the TPU kernel's masked-min extraction gives.
// Most of the 480 slots are far apart and tie or near-tie, so the index
// tie-break decides most of the selection.  A NaN dist counts as +inf,
// after every number (the TPU kernel leaves that case undefined).
//
// What bounds it on the H100: bytes (dist is read once, nsel feature rows
// gathered and nsel (Fd + nst) values written per env; a handful of
// compares per slot).
//
// Design (lanes_common.cuh): E consecutive envs per block, in three phases.
//  1. The block loads its dist tile with the env index fastest across
//     neighbouring threads (cp.async, whole 32-byte sectors at E = 8) and
//     copies ptab into shared memory.
//  2. A warp per env makes the nsel picks with no block barrier.  Each dist
//     becomes a 32-bit key whose unsigned order is the floats' order (-0 as
//     +0, NaN as +inf).  Lane l owns slots l, l + 32, ... and keeps the best
//     (key, index) of those not yet taken; a pick is two warp-wide minima
//     (redux.sync): the least key, then the least index among the lanes that
//     hold it.  Only the winning lane marks its slot and looks through its
//     own ceil(ncon / 32) keys again, lowest slot first.  A taken slot's key
//     is 0xffffffff, above +inf's, so a genuine +inf can still be picked.
//     Up to 512 slots (the served path has 480) a lane's keys live in its
//     registers; more slots keep them in shared memory, in place of dist.
//     A pick costs ~200 cycles of latency that way, where five shuffle
//     stages and a rescan through shared memory cost ~1200.  The picks go to
//     shared memory as (nsel, E) slot and pair indices.
//  3. The whole block gathers and stores with the env fastest: thread
//     (el, f) of pick j reads feat[(slot * Fd + f) * B + e] (scattered by
//     nature: this is the gather) or the pair's static row from the copy of
//     ptab, and writes out[(j * F + f) * B + e] in runs of 4 E bytes; the
//     picks go out the same way, picks[j * B + e].
//
// Shared memory, words: per env ncon (dist) at a stride rounded up to 4 mod
// 32; per block 2 nsel E (slot and pair of every pick) and Ptot nst (ptab).
// ncon 480, nsel 24, ptab 30 x 33: E = 8 in 20984 bytes.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "lanes_common.cuh"

namespace {

// word offsets within a block of E envs
struct Layout {
  int S, pick, pair, ptab, words;
  __host__ __device__ Layout(int ncon, int nsel, int Ptot, int nst, int E) {
    S = env_stride(ncon, E);
    int o = E * S;
    pick = o; o += nsel * E;
    pair = o; o += nsel * E;
    ptab = o; o += Ptot * nst;
    words = o;
  }
};

constexpr int kGather = 8;  // reads a thread keeps in flight in phase 3

constexpr unsigned kTaken = 0xffffffffu;  // above every key
constexpr int kRegSlots = 16;  // keys a lane keeps in registers: ncon <= 512

// dist as an unsigned whose order is the floats': a < b <=> key(a) < key(b)
// and a == b <=> equal keys (-0 counts as +0), NaN as +inf
__device__ __forceinline__ unsigned dist_key(float v) {
  if (isnan(v)) v = CUDART_INF_F;
  if (v == 0.f) v = 0.f;
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A lane's keys of slots lane, lane + 32, ...: in registers (NS > 0, slots
// past ncon taken from the start) or in the env's tile of shared memory.
template <int NS>
struct LaneKeys {
  unsigned key[NS > 0 ? NS : 1];
  unsigned* tile;
  int ncon, lane;
  __device__ LaneKeys(float* d, int ncon_, int lane_)
      : tile(reinterpret_cast<unsigned*>(d)), ncon(ncon_), lane(lane_) {
    if constexpr (NS > 0) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int s = lane + 32 * k;
        key[k] = s < ncon ? dist_key(d[s]) : kTaken;
      }
    } else {
      for (int s = lane; s < ncon; s += 32) tile[s] = dist_key(d[s]);
    }
  }
  __device__ __forceinline__ void take(int slot) {
    if constexpr (NS > 0) {
#pragma unroll
      for (int k = 0; k < NS; ++k)
        if (k == (slot >> 5)) key[k] = kTaken;
    } else {
      tile[slot] = kTaken;
    }
  }
  // the least key left and its slot, the lowest slot among equal keys
  __device__ __forceinline__ void best(unsigned& bk, int& bi) const {
    bk = kTaken;
    bi = 0x7fffffff;
    if constexpr (NS > 0) {
      // a tournament over neighbouring ranges, depth log2 NS: the left
      // range holds the lower slots, so it wins a tie
      unsigned kk[NS];
      int ii[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        kk[k] = key[k];
        ii[k] = k;
      }
#pragma unroll
      for (int w = 1; w < NS; w <<= 1)
#pragma unroll
        for (int k = 0; k + w < NS; k += 2 * w)
          if (kk[k + w] < kk[k]) {
            kk[k] = kk[k + w];
            ii[k] = ii[k + w];
          }
      if (kk[0] < kTaken) {
        bk = kk[0];
        bi = lane + 32 * ii[0];
      }
    } else {
#pragma unroll 4
      for (int s = lane; s < ncon; s += 32) {
        const unsigned k = tile[s];
        if (k < bk) {
          bk = k;
          bi = s;
        }
      }
    }
  }
};

template <int NS>
__global__ void __launch_bounds__(256) contact_select_kernel(
    const float* __restrict__ dist, const float* __restrict__ feat,
    const float* __restrict__ ptab_, const int* __restrict__ slot_pair,
    float* __restrict__ out, int* __restrict__ picks, int ncon, int Fd,
    int nsel, int nst, int Ptot, int B, int logE) {
  extern __shared__ __align__(16) float smem[];
  const int E = 1 << logE;
  const Layout L(ncon, nsel, Ptot, nst, E);
  int* pick = reinterpret_cast<int*>(smem + L.pick);
  int* pair = reinterpret_cast<int*>(smem + L.pair);
  float* ptab = smem + L.ptab;

  // -- 1. load
  const BlockIo io(logE, L.S, B);
  io.load_vec(smem, 0, dist, ncon);
  for (int i = threadIdx.x; i < Ptot * nst; i += blockDim.x)
    ptab[i] = ptab_[i];
  cp_async_wait_all();
  __syncthreads();

  // -- 2. picks, a warp per env
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w < io.nvalid) {
    LaneKeys<NS> keys(smem + w * L.S, ncon, lane);
    unsigned bk;
    int bi;
    keys.best(bk, bi);
    for (int j = 0; j < nsel; ++j) {
      const unsigned m = __reduce_min_sync(kFull, bk);
      // nsel <= ncon: a slot is left, so m < kTaken and wi is a slot
      const int wi = (int)__reduce_min_sync(
          kFull, bk == m ? (unsigned)bi : 0x7fffffffu);
      if ((wi & 31) == lane) {  // its owner takes it
        pick[j * E + w] = wi;
        keys.take(wi);
        keys.best(bk, bi);
      }
    }
    __syncwarp();
    for (int j = lane; j < nsel; j += 32)
      pair[j * E + w] = slot_pair[pick[j * E + w]];
  }
  __syncthreads();

  // -- 3. gather and store, env fastest: item = (j * F + f) * E + el
  const int F = Fd + nst;
  if (io.el < io.nvalid) {
    const size_t Bs = (size_t)B;
    const float* fsrc = feat + io.e0 + io.el;
    float* dst = out + io.e0 + io.el;
    for (int jj = io.j; jj < nsel; jj += 32)
      picks[(size_t)jj * Bs + io.e0 + io.el] = pick[jj * E + io.el];
    int j = io.j / F, f = io.j - j * F;  // the one division of the store
    const int rows = nsel * F;
    // kGather reads in flight before the first of their stores: a store
    // right behind its read would leave one scattered read in flight
    for (int r0 = io.j; r0 < rows; r0 += 32 * kGather) {
      float v[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        if (r0 + 32 * u < rows)
          v[u] = f < Fd ? fsrc[((size_t)pick[j * E + io.el] * Fd + f) * Bs]
                        : ptab[pair[j * E + io.el] * nst + (f - Fd)];
        f += 32;
        while (f >= F) {
          f -= F;
          ++j;
        }
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u)
        if (r0 + 32 * u < rows) dst[(size_t)(r0 + 32 * u) * Bs] = v[u];
    }
  }
}

}  // namespace

// E envs per block (1, 2, 4 or 8), chosen by the caller.
extern "C" int contact_select_launch(const float* dist, const float* feat,
                                     const float* ptab, const int* slot_pair,
                                     float* out, int* picks, int ncon, int Fd,
                                     int nsel, int nst, int Ptot, int B,
                                     int E, cudaStream_t stream) {
  const int logE = log2_envs(E);
  if (ncon < 1 || nsel < 1 || nsel > ncon || Fd < 1 || nst < 0 || Ptot < 1 ||
      B < 1 || logE < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (size_t)Layout(ncon, nsel, Ptot, nst, E).words;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  auto kernel = ncon <= 32 * kRegSlots ? contact_select_kernel<kRegSlots>
                                       : contact_select_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(B + E - 1) / E, 32 * E, smem, stream>>>(
      dist, feat, ptab, slot_pair, out, picks, ncon, Fd, nsel, nst, Ptot, B,
      logE);
  return (int)cudaGetLastError();
}
