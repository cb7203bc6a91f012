"""The batched small linear algebra of the physics step: four Hopper
kernels, each beside a plain PyTorch version of the same function, and a
fifth (K5 ``assemble_rows``) that writes the constraint assembly's generic
contact rows, which replaces no TPU kernel (see its section).

Counterpart of ``rsr_mjx_tpu/physics/linalg_kernels.py``, whose Pallas TPU
kernels these replace:

  K1 ``spd_solve_lanes``      ← ``_spd_kernel`` (linalg_kernels.py:103-130)
  K2 ``contact_select_lanes`` ← ``_select_kernel`` (:377-475)
  K3 ``newton_lanes_pyr_t``   ← ``_newton_kernel_pyr`` (:500-828)
  K4 ``_newton_lanes_core``   ← ``_newton_kernel`` (:247-358, :878-974)

Two of them carry gradients, as their JAX counterparts do: ``spd_solve``
(``SpdSolve``, JAX's ``spd_solve`` custom VJP, :145-195) solves with K1
and takes one more K1 solve backward, and ``contact_select_lanes`` scatters
the cotangents of its picked rows back to the slots and pair rows it
gathered (the transpose of JAX's one-hot gather).  ``newton_solve_batched``
is the batch-major entry to K4 that the implicit-function-theorem solve of
``solver`` calls.

Each public function keeps the JAX lanes layout (batch in the trailing
axis) and argument order, so the tests compare like with like.  Dispatch is
by device and nothing else: a CPU tensor goes through the plain version, a
CUDA tensor launches the CUDA C++ kernel (``csrc/*.cu``, built at first use
by ``cuda_build``) or raises.  There is no fallback from the kernel to the
plain version, to a library call or to the CPU.

Each wrapper counts its kernel launches in ``LAUNCHES[<wrapper name>]``,
incremented where the kernel is launched and nowhere else (the counter
group ``launches`` of ``utils.tracing``).

The kernels take float32; the physics runs in true fp32 (see
``rsr_mjx_tpu_torch.physics.forward`` for the TF32 switches).  The plain
versions also take float64, so the CPU path can run as a float64 reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from rsr_mjx_tpu_torch.physics import constraint as _C
from rsr_mjx_tpu_torch.physics import cuda_build
from rsr_mjx_tpu_torch.utils import tracing

# row kinds (constraint.py); kept here too so this module imports nothing
# of the assembly
_FRICTION = 1
_LIMIT = 2
_CONTACT = 3

# shared memory one block may use on sm_90 (227 KB): every kernel keeps the
# working sets of a block's envs in it
_SMEM_LIMIT = 232448
# streaming multiprocessors of an H100 SXM: the default of the E chooser
# (the wrappers pass the card's own count)
_H100_SMS = 132
# scratch of the Jᵀs products of the Newton kernels (kPartWords), words
_PART_WORDS = 128


# kernel launches of each wrapper, the tracing registry's counter group
# 'launches'; zero them with LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
LAUNCHES = tracing.group('launches')
LAUNCHES.update(dict.fromkeys(('spd_solve_lanes', 'contact_select_lanes',
                               'newton_lanes_pyr_t', '_newton_lanes_core',
                               'assemble_rows'), 0))


def _check(name: str, t: torch.Tensor, shape, ref: torch.Tensor) -> None:
  """t has ``shape``, is contiguous and matches ref's device and dtype."""
  if t.dtype != ref.dtype:
    raise TypeError(f'{name}: {t.dtype}, expected {ref.dtype}')
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f'{name}: shape {tuple(t.shape)} != {tuple(shape)}')
  if t.device != ref.device:
    raise ValueError(f'{name}: on {t.device}, expected {ref.device}')
  if not t.is_contiguous():
    raise ValueError(f'{name}: must be contiguous')


def _route(t: torch.Tensor) -> str:
  """'plain' for a CPU tensor (float32 or float64), 'cuda' for a float32
  CUDA tensor; raise otherwise."""
  if t.device.type == 'cpu':
    if t.dtype not in (torch.float32, torch.float64):
      raise TypeError(f'plain version takes float32 or float64, not {t.dtype}')
    return 'plain'
  if t.device.type == 'cuda':
    if t.dtype != torch.float32:
      raise TypeError(f'kernel takes float32, not {t.dtype}')
    return 'cuda'
  raise ValueError(f'no kernel for device {t.device}')


def _launch(lib: str, *args) -> None:
  err = cuda_build.kernel(lib)(*args)
  if err:
    raise RuntimeError(f'{lib} kernel launch failed: CUDA error {err}')


def _stream() -> int:
  return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# Shared-memory layout of the kernels (``csrc/lanes_common.cuh``): a warp per
# env, E consecutive envs per block, each env's working set at a stride that
# is 4 mod 32 words.  The ``*_smem_bytes`` functions below repeat the
# ``Layout`` structs of the sources word for word, so that the size guards
# and the choice of E are reached by the CPU tests.
# ---------------------------------------------------------------------------


def _env_stride(words: int, E: int) -> int:
  """Per-env stride in a block of E envs: the next value >= ``words`` that
  is 4 mod 32; a single env is only rounded up to 4."""
  return (words + 3) // 4 * 4 if E == 1 else (words + 27) // 32 * 32 + 4


def envs_per_block(smem_bytes, B: int, n_sm: int = _H100_SMS,
                   candidates=(8, 4, 2, 1)) -> int:
  """E, the envs one block of a kernel takes: the largest of ``candidates``
  (descending, ending in 1) whose working set ``smem_bytes(E)`` fits the
  232448 bytes of a block and which still gives every SM a block
  (ceil(B / E) >= n_sm); E = 1 whenever the batch is too small for that.
  Raises if a single env does not fit."""
  fits = [E for E in candidates if smem_bytes(E) <= _SMEM_LIMIT]
  if not fits:
    raise ValueError(
        f'one env needs {smem_bytes(1)} bytes of shared memory '
        f'(limit {_SMEM_LIMIT})')
  for E in fits:
    if -(-B // E) >= n_sm:
      return E
  return fits[-1]


# ---------------------------------------------------------------------------
# In-place batched Cholesky + solve in lanes layout (plain versions).
#
# The TPU kernel's right-looking outer-product form: column j is one rsqrt
# of the pivot (clamped at eps) and one rank-1 update of the matrix.
# ---------------------------------------------------------------------------


def _chol_cols(H: torch.Tensor, eps: float):
  """H (n, n, B) → (cols, djs): cols[j] column j of L as (n, B), zero above
  the diagonal; djs[j] = L[j, j] as (1, B)."""
  n = H.shape[0]
  rows = torch.arange(n, device=H.device)[:, None]
  S = H
  cols, djs = [], []
  for j in range(n):
    Sj = S[j]
    dj2 = torch.clamp(Sj[j : j + 1], min=eps)
    inv = torch.rsqrt(dj2)
    c = Sj * inv * (rows >= j).to(H.dtype)
    cols.append(c)
    djs.append(dj2 * inv)
    if j < n - 1:
      S = S - c[None, :, :] * c[:, None, :]
  return cols, djs


def _cho_solve_cols(cols, djs, b: torch.Tensor) -> torch.Tensor:
  """Solve L Lᵀ x = b from the column factor; b, x (n, B)."""
  n = b.shape[0]
  g = b
  ys = []
  for j in range(n):
    yj = g[j : j + 1] / djs[j]
    ys.append(yj)
    g = g - cols[j] * yj
  x = torch.zeros_like(b)
  for j in range(n - 1, -1, -1):
    t = torch.sum(cols[j] * x, dim=0, keepdim=True)
    x = x.clone()
    x[j : j + 1] = (ys[j] - t) / djs[j]
  return x


# ---------------------------------------------------------------------------
# K1 — batched SPD solve x = A⁻¹ b.
#
# Replaces _spd_kernel / spd_solve_lanes (rsr_mjx_tpu linalg_kernels.py:103).
# Bound on the H100: bytes.  At n = 20, B = 2048 it reads 3.4 MB and writes
# 0.16 MB (≈ 1.1 µs at 3.35 TB/s) against ≈ 2n³/3 + 2n² ≈ 6.1 kFLOP per
# env (12.5 MFLOP in all, 0.2 µs at 67 TFLOP/s fp32).  Column j of the
# factorisation reads row j's entries i >= j only, so x depends on the
# triangle A[a][b >= a] alone: the kernel loads those n(n+1)/2 entries and
# no other.  Design: a warp per env, E <= 8 envs per block, the triangle and
# b loaded with the env index fastest across threads; at n 18 and 20 lane i
# keeps row i in registers and the column travels by shuffles, any other
# n <= 32 is factored in shared memory.  Once the batch gives every SM a
# warp of 32 envs, n 18 and 20 take a thread per env instead (E = 32: the
# lanes layout is coalesced as it stands, the triangle in registers).
# ``envs_per_block`` chooses among both.  No padding (the TPU's 128-lane
# blocks padded with identity systems have no counterpart).
# ---------------------------------------------------------------------------


def spd_solve_plain(At: torch.Tensor, bt: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
  """Plain version of K1: A (n, n, B), b (n, B) → x (n, B)."""
  cols, djs = _chol_cols(At, eps)
  return _cho_solve_cols(cols, djs, bt)


# widths at which K1 has its thread-per-env route compiled in (E = 32)
_SPD_THREAD_WIDTHS = (18, 20)


def spd_solve_smem_bytes(n: int, E: int = 1) -> int:
  """Shared memory a block of K1 with E envs needs (the layout of
  ``csrc/spd_solve.cu``).  Per env, in float32 words: the matrix at the row
  stride ld = n | 1, b, and two scratch vectors of n, at a stride that is
  4 mod 32.  E = 32 is the thread-per-env route, which uses none."""
  if E == 32:
    return 0
  words = n * (n | 1) + 3 * n
  return 4 * E * _env_stride(words, E)


def check_spd_solve_fits(n: int) -> None:
  """Raise unless K1 takes the width: n <= 32 (a lane per row)."""
  if n > 32:
    raise ValueError(f'spd_solve_lanes kernel takes n <= 32, got {n}')


def spd_solve_envs_per_block(n: int, B: int, n_sm: int = _H100_SMS) -> int:
  """K1's E: 8, 4, 2 or 1 envs per block with a warp per env or, at the
  widths that have it and once ceil(B / 32) >= n_sm, 32 with a thread per
  env."""
  cands = (32, 8, 4, 2, 1) if n in _SPD_THREAD_WIDTHS else (8, 4, 2, 1)
  return envs_per_block(lambda E: spd_solve_smem_bytes(n, E), B, n_sm, cands)


def spd_solve_lanes(At: torch.Tensor, bt: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
  """Lanes-layout batched SPD solve; A (n, n, B), b (n, B) → x (n, B).

  Only the triangle A[a][b >= a] reaches x.  The CUDA route takes n <= 32
  (a lane per row)."""
  n, B = bt.shape
  _check('b', bt, (n, B), bt)
  _check('A', At, (n, n, B), bt)
  if _route(bt) == 'plain':
    return spd_solve_plain(At, bt, eps)
  check_spd_solve_fits(n)
  E = spd_solve_envs_per_block(n, B, _sm_count(bt.device))
  x = torch.empty_like(bt)
  LAUNCHES['spd_solve_lanes'] += 1
  _launch('spd_solve', At.data_ptr(), bt.data_ptr(), x.data_ptr(), n, B,
          float(eps), E, _stream())
  return x


class SpdSolve(torch.autograd.Function):
  """x = A⁻¹ b through K1, with JAX's ``_spd_bwd`` (linalg_kernels.py
  :189-195) as backward: w = A⁻¹ g by K1 again (A symmetric), Ā = −w xᵀ,
  b̄ = w.  Lanes layout: A (n, n, B), b (n, B)."""

  @staticmethod
  def forward(ctx, At, bt):
    x = spd_solve_lanes(At, bt)
    ctx.save_for_backward(At, x)
    return x

  @staticmethod
  def backward(ctx, g):
    At, x = ctx.saved_tensors
    w = spd_solve_lanes(At, g.contiguous())
    return -w[:, None, :] * x[None, :, :], w


def spd_solve(At: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
  """``spd_solve_lanes`` that carries gradients: through ``SpdSolve`` when
  grad mode is on and A or b requires grad, else the wrapper itself (no
  tensor saved, the same launches)."""
  if torch.is_grad_enabled() and (At.requires_grad or bt.requires_grad):
    return SpdSolve.apply(At, bt)
  return spd_solve_lanes(At, bt)


# ---------------------------------------------------------------------------
# K2 — top-nsel contact selection with feature gather.
#
# Replaces _select_kernel / contact_select_lanes (linalg_kernels.py:377).
# Selects the nsel slots of smallest dist in lax.top_k order: ascending
# dist, ties to the LOWEST slot index (a parallel argmin that ignored the
# index would pick other slots, since most of the 480 slots tie or
# near-tie far from contact).  Each pick gathers the slot's dynamic
# features and its pair's static row (pair = slot // slots_per_pair within
# its group, where the TPU kernel reduced a one-hot at pair level).
# Bound on the H100: bytes.  Design: E envs per block (``envs_per_block``);
# the dist tile loaded with the env index fastest across threads; a warp per
# env makes the nsel picks (lane l owns slots l, l + 32, … as ordered keys,
# in registers up to 512 slots; a pick is two warp-wide minima, no block
# barrier); then the whole block gathers and stores with the env fastest,
# the static rows from a copy of the pair table in shared memory, and writes
# the picked slots (nsel, B), which the backward scatters through.
# ---------------------------------------------------------------------------


@functools.cache
def _slot_pair(pair_struct: tuple, device: torch.device) -> torch.Tensor:
  """Static slot → pair-row map (ncon,) int32 for ((P, k, off), ...), made
  on ``device`` once and never freed: a substep replayed from a CUDA graph
  (``physics/graphed.py``) reads it at its address."""
  out, base = [], 0
  for P, k, off in pair_struct:
    out.append(base + np.arange(P * k) // k)
    base += P
  return torch.tensor(np.concatenate(out), dtype=torch.int32, device=device)


def contact_select_smem_bytes(ncon: int, nsel: int, Ptot: int, nst: int,
                              E: int = 1) -> int:
  """Shared memory a block of K2 with E envs needs (the layout of
  ``csrc/contact_select.cu``), in float32 words: per env the ncon dists at a
  stride that is 4 mod 32; per block the slot and the pair of every pick
  (2·nsel·E) and the pair table (Ptot·nst)."""
  return 4 * (E * _env_stride(ncon, E) + 2 * nsel * E + Ptot * nst)


def check_contact_select_fits(ncon: int, nsel: int, Ptot: int,
                              nst: int) -> None:
  """Raise unless K2 takes the selection: one env's block within the 232448
  bytes of shared memory."""
  smem = contact_select_smem_bytes(ncon, nsel, Ptot, nst)
  if smem > _SMEM_LIMIT:
    raise ValueError(
        f'contact_select_lanes kernel: ncon={ncon}, nsel={nsel} with a pair '
        f'table of {Ptot} x {nst} needs {smem} bytes of shared memory at '
        f'E=1 (limit {_SMEM_LIMIT})')


def contact_select_plain(pair_struct: tuple, nsel: int, dist_l, feat_dyn,
                         pair_table):
  """Plain version of K2.  dist_l (ncon, B), feat_dyn (ncon, Fd, B),
  pair_table (Ptot, nst) → (sel (nsel, Fd + nst, B), picks (nsel, B)
  int32)."""
  ncon, Fd, B = feat_dyn.shape
  # ascending dist, lowest index on ties: a stable sort keeps index order
  idx = torch.sort(dist_l, dim=0, stable=True).indices[:nsel]  # (nsel, B)
  dyn = torch.gather(
      feat_dyn, 0, idx[:, None, :].expand(nsel, Fd, B)
  )  # (nsel, Fd, B)
  pair = _slot_pair(pair_struct, idx.device).long()[idx]  # (nsel, B)
  st = pair_table[pair].permute(0, 2, 1)  # (nsel, nst, B)
  return torch.cat([dyn, st], dim=1), idx.to(torch.int32)


def contact_select_backward(pair_struct: tuple, picks, g_sel, ncon: int,
                            Fd: int, Ptot: int):
  """The transpose of K2's gather: the cotangent g_sel (nsel, Fd + nst, B)
  of the picked rows back to the slots of feat_dyn (ncon, Fd, B) and to the
  pair rows of pair_table (Ptot, nst), by ``scatter_add`` and
  ``index_add`` (the transpose of JAX's one-hot matmul, which XLA computes
  there too).  A slot is picked at most once per env; a pair row collects
  from every env."""
  nsel, F, B = g_sel.shape
  idx = picks.long()
  g_feat = torch.zeros((ncon, Fd, B), dtype=g_sel.dtype, device=g_sel.device)
  g_feat.scatter_add_(0, idx[:, None, :].expand(nsel, Fd, B), g_sel[:, :Fd])
  pair = _slot_pair(pair_struct, idx.device).long()[idx]  # (nsel, B)
  g_tab = torch.zeros((Ptot, F - Fd), dtype=g_sel.dtype, device=g_sel.device)
  g_tab.index_add_(0, pair.reshape(-1),
                   g_sel[:, Fd:].permute(0, 2, 1).reshape(nsel * B, F - Fd))
  return g_feat, g_tab


class ContactSelect(torch.autograd.Function):
  """K2 (or its plain version on the CPU) forward, the picks saved;
  ``contact_select_backward`` backward.  The picks are an output that
  carries no gradient."""

  @staticmethod
  def forward(ctx, pair_struct, nsel, dist_l, feat_dyn, pair_table):
    sel, picks = _contact_select(pair_struct, nsel, dist_l, feat_dyn,
                                 pair_table)
    ctx.save_for_backward(picks)
    ctx.pair_struct = pair_struct
    ctx.sizes = (feat_dyn.shape[0], feat_dyn.shape[1], pair_table.shape[0])
    ctx.mark_non_differentiable(picks)
    return sel, picks

  @staticmethod
  def backward(ctx, g_sel, _):
    (picks,) = ctx.saved_tensors
    g_feat, g_tab = contact_select_backward(ctx.pair_struct, picks,
                                            g_sel.contiguous(), *ctx.sizes)
    return None, None, None, g_feat, g_tab


def contact_select_lanes(pair_struct: tuple, nsel: int, dist_l: torch.Tensor,
                         feat_dyn: torch.Tensor, pair_table: torch.Tensor):
  """Top-nsel contact selection and feature gather.

  dist_l (ncon, B); feat_dyn (ncon, Fd, B) per-slot dynamic features;
  pair_table (Ptot, nst) static per-pair columns; pair_struct = static
  ((P, k, off), ...) slot layout of the pair groups.  Returns
  (sel (nsel, Fd + nst, B): row j = features of the j-th nearest slot,
  picks (nsel, B) int32: that slot).

  With grad mode on and feat_dyn or pair_table requiring grad the call goes
  through ``ContactSelect``, whose backward is ``contact_select_backward``;
  dist_l gets no gradient (the order of the picks has none, and the picked
  dists travel in feat_dyn)."""
  if torch.is_grad_enabled() and (feat_dyn.requires_grad
                                  or pair_table.requires_grad):
    return ContactSelect.apply(pair_struct, nsel, dist_l, feat_dyn,
                               pair_table)
  return _contact_select(pair_struct, nsel, dist_l, feat_dyn, pair_table)


def _contact_select(pair_struct, nsel, dist_l, feat_dyn, pair_table):
  ncon, Fd, B = feat_dyn.shape
  dev = dist_l.device
  Ptot, nst = pair_table.shape
  _check('feat_dyn', feat_dyn, (ncon, Fd, B), dist_l)
  _check('dist_l', dist_l, (ncon, B), dist_l)
  _check('pair_table', pair_table, (Ptot, nst), dist_l)
  if sum(P * k for P, k, _ in pair_struct) != ncon:
    raise ValueError('pair_struct does not cover the ncon slots')
  if not 0 < nsel <= ncon:
    raise ValueError(f'nsel {nsel} out of range for ncon {ncon}')
  if _route(dist_l) == 'plain':
    return contact_select_plain(pair_struct, nsel, dist_l, feat_dyn,
                                pair_table)
  check_contact_select_fits(ncon, nsel, Ptot, nst)
  E = envs_per_block(
      lambda E: contact_select_smem_bytes(ncon, nsel, Ptot, nst, E), B,
      _sm_count(dev))
  slot_pair = _slot_pair(pair_struct, dev)
  out = torch.empty((nsel, Fd + nst, B), dtype=torch.float32, device=dev)
  picks = torch.empty((nsel, B), dtype=torch.int32, device=dev)
  LAUNCHES['contact_select_lanes'] += 1
  _launch('contact_select', dist_l.data_ptr(), feat_dyn.data_ptr(),
          pair_table.data_ptr(), slot_pair.data_ptr(), out.data_ptr(),
          picks.data_ptr(), ncon, Fd, nsel, nst, Ptot, B, E, _stream())
  return out, picks


# ---------------------------------------------------------------------------
# K3 — pyramid-basis fixed-iteration Newton solve.
#
# Replaces _newton_kernel_pyr / newton_lanes_pyr_t (linalg_kernels.py:500).
# Solves  min_x ½(x−a0)ᵀM(x−a0) + Σᵢ sᵢ(Jᵢx − arefᵢ)  per env with MuJoCo's
# soft-constraint penalties: structured rows [equality | dof friction |
# limits] through the generic row penalty, contact rows through the
# pyramid basis U = [Jn | μ₁A₁ | …] with the one-sided quadratic.  Fixed
# schedule (iters Newton × ls_iters line-search steps), Tikhonov term
# 1e-6·max diag(H) + 1e-12, pivot clamp 1e-12 with rsqrt, t clipped to
# [0, 4], monotone accept only when Δφ < 0 (so a NaN step is rejected).
# Bound on the H100: fp32 operations outside the tensor cores.  Per env
# and iteration the Hessian alone is nv(nv+1)/2 · (Rs + (naxes+1)·C) MACs
# (210 · 133 on cube-push); the inputs are ≈ 12 KB per env.  Design: a warp
# per env, E envs per block (``envs_per_block``), loaded with the env
# index fastest across threads; Jᵀ, Uᵀ, M and H in shared memory (W = U·S is
# formed in registers); the Hessian from 4 × 4 register tiles of its lower
# triangle; the Cholesky with a lane per row and column-oriented triangular
# solves; shuffle reductions for every sum, no block barrier in the Newton
# loop.  Rows are not padded (the TPU's 8-row tiles have no counterpart).
# ---------------------------------------------------------------------------


def newton_pyr_smem_bytes(nv: int, Rs: int, C: int, naxes: int,
                          E: int = 1) -> int:
  """Shared memory a block of K3 with E envs needs (the layout of
  ``csrc/newton_pyr.cu``).  Per env, in float32 words: Jᵀ (Rs·nvp), Uᵀ
  (NU·nvp), eight dof vectors (nvp), the 128 words of the Jᵀs shares, M and
  H (nv·ldm each), seven structured-row vectors, four basis vectors, Dc and the 1 + 2·naxes
  coefficients per contact, with nvp = nv rounded up to 4, ldm = nv | 1 and
  NU = (naxes + 1)·C, at a stride that is 4 mod 32; plus the two row masks
  once per block."""
  nvp, ldm, NU = (nv + 3) // 4 * 4, nv | 1, (naxes + 1) * C
  words = ((Rs + NU) * nvp + 8 * nvp + _PART_WORDS + 2 * nv * ldm + 7 * Rs
           + 4 * NU + C + C * (1 + 2 * naxes))
  return 4 * (E * _env_stride(words, E) + 2 * Rs)


def check_newton_pyr_fits(nv: int, Rs: int, C: int, naxes: int) -> None:
  """Raise unless K3 takes the system: nv <= 32 (a lane per row of H) and one
  env's working set within the 232448 bytes of shared memory of a block."""
  smem = newton_pyr_smem_bytes(nv, Rs, C, naxes)
  if nv > 32 or smem > _SMEM_LIMIT:
    raise ValueError(
        f'newton_lanes_pyr_t kernel: a system of nv={nv}, Rs={Rs}, C={C}, '
        f'naxes={naxes} needs {smem} bytes of shared memory per env (limit '
        f'{_SMEM_LIMIT}, nv <= 32)')


@functools.cache
def _row_masks(kinds: tuple, device: torch.device, dtype: torch.dtype):
  """Row masks (Rs,) of the static kinds on ``device``, made once and never
  freed (as ``_slot_pair``): one-sided rows (limits, contacts) and
  dof-friction rows."""
  kind_s = np.asarray(kinds)
  onesided = (kind_s == _LIMIT) | (kind_s == _CONTACT)
  fric = kind_s == _FRICTION
  return (torch.tensor(onesided, device=device, dtype=dtype),
          torch.tensor(fric, device=device, dtype=dtype))


def _penalty_se(r, D, floss, ones_m, fric_m):
  """(ŝ', ŝ'') of the piecewise row penalties, all (R, B)."""
  zero = torch.zeros((), dtype=r.dtype, device=r.device)
  grad_q = D * r
  active = (r < 0) | (ones_m <= 0)
  lim = torch.where(fric_m > 0, floss, torch.full_like(floss, 1e30))
  in_quad = torch.abs(grad_q) <= lim
  s_grad = torch.where(in_quad, grad_q, torch.sign(r) * lim)
  s_curv = torch.where(in_quad, D, zero)
  s_grad = torch.where(active, s_grad, zero)
  s_curv = torch.where(active, s_curv, zero)
  inert = (fric_m > 0) & (floss <= 0)
  return torch.where(inert, zero, s_grad), torch.where(inert, zero, s_curv)


def _penalty_cost_rows(r, D, floss, ones_m, fric_m):
  """Per-row penalty cost sᵢ(rᵢ), (R, B)."""
  zero = torch.zeros((), dtype=r.dtype, device=r.device)
  active = (r < 0) | (ones_m <= 0)
  quad = 0.5 * D * r * r
  lim = torch.where(fric_m > 0, floss, torch.full_like(floss, 1e30))
  in_quad = torch.abs(D * r) <= lim
  tail = floss * torch.abs(r) - 0.5 * floss * floss / torch.clamp(D, min=1e-12)
  cost = torch.where(in_quad, quad, tail)
  cost = torch.where(active, cost, zero)
  return torch.where((fric_m > 0) & (floss <= 0), zero, cost)


def newton_pyr_plain(iterations: int, ls_iterations: int, kind_s, Mt, a0t,
                     x0t, Js, arefs, Ds, fls, U, arefU, Dc, naxes: int):
  """Plain version of K3; same arguments and outputs as
  :func:`newton_lanes_pyr_t`."""
  nv, Rs, B = Js.shape
  C = Dc.shape[0]
  dev = Mt.device
  ones_m, fric_m = _row_masks(tuple(np.asarray(kind_s).tolist()), dev,
                              Mt.dtype)
  ones_m, fric_m = ones_m[:, None], fric_m[:, None]
  eye = torch.eye(nv, dtype=Mt.dtype, device=dev)[:, :, None]
  tril = torch.tril(torch.ones(nv, nv, dtype=torch.bool, device=dev))

  mv = lambda A, v: torch.sum(A * v[:, None, :], dim=0)  # (nv,R,B),(nv,B)
  mvT = lambda A, s: torch.sum(A * s[None, :, :], dim=1)  # → (nv, B)
  matvec_M = lambda v: torch.sum(Mt * v[None, :, :], dim=1)
  bsum = lambda a: torch.sum(a, dim=0, keepdim=True)

  def con_se(r):
    act = (r < 0).to(r.dtype)
    return Dc * r * act, Dc * act

  blk = lambda a, k: a[k * C : (k + 1) * C]
  x = x0t
  rs = mv(Js, x) - arefs
  rU = mv(U, x) - arefU

  for _ in range(iterations):
    sg_s, sc_s = _penalty_se(rs, Ds, fls, ones_m, fric_m)
    rho_n = blk(rU, 0)
    sgp, sgm, scp, scm = [], [], [], []
    for i in range(naxes):
      rho_i = blk(rU, 1 + i)
      g, c = con_se(rho_n + rho_i)
      sgp.append(g)
      scp.append(c)
      g, c = con_se(rho_n - rho_i)
      sgm.append(g)
      scm.append(c)
    w = torch.cat([sum(p + q for p, q in zip(sgp, sgm))]
                  + [p - q for p, q in zip(sgp, sgm)], dim=0)
    xa = x - a0t
    grad = matvec_M(xa) + mvT(Js, sg_s) + mvT(U, w)

    S00 = sum(p + q for p, q in zip(scp, scm))
    Un = U[:, 0:C]
    Wn = S00[None] * Un
    Wi = []
    for i in range(naxes):
      Ui = U[:, (1 + i) * C : (2 + i) * C]
      S0i = scp[i] - scm[i]
      Sii = scp[i] + scm[i]
      Wn = Wn + S0i[None] * Ui
      Wi.append(S0i[None] * Un + Sii[None] * Ui)
    Wmat = torch.cat([Wn] + Wi, dim=1)  # (nv, NU, B)
    # H[a, b] = Σ_r J[a,r] c_r J[b,r] + Σ_k W[a,k] U[b,k], taken from the
    # lower triangle (b ≥ a) and mirrored as the TPU kernel does
    P_s = Js * sc_s[None]
    T = (torch.einsum('arb,crb->acb', Js, P_s)
         + torch.einsum('akb,ckb->acb', Wmat, U))
    T = torch.where(tril.T[:, :, None], T, torch.zeros_like(T))
    H = T + T.transpose(0, 1) - eye * T + Mt
    dmax = torch.amax(H * eye, dim=(0, 1), keepdim=True)
    H = H + eye * (1e-6 * dmax + 1e-12)
    cols, djs = _chol_cols(H, 1e-12)
    dx = -_cho_solve_cols(cols, djs, grad)

    mdx = matvec_M(dx)
    jdx_s = mv(Js, dx)
    u = mv(U, dx)
    un = u[0:C]
    g0 = bsum(xa * mdx)
    h0 = bsum(dx * mdx)
    t = torch.ones_like(g0)
    for _ in range(ls_iterations):
      sg, sc = _penalty_se(rs + t * jdx_s, Ds, fls, ones_m, fric_m)
      dphi = g0 + t * h0 + bsum(sg * jdx_s)
      ddphi = h0 + bsum(sc * jdx_s * jdx_s)
      rtn = rho_n + t * un
      for i in range(naxes):
        ui = blk(u, 1 + i)
        rti = blk(rU, 1 + i) + t * ui
        jp, jm = un + ui, un - ui
        gp, cp = con_se(rtn + rti)
        gm, cm = con_se(rtn - rti)
        dphi = dphi + bsum(gp * jp + gm * jm)
        ddphi = ddphi + bsum(cp * jp * jp + cm * jm * jm)
      t = torch.clamp(t - dphi / torch.clamp(ddphi, min=1e-12), 0.0, 4.0)

    s_old = bsum(_penalty_cost_rows(rs, Ds, fls, ones_m, fric_m))
    s_new = bsum(_penalty_cost_rows(rs + t * jdx_s, Ds, fls, ones_m, fric_m))
    rtn = rho_n + t * un
    for i in range(naxes):
      ui = blk(u, 1 + i)
      rho_i = blk(rU, 1 + i)
      rti = rho_i + t * ui
      for r_old, r_new in ((rho_n + rho_i, rtn + rti),
                           (rho_n - rho_i, rtn - rti)):
        s_old = s_old + bsum(0.5 * Dc * r_old * r_old * (r_old < 0))
        s_new = s_new + bsum(0.5 * Dc * r_new * r_new * (r_new < 0))
    accept = (t * g0 + 0.5 * t * t * h0 + s_new - s_old) < 0
    x = torch.where(accept, x + t * dx, x)
    rs = torch.where(accept, rs + t * jdx_s, rs)
    rU = torch.where(accept, rU + t * u, rU)

  sg_s, _ = _penalty_se(rs, Ds, fls, ones_m, fric_m)
  rho_n = blk(rU, 0)
  fc_parts = []
  wf_n = torch.zeros_like(rho_n)
  wf_parts = []
  for i in range(naxes):
    rho_i = blk(rU, 1 + i)
    gp, _ = con_se(rho_n + rho_i)
    gm, _ = con_se(rho_n - rho_i)
    fc_parts += [-gp, -gm]
    wf_n = wf_n + (-gp) + (-gm)
    wf_parts.append((-gp) - (-gm))
  fs = -sg_s
  qf = mvT(Js, fs) + mvT(U, torch.cat([wf_n] + wf_parts, dim=0))
  fc = torch.stack(fc_parts, dim=0).reshape(naxes, 2, C, B)
  return x, _force_rows(fs, fc), qf


def _force_rows(fs, fc):
  """Structured forces (Rs, B) and contact forces grouped [axis, ±,
  contact] (naxes, 2, C, B) → rows [structured | contact, axis, ±]."""
  naxes, _, C, B = fc.shape
  fc = fc.permute(2, 0, 1, 3).reshape(C * 2 * naxes, B)
  return torch.cat([fs, fc], dim=0)


def newton_lanes_pyr_t(iterations: int, ls_iterations: int,
                       kind_s: np.ndarray, Mt, a0t, x0t, Js, arefs, Ds, fls,
                       U, arefU, Dc, naxes: int):
  """Pyramid-basis fixed-iteration Newton solve on lanes-layout inputs.

  Mt (nv, nv, B), a0t/x0t (nv, B); structured rows Js (nv, Rs, B) with
  arefs/Ds/fls (Rs, B) and static kinds ``kind_s`` (Rs,); contact basis
  U (nv, (naxes+1)·C, B) grouped [Jn | μ₁A₁ | …], arefU likewise, Dc (C, B).
  Returns (x (nv, B), force (Rs + 2·naxes·C, B) in row order
  [structured | contact, axis, ±], qfrc (nv, B)).

  The CUDA route takes nv <= 32 and a system whose single env fits the
  232448 bytes of shared memory of a block (``check_newton_pyr_fits``; the
  cube-push system takes 18792 bytes alone and 148904 at E = 8)."""
  nv, Rs, B = Js.shape
  C = Dc.shape[0]
  NU = (naxes + 1) * C
  dev = Mt.device
  for name, t, shape in (
      ('Mt', Mt, (nv, nv, B)), ('a0t', a0t, (nv, B)), ('x0t', x0t, (nv, B)),
      ('Js', Js, (nv, Rs, B)), ('arefs', arefs, (Rs, B)), ('Ds', Ds, (Rs, B)),
      ('fls', fls, (Rs, B)), ('U', U, (nv, NU, B)), ('arefU', arefU, (NU, B)),
      ('Dc', Dc, (C, B))):
    _check(name, t, shape, Mt)
  if len(kind_s) != Rs:
    raise ValueError(f'kind_s has {len(kind_s)} rows, Js has {Rs}')
  if _route(Mt) == 'plain':
    return newton_pyr_plain(iterations, ls_iterations, kind_s, Mt, a0t, x0t,
                            Js, arefs, Ds, fls, U, arefU, Dc, naxes)
  check_newton_pyr_fits(nv, Rs, C, naxes)
  E = envs_per_block(
      lambda E: newton_pyr_smem_bytes(nv, Rs, C, naxes, E), B, _sm_count(dev))
  ones_m, fric_m = _row_masks(tuple(np.asarray(kind_s).tolist()), dev,
                              torch.float32)
  x = torch.empty((nv, B), dtype=torch.float32, device=dev)
  fs = torch.empty((Rs, B), dtype=torch.float32, device=dev)
  fc = torch.empty((naxes, 2, C, B), dtype=torch.float32, device=dev)
  qf = torch.empty((nv, B), dtype=torch.float32, device=dev)
  LAUNCHES['newton_lanes_pyr_t'] += 1
  _launch('newton_pyr', *(a.data_ptr() for a in (
      Mt, a0t, x0t, Js, arefs, Ds, fls, ones_m, fric_m, U, arefU, Dc,
      x, fs, fc, qf)), nv, Rs, C, naxes, int(iterations), int(ls_iterations),
          B, E, _stream())
  return x, _force_rows(fs, fc), qf


# ---------------------------------------------------------------------------
# K4 — generic-row fixed-iteration Newton solve.
#
# Replaces _newton_kernel / _newton_lanes_core (linalg_kernels.py:247, :878):
# the solve of every model without top-k contact selection (the Go2 family),
# and of any model whose contacts were expanded into rows.  Same problem and
# schedule as K3, every row through the generic penalty by its static kind:
# equality two-sided quadratic, dof friction Huber with bound floss (inert
# when floss <= 0), limits and contacts quadratic on r < 0 only.
# Bound on the H100: fp32 operations outside the tensor cores at a deep
# schedule (per env and Newton step the Hessian is nv(nv+1)/2 · R
# multiply-adds), bytes at the Go2 schedule of one step (nv·R + nv² + … words
# read once per env, ≈ 6 KB at nv 18, R 58).  Design: that of K3 without the
# basis (``csrc/newton_common.cuh``): a warp per env, E envs per block loaded
# with the env index fastest across threads, so that the batch-minor arrays
# are read in whole sectors; the Hessian from register tiles; the Cholesky
# and the triangular solves inside the warp (a lane owns rows i and i + 32
# when nv > 32).  Rows are not padded with inert friction rows and the batch
# is not padded with identity systems, as the TPU wrapper did.
# ---------------------------------------------------------------------------


def newton_generic_smem_bytes(nv: int, R: int, E: int = 1) -> int:
  """Shared memory a block of K4 with E envs needs for systems of nv dofs
  and R rows (the layout of ``csrc/newton_generic.cu``).  Per env, in
  float32 words: Jᵀ (R·nvp), eight dof vectors (nvp), the 128 words of the
  Jᵀs shares, M and H (nv·ldm each) and seven row vectors, with nvp = nv rounded up to 4 and ldm = nv | 1, at
  a stride that is 4 mod 32; plus the two row masks once per block."""
  nvp, ldm = (nv + 3) // 4 * 4, nv | 1
  words = R * nvp + 8 * nvp + _PART_WORDS + 2 * nv * ldm + 7 * R
  return 4 * (E * _env_stride(words, E) + 2 * R)


def check_newton_generic_fits(nv: int, R: int) -> None:
  """Raise unless K4 takes a system of nv dofs and R rows: one env's working
  set must fit the 232448 bytes (227 KB) of shared memory of one block, and
  nv <= 64."""
  smem = newton_generic_smem_bytes(nv, R)
  if nv > 64 or smem > _SMEM_LIMIT:
    raise ValueError(
        f'_newton_lanes_core kernel: a system of nv={nv}, R0={R} needs '
        f'{smem} bytes of shared memory per env (limit {_SMEM_LIMIT}, '
        'nv <= 64); reduce the rows with contact selection (max_contacts)')


def newton_generic_plain(kind, iterations: int, ls_iterations: int, Mt, a0t,
                         x0t, Jt, areft, Dt, flt):
  """Plain version of K4; same arguments and outputs as
  :func:`_newton_lanes_core`."""
  nv, R, B = Jt.shape
  dev = Mt.device
  ones_m, fric_m = _row_masks(tuple(np.asarray(kind).tolist()), dev, Mt.dtype)
  ones_m, fric_m = ones_m[:, None], fric_m[:, None]
  eye = torch.eye(nv, dtype=Mt.dtype, device=dev)[:, :, None]
  tril = torch.tril(torch.ones(nv, nv, dtype=torch.bool, device=dev))

  matvec_J = lambda v: torch.sum(Jt * v[:, None, :], dim=0)  # → (R, B)
  matvec_Jt = lambda s: torch.sum(Jt * s[None, :, :], dim=1)  # → (nv, B)
  matvec_M = lambda v: torch.sum(Mt * v[None, :, :], dim=1)
  bsum = lambda a: torch.sum(a, dim=0, keepdim=True)

  x = x0t
  r = matvec_J(x) - areft
  for _ in range(iterations):
    s_grad, s_curv = _penalty_se(r, Dt, flt, ones_m, fric_m)
    xa = x - a0t
    grad = matvec_M(xa) + matvec_Jt(s_grad)
    # H = M + Jᵀ diag(s″) J, from the triangle b ≥ a, mirrored
    T = torch.einsum('arb,crb->acb', Jt, Jt * s_curv[None])
    T = torch.where(tril.T[:, :, None], T, torch.zeros_like(T))
    H = T + T.transpose(0, 1) - eye * T + Mt
    dmax = torch.amax(H * eye, dim=(0, 1), keepdim=True)
    H = H + eye * (1e-6 * dmax + 1e-12)
    cols, djs = _chol_cols(H, 1e-12)
    dx = -_cho_solve_cols(cols, djs, grad)

    mdx = matvec_M(dx)
    jdx = matvec_J(dx)
    g0 = bsum(xa * mdx)
    h0 = bsum(dx * mdx)
    t = torch.ones_like(g0)
    for _ in range(ls_iterations):
      sg, sc = _penalty_se(r + t * jdx, Dt, flt, ones_m, fric_m)
      dphi = g0 + t * h0 + bsum(sg * jdx)
      ddphi = h0 + bsum(sc * jdx * jdx)
      t = torch.clamp(t - dphi / torch.clamp(ddphi, min=1e-12), 0.0, 4.0)
    s_old = bsum(_penalty_cost_rows(r, Dt, flt, ones_m, fric_m))
    s_new = bsum(_penalty_cost_rows(r + t * jdx, Dt, flt, ones_m, fric_m))
    accept = (t * g0 + 0.5 * t * t * h0 + s_new - s_old) < 0
    x = torch.where(accept, x + t * dx, x)
    r = torch.where(accept, r + t * jdx, r)

  s_grad, _ = _penalty_se(r, Dt, flt, ones_m, fric_m)
  force = -s_grad
  return x, force, matvec_Jt(force)


def _newton_lanes_core(kind: np.ndarray, iterations: int, ls_iterations: int,
                       Mt, a0t, x0t, Jt, areft, Dt, flt):
  """Generic-row fixed-iteration Newton solve on lanes-layout inputs.

  Mt (nv, nv, B), a0t/x0t (nv, B), Jt (nv, R, B), areft/Dt/flt (R, B), with
  static row kinds ``kind`` (R,).  Returns (x (nv, B), force (R, B),
  qfrc (nv, B)).

  The kernel keeps the systems of a block's E envs in shared memory
  (``envs_per_block``): one env's ``newton_generic_smem_bytes(nv, R)``
  must not exceed 232448 bytes (227 KB), and nv must not exceed 64; past
  either the CUDA route raises (``check_newton_generic_fits``).  nv 18 with
  R 58 takes 10624 bytes alone and 82512 at E = 8, nv 20 with R 181 takes
  25512 and 194088, and at nv 20 the largest R that fits is 1964 at E = 1 and
  225 at E = 8."""
  nv, R, B = Jt.shape
  dev = Mt.device
  for name, t, shape in (
      ('Mt', Mt, (nv, nv, B)), ('a0t', a0t, (nv, B)), ('x0t', x0t, (nv, B)),
      ('Jt', Jt, (nv, R, B)), ('areft', areft, (R, B)), ('Dt', Dt, (R, B)),
      ('flt', flt, (R, B))):
    _check(name, t, shape, Mt)
  if len(kind) != R:
    raise ValueError(f'kind has {len(kind)} rows, Jt has {R}')
  if _route(Mt) == 'plain':
    return newton_generic_plain(kind, iterations, ls_iterations, Mt, a0t, x0t,
                                Jt, areft, Dt, flt)
  check_newton_generic_fits(nv, R)
  E = envs_per_block(
      lambda E: newton_generic_smem_bytes(nv, R, E), B, _sm_count(dev))
  ones_m, fric_m = _row_masks(tuple(np.asarray(kind).tolist()), dev,
                              torch.float32)
  x = torch.empty((nv, B), dtype=torch.float32, device=dev)
  force = torch.empty((R, B), dtype=torch.float32, device=dev)
  qf = torch.empty((nv, B), dtype=torch.float32, device=dev)
  LAUNCHES['_newton_lanes_core'] += 1
  _launch('newton_generic', *(a.data_ptr() for a in (
      Mt, a0t, x0t, Jt, areft, Dt, flt, ones_m, fric_m, x, force, qf)),
          nv, R, int(iterations), int(ls_iterations), B, E, _stream())
  return x, force, qf


def newton_solve_lanes(kind: np.ndarray, iterations: int, ls_iterations: int,
                       M, a0, x0, J_l, aref_l, D_l, floss_l):
  """K4 with batch-major dof arrays and a lanes-layout constraint system:
  M (B, nv, nv), a0/x0 (B, nv), J_l (nv, R0, B), aref_l/D_l/floss_l
  (R0, B).  Returns (x, force, qfrc) batch-major.  Counterpart of JAX's
  ``newton_solve_lanes`` (linalg_kernels.py:977); where the JAX solver asks
  ``newton_kernel_fits`` this raises (``check_newton_generic_fits``)."""
  nv, R0, _ = J_l.shape
  check_newton_generic_fits(nv, R0)
  c = lambda a: a.contiguous()
  xt, ft, qft = _newton_lanes_core(
      kind, iterations, ls_iterations, c(M.permute(1, 2, 0)), c(a0.t()),
      c(x0.t()), c(J_l), c(aref_l), c(D_l), c(floss_l))
  return xt.t(), ft.t(), qft.t()


def newton_solve_batched(kind: np.ndarray, iterations: int,
                         ls_iterations: int, M, a0, x0, J, aref, D, floss):
  """K4 on batch-major systems: M (B, nv, nv), a0/x0 (B, nv), J (B, R0, nv),
  aref/D/floss (B, R0), static row kinds ``kind`` (R0,).  Returns (x, force,
  qfrc) batch-major.  Counterpart of JAX's ``newton_solve_batched``
  (linalg_kernels.py:1009), which the solve of ``solver`` calls."""
  return newton_solve_lanes(kind, iterations, ls_iterations, M, a0, x0,
                            J.permute(2, 1, 0), aref.t(), D.t(), floss.t())


# ---------------------------------------------------------------------------
# K5 — the generic route's contact rows of the constraint assembly.
#
# Replaces no TPU kernel: the JAX lanes assembly expands the contacts into
# pyramid rows with array operations that XLA fuses inside the step's jit,
# which the port ran as eager ATen kernels over full (contacts, nv, B)
# tensors (~14 GB of traffic a substep on the Go2 full scene).  Each contact
# gives its rows after the structured ones, grouped by condim, contact-major,
# then friction axis, then ±: Jn for condim 1, Jn ± μᵢ·axisᵢ for condim 3,
# 4 and 6; with each row's aref, D and floss (0).  Bound on the H100: the
# write of J, 191 MB of its 324 contact rows on the full scene at B 8192
# (0.088 ms at 3.35 TB/s with the 104 MB else it reads and writes).
# Design: 32 envs a block with the env
# index fastest across lanes, so every store of a (dof, row) entry is one
# 128-byte run; the block's cdof, anchors and qvel staged once in shared
# memory; its warps take the contacts in turn, a contact's rows and their
# J·qvel sums in registers, so J is written once and never read back.
# ---------------------------------------------------------------------------

# the condims MuJoCo admits, each compiled into K5
_ROW_CONDIMS = (1, 3, 4, 6)


class RowSpec(NamedTuple):
  """Static layout of a model's generic contact rows.  ``groups``: the
  (condim, slots) of each condim group in row order, slots a long tensor or
  ``slice(None)``; ``tab`` (nc, 3) int32 on the device: each contact's
  slot, first row (from the first contact row) and condim, in the same
  order; ``n_rows``: the contact rows."""

  groups: tuple
  tab: torch.Tensor
  n_rows: int


def assemble_rows_plain(spec: RowSpec, impratio: float, qvel, cdof,
                        cdof_anchor, dist, pos, frame, friction, solref,
                        solimp, invweight, dmask, J, aref, D, floss) -> None:
  """Plain version of K5; same arguments as :func:`assemble_rows`.  The
  velocities J·qvel are summed over every row of J, as the assembly
  summed them before K5 (on the CPU the rounding of that sum depends on
  the shape summed), so the rows equal the former assembly's bit for
  bit."""
  nv, B = qvel.shape
  r0 = J.shape[1] - spec.n_rows
  bc = lambda x: x.expand(x.shape[:-1] + (B,))
  c_friction, c_solref, c_solimp, c_invw = (
      bc(x) for x in (friction, solref, solimp, invweight))
  Jn, friction_axes = _C.contact_jacobians(cdof, cdof_anchor, pos, frame,
                                           dmask)
  J_blocks, pos_blocks, sr_blocks, si_blocks, diagA_blocks = [], [], [], [], []
  for cd, sel_g in spec.groups:
    g = lambda x: x[sel_g]
    k = g(dist).shape[0]
    if cd == 1:
      J_blocks.append(g(Jn).transpose(0, 1))  # (nv, k, B)
      pos_blocks.append(g(dist))
      sr_blocks.append(g(c_solref))
      si_blocks.append(g(c_solimp))
      diagA_blocks.append(g(c_invw))
      continue
    nf = cd - 1
    axes = friction_axes(nf)
    Jn_g = g(Jn)
    rows = []
    for i in range(nf):
      mu_i = g(c_friction[:, i])[:, None, :]  # (k, 1, B)
      ax = g(axes[i])
      rows.append(Jn_g + mu_i * ax)
      rows.append(Jn_g - mu_i * ax)
    nrep = nf * 2
    rows = torch.stack(rows, dim=1).reshape(k * nrep, nv, B)
    J_blocks.append(rows.transpose(0, 1))  # (nv, k·nrep, B)
    rep = lambda x: torch.repeat_interleave(x, nrep, dim=0)
    pos_blocks.append(rep(g(dist)))
    sr_blocks.append(rep(g(c_solref)))
    si_blocks.append(rep(g(c_solimp)))
    mu0 = g(c_friction[:, 0])
    diagA_blocks.append(rep(
        g(c_invw) * 2.0 * torch.clamp(mu0 * mu0, min=_C._MJ_MINVAL)
        / impratio))
  J[:, r0:] = torch.cat(J_blocks, dim=1)
  pos_r = torch.cat(pos_blocks, dim=0)
  zrow = torch.zeros_like(pos_r)
  zero = torch.zeros((), dtype=pos_r.dtype, device=pos_r.device)
  onesided = torch.ones((pos_r.shape[0], 1), dtype=torch.bool,
                        device=pos_r.device)
  vel = torch.sum(J * qvel[:, None, :], dim=0)[r0:]
  aref[r0:], D[r0:] = _C.soft_rows(
      vel, pos_r, zrow, torch.cat(sr_blocks), torch.cat(si_blocks),
      torch.cat(diagA_blocks), onesided, zero)
  floss[r0:] = zrow


def check_assemble_rows_fits(nv: int) -> None:
  """Raise unless K5 takes nv dofs: nv <= 64 (the block's staged cdof,
  anchors and qvel, 1280·nv bytes, within its shared memory)."""
  if nv > 64:
    raise ValueError(f'assemble_rows kernel takes nv <= 64, got {nv}')


def assemble_rows(spec: RowSpec, impratio: float, qvel, cdof, cdof_anchor,
                  dist, pos, frame, friction, solref, solimp, invweight,
                  dmask, J, aref, D, floss) -> None:
  """The contacts' generic rows, written into the last ``spec.n_rows`` rows
  of J (nv, R, B), aref, D, floss (R, B).

  qvel (nv, B), cdof (nv, 6, B), cdof_anchor (nv, 3, B); per contact slot
  dist (ncon, B), pos (ncon, 3, B), frame (ncon, 9, B) and its parameters
  friction (ncon, 5, ·), solref (ncon, 2, ·), solimp (ncon, 5, ·),
  invweight (ncon, ·) and dof mask dmask (ncon, nv, ·), each with a
  trailing axis of B (per env) or 1 (shared); ``impratio`` the model's.
  The CUDA route takes nv <= 64 and condims 1, 3, 4 and 6; its J equals
  the plain version's bit for bit (up to the sign of a zero), its aref the
  plain one's up to the order of the nv-term sum J·qvel."""
  nv, B = qvel.shape
  ncon, R, n = dist.shape[0], J.shape[1], spec.n_rows
  for name, t, shape in (
      ('qvel', qvel, (nv, B)), ('cdof', cdof, (nv, 6, B)),
      ('cdof_anchor', cdof_anchor, (nv, 3, B)), ('dist', dist, (ncon, B)),
      ('pos', pos, (ncon, 3, B)), ('frame', frame, (ncon, 9, B)),
      ('J', J, (nv, R, B)), ('aref', aref, (R, B)), ('D', D, (R, B)),
      ('floss', floss, (R, B))):
    _check(name, t, shape, qvel)
  for name, t, width in (('friction', friction, (5,)),
                         ('solref', solref, (2,)), ('solimp', solimp, (5,)),
                         ('invweight', invweight, ()), ('dmask', dmask, (nv,))):
    if t.shape[-1] not in (1, B):
      raise ValueError(f'{name}: trailing axis {t.shape[-1]}, expected 1 '
                       f'or {B}')
    _check(name, t, (ncon,) + width + (t.shape[-1],), qvel)
  if n > R:
    raise ValueError(f'{n} contact rows do not fit the {R} rows of J')
  r0 = R - n
  if _route(qvel) == 'plain':
    assemble_rows_plain(spec, impratio, qvel, cdof, cdof_anchor, dist, pos,
                        frame, friction, solref, solimp, invweight, dmask, J,
                        aref, D, floss)
    return
  check_assemble_rows_fits(nv)
  bad = sorted({cd for cd, _ in spec.groups} - set(_ROW_CONDIMS))
  if bad:
    raise ValueError(f'assemble_rows kernel takes condims {_ROW_CONDIMS}, '
                     f'got {bad}')
  tab = spec.tab
  if (tab.dtype != torch.int32 or tab.device != qvel.device
      or tab.dim() != 2 or tab.shape[1] != 3 or not tab.is_contiguous()):
    raise ValueError('spec.tab must be a contiguous (nc, 3) int32 tensor on '
                     f'{qvel.device}')
  inv_imp = float(np.float32(1.0) / np.float32(impratio))
  LAUNCHES['assemble_rows'] += 1
  _launch('assemble_rows', tab.data_ptr(), *(t.data_ptr() for t in (
      qvel, cdof, cdof_anchor, dist, pos, frame, friction, solref, solimp,
      invweight, dmask, J, aref, D, floss)), tab.shape[0], nv, R, r0, B,
          *(t.shape[-1] for t in (friction, solref, solimp, invweight,
                                  dmask)), inv_imp, _stream())


class AssembleRows(torch.autograd.Function):
  """K5 (its plain version on the CPU) into fresh rows (J (nv, n_rows, B),
  aref, D, floss (n_rows, B)); backward the VJP of
  ``assemble_rows_plain`` recomputed from the saved inputs, so the gradient
  is that of the plain expansion.  No benchmark cell runs this path: its
  one caller is the tuning gradient's recomputation
  (``fwd_fused.FusedRegion.backward``).  A hand-written backward waits for
  a cell that measures that gradient (``cube_push.tune``)."""

  @staticmethod
  def forward(ctx, spec, impratio, *inputs):
    ctx.set_materialize_grads(False)
    outs = _fresh_rows(spec, inputs[0])
    assemble_rows(spec, impratio, *inputs, *outs)
    ctx.save_for_backward(*inputs)
    ctx.spec, ctx.impratio = spec, impratio
    ctx.mark_non_differentiable(outs[3])
    return outs

  @staticmethod
  def backward(ctx, *cts):
    needs = ctx.needs_input_grad[2:]
    inputs = [t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, needs)]
    with torch.enable_grad():
      outs = _fresh_rows(ctx.spec, inputs[0])
      assemble_rows_plain(ctx.spec, ctx.impratio, *inputs, *outs)
    pairs = [(o, c) for o, c in zip(outs[:3], cts[:3])
             if c is not None and o.requires_grad]
    wrt = [t for t, n in zip(inputs, needs) if n]
    if not pairs or not wrt:
      return (None,) * (2 + len(needs))
    grads = iter(torch.autograd.grad(
        [o for o, _ in pairs], wrt, [c for _, c in pairs], allow_unused=True))
    return (None, None) + tuple(next(grads) if n else None for n in needs)


def _fresh_rows(spec: RowSpec, qvel):
  """Zeroed (J (nv, n_rows, B), aref, D, floss (n_rows, B)) like qvel."""
  nv, B = qvel.shape
  n = spec.n_rows
  return (qvel.new_zeros((nv, n, B)),) + tuple(
      qvel.new_zeros((n, B)) for _ in range(3))


def contact_rows(spec: RowSpec, impratio: float, *args) -> None:
  """``assemble_rows`` that carries gradients: with grad mode on and an
  input requiring grad, the rows come from ``AssembleRows`` and are copied
  into the outputs' last rows; else ``assemble_rows`` writes them there
  itself (no tensor saved, one launch on a card)."""
  inputs, outs = args[:11], args[11:]
  if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
    rows = AssembleRows.apply(spec, impratio, *inputs)
    r0 = outs[0].shape[1] - spec.n_rows
    J, aref, D, floss = outs
    for out, x in zip((J[:, r0:], aref[r0:], D[r0:], floss[r0:]), rows):
      out.copy_(x)
    return
  assemble_rows(spec, impratio, *args)
