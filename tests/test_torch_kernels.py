"""The port's kernel functions against the JAX package's Pallas kernels.

Each of K1 (SPD solve), K2 (top-k contact selection) and K3 (pyramid-basis
Newton solve) takes (K4, the generic-row Newton solve, is held in
tests/test_torch_go2_stages.py) the same numpy-seeded inputs, at the main path's shapes
with a small batch, through the JAX wrapper (Pallas in interpret mode, the
code the TPU runs) and through the port's wrapper on CPU tensors, which
takes the kernel's plain PyTorch version.  The CUDA kernels themselves are
held against the same plain versions on the card by ``chip_smoke.py``; the
last test does that here too when a card is present.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk

NV, B = 20, 3
NSEL, NCON, PAIRS, K = 24, 480, 30, 16  # cube-push: 30 box pairs × 16 slots
RS, NAXES = 37, 3  # structured rows: 1 equality, 20 dof friction, 16 limits
KIND_S = np.array([0] + [1] * 20 + [2] * 16, np.int32)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
  monkeypatch.setattr(jlk, '_INTERPRET', True)


def _spd(rng, n, b):
  R = rng.normal(size=(b, n, n)).astype(np.float32)
  A = R @ np.swapaxes(R, 1, 2) / n + 0.05 * np.eye(n, dtype=np.float32)
  return np.ascontiguousarray(np.transpose(A, (1, 2, 0)))  # (n, n, B)


def test_spd_solve_matches_jax():
  """K1; rtol 1e-4 (fp32 Cholesky, other summation order)."""
  rng = np.random.default_rng(0)
  A = _spd(rng, NV, B)
  b = rng.normal(size=(NV, B)).astype(np.float32)
  xj = np.asarray(jlk.spd_solve_lanes(jnp.asarray(A), jnp.asarray(b)))
  xp = plk.spd_solve_lanes(torch.from_numpy(A), torch.from_numpy(b)).numpy()
  np.testing.assert_allclose(xp, xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())
  x64 = np.linalg.solve(np.transpose(A, (2, 0, 1)).astype(np.float64),
                        b.T.astype(np.float64)[..., None])[..., 0].T
  np.testing.assert_allclose(xp, x64, rtol=1e-3, atol=1e-3 * np.abs(x64).max())


def _selection_inputs(rng, ties: bool):
  dist = rng.uniform(-0.01, 0.3, size=(NCON, B)).astype(np.float32)
  if ties:
    # most slots far apart and equal, several exact ties at the minimum
    dist = np.round(dist * 20) / 20
    dist[[7, 40, 41, 300], :] = -0.01
  feat = rng.normal(size=(NCON, 13, B)).astype(np.float32)
  table = rng.normal(size=(PAIRS, 13 + NV)).astype(np.float32)
  return dist.astype(np.float32), feat, table


@pytest.mark.parametrize('ties', [False, True])
def test_contact_select_matches_jax_exactly(ties):
  """K2: the selected rows must be identical, in lax.top_k order
  (ascending dist, lowest slot index first on ties)."""
  rng = np.random.default_rng(1 + ties)
  dist, feat, table = _selection_inputs(rng, ties)
  pair_struct = ((PAIRS, K, 0),)
  sj = np.asarray(jlk.contact_select_lanes(
      pair_struct, NSEL, jnp.asarray(dist), jnp.asarray(feat), table))
  sp, picks = plk.contact_select_lanes(
      pair_struct, NSEL, torch.from_numpy(dist), torch.from_numpy(feat),
      torch.from_numpy(table))
  sp = sp.numpy()
  assert sp.shape == (NSEL, 13 + 13 + NV, B)
  np.testing.assert_array_equal(sp, sj)
  # the picks are lax.top_k's indices, in its order (+ 0.0 turns the
  # rounding's -0 into +0: top_k orders the two, the kernels do not)
  _, top = jax.lax.top_k(-(jnp.asarray(dist).T + 0.0), NSEL)
  assert picks.dtype == torch.int32
  np.testing.assert_array_equal(picks.numpy(), np.asarray(top).T)
  if ties:  # the four tied minima come first, by slot index
    np.testing.assert_array_equal(sp[:4, :13], feat[[7, 40, 41, 300]])


def _newton_inputs(rng, nv=NV, b=B):
  NV, B = nv, b
  f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
  C = NSEL
  M = _spd(rng, NV, B) + 0.5 * np.eye(NV, dtype=np.float32)[:, :, None]
  fls = np.where(KIND_S[:, None] == 1,
                 rng.uniform(0.0, 2.0, size=(RS, B)), 0.0)
  fls[5] = 0.0  # an inert friction row
  Dc = rng.uniform(1.0, 50.0, size=(C, B))
  Dc[::5] = 0.0  # separated contacts
  return dict(
      Mt=f32(M), a0t=f32(rng.normal(size=(NV, B))),
      x0t=f32(0.1 * rng.normal(size=(NV, B))),
      Js=f32(0.5 * rng.normal(size=(NV, RS, B))),
      arefs=f32(rng.normal(size=(RS, B))),
      Ds=f32(rng.uniform(1.0, 50.0, size=(RS, B))), fls=f32(fls),
      U=f32(0.3 * rng.normal(size=(NV, (NAXES + 1) * C, B))),
      arefU=f32(rng.normal(size=((NAXES + 1) * C, B))), Dc=f32(Dc),
  )


U32 = 2.0 ** -24  # unit roundoff of float32


def _k3_phi(a64, x):
  """The objective K3 minimises, per env, in float64: ½(x−a0)ᵀM(x−a0) plus
  the structured rows' penalties and the contact pyramid's."""
  Mt, a0t, _, Js, arefs, Ds, fls, U, arefU, Dc = a64
  ones_m, fric_m = plk._row_masks(tuple(KIND_S.tolist()), x.device,
                                  torch.float64)
  xa = x - a0t
  phi = 0.5 * (xa * (Mt * xa[None]).sum(1)).sum(0)
  rs = (Js * x[:, None]).sum(0) - arefs
  phi = phi + plk._penalty_cost_rows(rs, Ds, fls, ones_m[:, None],
                                     fric_m[:, None]).sum(0)
  rU = (U * x[:, None]).sum(0) - arefU
  for i in range(NAXES):
    ri = rU[(1 + i) * NSEL:(2 + i) * NSEL]
    for r in (rU[:NSEL] + ri, rU[:NSEL] - ri):
      phi = phi + (0.5 * Dc * r * r * (r < 0)).sum(0)
  return phi


def _k3_held(a64, x, force, qfrc, tol_phi, x64):
  """Worst error/tolerance of one fp32 result of K3's schedule, per env,
  under the criteria of chip_smoke.py's K3 check, φ two-sided (so that an
  x64 short of the minimum shows too): |φ(x) − φ(x64)| <= tol_phi;
  force within 1024·u·D(Σ|J||x| + |aref|) of the force of x itself (the
  plain version run 0 steps from x in float64); qfrc within
  64·u·(|J|ᵀ|f| + |U|ᵀ|w|) of Jᵀf + Uᵀw(f)."""
  Js, arefs, Ds, U, arefU, Dc = (a64[i] for i in (3, 4, 5, 7, 8, 9))
  x, force, qfrc = (torch.from_numpy(np.array(o)).double()
                    for o in (x, force, qfrc))
  f_x = plk.newton_pyr_plain(0, 6, KIND_S, a64[0], a64[1], x,
                             *a64[3:], NAXES)[1]
  ax = x.abs()[:, None]
  s_rows = Ds * ((Js.abs() * ax).sum(0) + arefs.abs())
  rU = (U.abs() * ax).sum(0) + arefU.abs()
  s_con = torch.stack([Dc * (rU[:NSEL] + rU[(1 + i) * NSEL:(2 + i) * NSEL])
                       for i in range(NAXES)], dim=1)
  s_con = s_con[:, :, None].expand(NSEL, NAXES, 2, B).reshape(-1, B)
  tol_f = 1024 * U32 * torch.cat([s_rows, s_con]) + 1e-30
  fs = force[:RS]
  fc = force[RS:].reshape(NSEL, NAXES, 2, B)
  w = torch.cat([(fc[:, :, 0] + fc[:, :, 1]).sum(1)]
                + [fc[:, i, 0] - fc[:, i, 1] for i in range(NAXES)])
  proj = (Js * fs[None]).sum(1) + (U * w[None]).sum(1)
  tol_q = 64 * U32 * ((Js.abs() * fs.abs()[None]).sum(1)
                      + (U.abs() * w.abs()[None]).sum(1)) + 1e-30
  return (((_k3_phi(a64, x) - _k3_phi(a64, x64)).abs() / tol_phi).max().item(),
          ((force - f_x).abs() / tol_f).max().item(),
          ((qfrc - proj).abs() / tol_q).max().item())


def test_newton_pyr_matches_jax():
  """K3, the fixed 6 × 6 schedule, the port's plain version and the JAX
  kernel (interpret mode) alike held to the float64 solve (the plain
  version in float64), env by env.  x is held by the objective φ it
  reaches, |φ(x) − φ(x64)| <= 1e-6·φ(x0), with force and qfrc those of x to
  fp32 rounding (_k3_held): the last Newton steps change φ by amounts at
  fp32 rounding level, and the Δφ < 0 accept that fp32 rounding rejects
  and float64 accepts leaves x where φ is flat to second order (on one
  machine's CPU the port's x parted from JAX's by 2.36e-4 in one of 60
  entries with φ within 6e-9·φ(x0); an elementwise 1e-4 of scale failed).
  Where φ's Hessian at x64 is well conditioned (condition number <= 1e3),
  x is also held elementwise to x64 within the radius that the φ tolerance
  allows there, √(2·1e-6·φ(x0)/λmin)."""
  inp = _newton_inputs(np.random.default_rng(3))
  names = ('Mt', 'a0t', 'x0t', 'Js', 'arefs', 'Ds', 'fls', 'U', 'arefU', 'Dc')
  outj = jlk.newton_lanes_pyr_t(
      6, 6, KIND_S, *(jnp.asarray(inp[k]) for k in names), NAXES)
  outp = plk.newton_lanes_pyr_t(
      6, 6, KIND_S, *(torch.from_numpy(inp[k]) for k in names), NAXES)
  a64 = [torch.from_numpy(inp[k]).double() for k in names]
  x64 = plk.newton_pyr_plain(6, 6, KIND_S, *a64, NAXES)[0]
  tol_phi = 1e-6 * _k3_phi(a64, a64[2])

  # λ of φ's Hessian at x64, env by env
  lam = []
  for b in range(B):
    def phi_b(xb, b=b):
      return _k3_phi(a64, torch.cat([x64[:, :b], xb[:, None],
                                     x64[:, b + 1:]], 1))[b]
    lam.append(torch.linalg.eigvalsh(
        torch.autograd.functional.hessian(phi_b, x64[:, b].clone())))
  lam = torch.stack(lam)  # (B, nv), ascending
  conditioned = lam[:, -1] <= 1e3 * lam[:, 0]
  assert conditioned.any()
  radius = torch.sqrt(2 * tol_phi / lam[:, 0])

  for who, outs in (('port', outp), ('jax', outj)):
    for name, o, shape in zip(('x', 'force', 'qfrc'), outs,
                              ((NV, B), (RS + 2 * NAXES * NSEL, B), (NV, B))):
      o = np.asarray(o)
      assert o.shape == shape and np.isfinite(o).all(), (who, name)
    ratios = _k3_held(a64, *outs, tol_phi, x64)
    assert max(ratios) <= 1.0, (who, 'phi/force/qfrc', ratios)
    dx = (torch.from_numpy(np.array(outs[0])).double() - x64).abs().amax(0)
    assert (dx[conditioned] <= radius[conditioned]).all(), (who, dx, radius)


def test_spd_solve_reads_one_triangle():
  """K1's contract in both packages: x depends on the triangle A[a][b >= a]
  alone.  Other finite values in the strict other triangle (finite: both
  plain forms mask with ``* 0``, so a NaN there would spread) leave x bit
  for bit the same, in the JAX kernel (interpret mode) and in the port's
  plain version.  The CUDA kernel loads that triangle only."""
  rng = np.random.default_rng(5)
  A = _spd(rng, NV, B)
  b = rng.normal(size=(NV, B)).astype(np.float32)
  A2 = A.copy()
  lo = np.tril_indices(NV, -1)  # (a, b) with a > b: never read
  A2[lo] = rng.normal(size=(len(lo[0]), B)).astype(np.float32) * 7.0
  assert not np.array_equal(A, A2)
  xj, xj2 = (np.asarray(jlk.spd_solve_lanes(jnp.asarray(a), jnp.asarray(b)))
             for a in (A, A2))
  np.testing.assert_array_equal(xj2, xj)
  xp, xp2 = (plk.spd_solve_plain(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy()
             for a in (A, A2))
  np.testing.assert_array_equal(xp2, xp)
  # and the triangle that is read does reach x
  A3 = A.copy()
  A3[0, 1] *= 1.5
  assert not np.array_equal(plk.spd_solve_plain(
      torch.from_numpy(A3), torch.from_numpy(b)).numpy(), xp)


# -- the kernels' shared-memory layout and envs per block ----------------------

SMEM_LIMIT = 232448  # bytes one block may use on sm_90


def _layout_terms(source: str, **env) -> list:
  """The ``o += <expr>;`` terms of the ``Layout`` struct of a kernel's
  source, evaluated with the sizes in ``env``."""
  src = open(os.path.join(plk.cuda_build.CSRC, source)).read()
  body = src[src.index('struct Layout'):src.index('words = o;')]
  terms = re.findall(r'o \+= ([^;]+);', body)
  return [eval(t, {}, env) for t in terms]  # C and Python agree here


def _layout_words(source: str, **dims) -> int:
  """Words of one env's working set, read from the ``Layout`` struct of a
  Newton kernel's source."""
  nv = dims['nv']
  env = dict(dims, nvp=(nv + 3) // 4 * 4, ldm=nv | 1, kPartWords=128)
  if 'naxes' in dims:
    env['NU'] = (dims['naxes'] + 1) * dims['C']
  terms = _layout_terms(source, **env)
  assert len(terms) > 15
  return sum(terms)


def _largest(fits) -> int:
  """The largest n >= 1 with fits(n), fits monotone."""
  lo, hi = 1, 2
  while fits(hi):
    lo, hi = hi, 2 * hi
  while hi - lo > 1:
    mid = (lo + hi) // 2
    lo, hi = (mid, hi) if fits(mid) else (lo, mid)
  return lo


@pytest.mark.parametrize('E, nbytes', [(1, 18792), (2, 37448), (4, 74600),
                                       (8, 148904)])
def test_newton_pyr_smem_bytes(E, nbytes):
  """K3's block of E envs at the cube-push shape (nv 20, Rs 37, C 24,
  naxes 3): the bytes, their agreement with the Layout struct of the CUDA
  source, the stride rule (4 mod 32 words for E > 1, so that the E envs'
  copies of an element fall into different banks), and the largest C that
  still fits at this E."""
  assert plk.newton_pyr_smem_bytes(NV, RS, NSEL, NAXES, E) == nbytes
  words = _layout_words('newton_pyr.cu', nv=NV, Rs=RS, C=NSEL, naxes=NAXES)
  stride = (nbytes // 4 - 2 * RS) // E
  assert stride >= words and stride - words < (4 if E == 1 else 32)
  assert stride % 4 == 0 and (E == 1 or stride % 32 == 4)
  fits = lambda C: plk.newton_pyr_smem_bytes(NV, RS, C, NAXES, E) <= SMEM_LIMIT
  assert _largest(fits) == {1: 537, 2: 258, 4: 118, 8: 49}[E]


def test_newton_pyr_size_guard():
  """K3's guard of the CUDA route: nv <= 32 (a lane per row of H) and one
  env within the shared memory of a block; it names the sizes.  The CPU
  route has no such limit."""
  plk.check_newton_pyr_fits(NV, RS, NSEL, NAXES)
  plk.check_newton_pyr_fits(32, RS, 355, NAXES)  # the last C that fits
  with pytest.raises(ValueError, match=r'nv=32, Rs=37, C=356'):
    plk.check_newton_pyr_fits(32, RS, 356, NAXES)
  with pytest.raises(ValueError, match=r'nv=33'):
    plk.check_newton_pyr_fits(33, RS, NSEL, NAXES)


@pytest.mark.parametrize('case, B, n_sm, expect', [
    ('cube-push K3', 2048, 132, 8),
    ('K3 small batch: a block for every SM comes first', 600, 132, 4),
    ('K3 ragged batch', 2045, 132, 8),
    ('K3 tiny batch', 8, 132, 1),
    ('K3 wide contacts: E = 8 does not fit', 2048, 132, 4),
    ('K3 one env only', 100000, 132, 1),
    ('K3 nothing fits', 2048, 132, None),
])
def test_newton_envs_per_block(case, B, n_sm, expect):
  """E is the largest of 8, 4, 2, 1 whose block fits 232448 bytes and
  leaves no SM without a block; 1 when the batch is too small for that."""
  C = {'K3 wide contacts: E = 8 does not fit': 60, 'K3 one env only': 300,
       'K3 nothing fits': 600}.get(case, NSEL)
  smem = lambda E: plk.newton_pyr_smem_bytes(NV, RS, C, NAXES, E)
  if expect is None:
    with pytest.raises(ValueError, match='shared memory'):
      plk.envs_per_block(smem, B, n_sm)
    return
  E = plk.envs_per_block(smem, B, n_sm)
  assert E == expect
  assert smem(E) <= SMEM_LIMIT
  assert E == 1 or -(-B // E) >= n_sm


def _stride(words: int, E: int) -> int:
  """The stride rule of csrc/lanes_common.cuh, written out again."""
  return -(-words // 4) * 4 if E == 1 else (words + 27) // 32 * 32 + 4


@pytest.mark.parametrize('n, E, nbytes', [
    (20, 1, 1920), (20, 8, 15488), (18, 1, 1584), (18, 8, 13440),
    (32, 8, 36992), (7, 4, 1600), (20, 32, 0)])
def test_spd_solve_smem_bytes(n, E, nbytes):
  """K1's block of E envs: the bytes and their agreement with the Layout
  struct of the CUDA source; E = 32 is the thread-per-env route, which uses
  no shared memory.  The widest system at E = 8 stays under the 48 KB a
  kernel may use without asking."""
  assert plk.spd_solve_smem_bytes(n, E) == nbytes
  if E == 32:
    return
  terms = _layout_terms('spd_solve.cu', n=n, ld=n | 1)
  assert len(terms) == 4
  assert nbytes == 4 * E * _stride(sum(terms), E)
  assert plk.spd_solve_smem_bytes(32, 8) <= 48 * 1024


@pytest.mark.parametrize('E, nbytes', [(1, 6072), (2, 8216), (4, 12472),
                                       (8, 20984)])
def test_contact_select_smem_bytes(E, nbytes):
  """K2's block of E envs at the cube-push shape (480 slots, 24 picks, a
  pair table of 30 x 33): the bytes and their agreement with the Layout
  struct of the CUDA source (the dist tile E * S, then the terms)."""
  ptot, nst = PAIRS, 13 + NV
  assert plk.contact_select_smem_bytes(NCON, NSEL, ptot, nst, E) == nbytes
  terms = _layout_terms('contact_select.cu', nsel=NSEL, E=E, Ptot=ptot,
                        nst=nst)
  assert len(terms) == 3
  assert nbytes == 4 * (E * _stride(NCON, E) + sum(terms))


@pytest.mark.parametrize('case, size, B, expect', [
    ('K1 cube-push', 20, 2048, 8),
    ('K1 Go2: a warp of 32 envs for every SM', 18, 8192, 32),
    ('K1 132 warps of 32', 20, 4193, 32),
    ('K1 131 warps of 32', 20, 4192, 8),
    ('K1 no thread-per-env route at this width', 7, 8192, 8),
    ('K1 ragged', 20, 2045, 8),
    ('K1 small batch', 20, 600, 4),
    ('K1 tiny', 20, 5, 1),
    ('K2 cube-push', NCON, 2048, 8),
    ('K2 ragged', NCON, 2045, 8),
    ('K2 small batch', NCON, 300, 2),
    ('K2 tiny', NCON, 5, 1),
    ('K2 wide: E = 8 does not fit', 10000, 2048, 4),
])
def test_envs_per_block_k1_k2(case, size, B, expect):
  """The same chooser for K1 (size: n) and K2 (size: ncon) on the 132 SMs
  of an H100: the largest E whose block fits and leaves no SM without a
  block.  K1 adds E = 32, its thread-per-env route, at the widths compiled
  in."""
  n_sm = 132
  if case.startswith('K1'):
    assert plk.spd_solve_envs_per_block(size, B, n_sm) == expect
    return
  smem = lambda E: plk.contact_select_smem_bytes(size, NSEL, PAIRS, 33, E)
  E = plk.envs_per_block(smem, B, n_sm)
  assert E == expect
  assert smem(E) <= SMEM_LIMIT and (E == 8 or smem(2 * E) > SMEM_LIMIT
                                    or -(-B // (2 * E)) < n_sm)


def test_spd_solve_thread_widths_match_source():
  """The widths at which the chooser may return E = 32 are those for which
  the launcher of csrc/spd_solve.cu instantiates the thread-per-env kernel,
  and the warp-per-env kernel has the same widths in registers."""
  src = open(os.path.join(plk.cuda_build.CSRC, 'spd_solve.cu')).read()
  thread = sorted(int(n) for n in re.findall(
      r'spd_solve_thread_kernel<(\d+)><<<', src))
  warp = sorted(int(n) for n in re.findall(
      r'n == \d+ \? spd_solve_kernel<(\d+)>', src))
  assert thread == sorted(plk._SPD_THREAD_WIDTHS) == warp
  for n in thread:
    assert re.search(rf'n == {n}\)\s+spd_solve_thread_kernel<{n}>', src)


def test_spd_solve_size_guard():
  """K1's guard of the CUDA route: n <= 32 (a lane per row); the CPU route
  has no such limit."""
  plk.check_spd_solve_fits(32)
  with pytest.raises(ValueError, match=r'n <= 32, got 33'):
    plk.check_spd_solve_fits(33)
  rng = np.random.default_rng(6)
  A, b = _spd(rng, 33, 2), rng.normal(size=(33, 2)).astype(np.float32)
  x = plk.spd_solve_lanes(torch.from_numpy(A), torch.from_numpy(b))
  assert x.shape == (33, 2) and bool(torch.isfinite(x).all())


def test_contact_select_size_guard():
  """K2's guard of the CUDA route names the sizes: one env's dist tile, the
  picks and the pair table must fit the shared memory of a block."""
  fits = lambda ncon: plk.contact_select_smem_bytes(
      ncon, NSEL, PAIRS, 33) <= SMEM_LIMIT
  last = _largest(fits)
  assert last == 57072
  plk.check_contact_select_fits(NCON, NSEL, PAIRS, 33)
  plk.check_contact_select_fits(last, NSEL, PAIRS, 33)
  with pytest.raises(
      ValueError, match=r'ncon=57073, nsel=24 .* 30 x 33 needs 232456 bytes'):
    plk.check_contact_select_fits(last + 1, NSEL, PAIRS, 33)


def _assert_k1_close(xk, xp):
  """K1 against its plain version, env by env:
  max|k - p| <= 1e-5 * max|p| + 1e-6 (the criterion of chip_smoke.py)."""
  assert xk.shape == xp.shape and bool(torch.isfinite(xk).all())
  err, ref = (xk - xp).abs().amax(0), xp.abs().amax(0)
  assert bool((err <= 1e-5 * ref + 1e-6).all())


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
  """The CUDA kernels against their plain versions on the card."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  rng = np.random.default_rng(4)
  dev = 'cuda'
  A = torch.from_numpy(_spd(rng, NV, 256)).to(dev)
  b = torch.from_numpy(rng.normal(size=(NV, 256)).astype(np.float32)).to(dev)
  xk, xp = plk.spd_solve_lanes(A, b), plk.spd_solve_plain(A, b)
  _assert_k1_close(xk, xp)
  dist, feat, table = _selection_inputs(rng, True)
  args = (((PAIRS, K, 0),), NSEL, torch.from_numpy(dist).to(dev),
          torch.from_numpy(feat).to(dev), torch.from_numpy(table).to(dev))
  for k, p in zip(plk.contact_select_lanes(*args),
                  plk.contact_select_plain(*args)):
    assert torch.equal(k, p)
  inp = _newton_inputs(rng)
  names = ('Mt', 'a0t', 'x0t', 'Js', 'arefs', 'Ds', 'fls', 'U', 'arefU', 'Dc')
  a = [torch.from_numpy(inp[k]).to(dev) for k in names]
  for k, p in zip(plk.newton_lanes_pyr_t(1, 6, KIND_S, *a, NAXES),
                  plk.newton_pyr_plain(1, 6, KIND_S, *a, NAXES)):
    assert (k - p).abs().max().item() <= 1e-4 * p.abs().max().item()
  a = a[:7]  # K4 on the structured rows alone
  for k, p in zip(plk._newton_lanes_core(KIND_S, 1, 5, *a),
                  plk.newton_generic_plain(KIND_S, 1, 5, *a)):
    assert (k - p).abs().max().item() <= 1e-4 * p.abs().max().item()
  # a ragged batch (13 envs: no multiple of any E) at nv 20 and nv 18, the
  # two widths compiled in, and nv 7, the width-at-run-time route
  for nv in (NV, 18, 7):
    A = torch.from_numpy(_spd(rng, nv, 13)).to(dev)
    b = torch.from_numpy(rng.normal(size=(nv, 13)).astype(np.float32)).to(dev)
    xk, xp = plk.spd_solve_lanes(A, b), plk.spd_solve_plain(A, b)
    assert xk.shape == xp.shape
    _assert_k1_close(xk, xp)
    inp = _newton_inputs(rng, nv=nv, b=13)
    a = [torch.from_numpy(inp[k]).to(dev) for k in names]
    for k, p in zip(plk.newton_lanes_pyr_t(1, 6, KIND_S, *a, NAXES),
                    plk.newton_pyr_plain(1, 6, KIND_S, *a, NAXES)):
      assert k.shape == p.shape
      assert (k - p).abs().max().item() <= 1e-4 * p.abs().max().item()
    for k, p in zip(plk._newton_lanes_core(KIND_S, 1, 5, *a[:7]),
                    plk.newton_generic_plain(KIND_S, 1, 5, *a[:7])):
      assert k.shape == p.shape
      assert (k - p).abs().max().item() <= 1e-4 * p.abs().max().item()
  # K1's thread-per-env route (a batch that gives every SM a warp), ragged
  for nv in (NV, 18):
    A = torch.from_numpy(_spd(rng, nv, 8189)).to(dev)
    b = torch.from_numpy(rng.normal(size=(nv, 8189)).astype(np.float32)).to(dev)
    xk, xp = plk.spd_solve_lanes(A, b), plk.spd_solve_plain(A, b)
    _assert_k1_close(xk, xp)
  # K2 on the ragged batch, and at 100 slots (no multiple of 32) with ties
  for ncon, pairs, k in ((NCON, PAIRS, K), (100, 25, 4)):
    dist = np.round(rng.uniform(-0.01, 0.3, size=(ncon, 13)) * 20) / 20
    feat = rng.normal(size=(ncon, 13, 13)).astype(np.float32)
    table = rng.normal(size=(pairs, 13 + NV)).astype(np.float32)
    args = (((pairs, k, 0),), NSEL,
            torch.from_numpy(dist.astype(np.float32)).to(dev),
            torch.from_numpy(feat).to(dev), torch.from_numpy(table).to(dev))
    for k, p in zip(plk.contact_select_lanes(*args),
                    plk.contact_select_plain(*args)):
      assert torch.equal(k, p)
