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
  sp = plk.contact_select_lanes(
      pair_struct, NSEL, torch.from_numpy(dist), torch.from_numpy(feat),
      torch.from_numpy(table)).numpy()
  assert sp.shape == (NSEL, 13 + 13 + NV, B)
  np.testing.assert_array_equal(sp, sj)
  if ties:  # the four tied minima come first, by slot index
    np.testing.assert_array_equal(sp[:4, :13], feat[[7, 40, 41, 300]])


def _newton_inputs(rng):
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


def test_newton_pyr_matches_jax():
  """K3, the fixed 6 × 6 schedule; rtol 1e-4 relative to each output's
  scale (fp32 reductions in another order)."""
  inp = _newton_inputs(np.random.default_rng(3))
  names = ('Mt', 'a0t', 'x0t', 'Js', 'arefs', 'Ds', 'fls', 'U', 'arefU', 'Dc')
  outj = jlk.newton_lanes_pyr_t(
      6, 6, KIND_S, *(jnp.asarray(inp[k]) for k in names), NAXES)
  outp = plk.newton_lanes_pyr_t(
      6, 6, KIND_S, *(torch.from_numpy(inp[k]) for k in names), NAXES)
  for name, j, p in zip(('x', 'force', 'qfrc'), outj, outp):
    j, p = np.asarray(j), p.numpy()
    assert p.shape == j.shape, name
    assert np.isfinite(p).all(), name
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-4 * np.abs(j).max(),
                               err_msg=name)


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
  assert (xk - xp).abs().max().item() <= 1e-4 * xp.abs().max().item()
  dist, feat, table = _selection_inputs(rng, True)
  args = (((PAIRS, K, 0),), NSEL, torch.from_numpy(dist).to(dev),
          torch.from_numpy(feat).to(dev), torch.from_numpy(table).to(dev))
  assert torch.equal(plk.contact_select_lanes(*args),
                     plk.contact_select_plain(*args))
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
