"""The port's physics for the remaining Go2 tasks against the JAX package.

1. Every pair group of the narrow phase that the feet-only Go2 scene and
   the cube do not run (plane_capsule, plane_box, sphere_sphere,
   sphere_capsule, sphere_box, capsule_capsule, capsule_box), on seeded
   geometry in lanes layout with the special cases at the front: parallel
   and near-parallel capsules (the ``abs(denom) > 1e-9`` branch),
   coincident sphere centres (a zero normal) and capsule ends below the
   plane.  Tolerance, of each output's scale: 1e-6 in fp32, 1e-12 in
   float64 (both packages run the same elementwise ops).
2. The heightfield collider on the reference heights, with spheres inside
   the grid, past each of its four edges, on grid lines and on a grid
   corner, under a moved and turned heightfield; same tolerances.
3. The two new snapshots (full-collision and rough scene) against the JAX
   env models: every field exact, the pair tables with their condims, the
   keyframes, the heights and the row layout (nefc 366 and 58); and each
   committed file against a fresh build.
4. One substep of the full-collision scene from seeded deep-contact states
   (random orientation and joints, trunk 8-20 cm up, so that capsules
   press into the floor and legs into each other) against JAX's own route
   there, ``jax.vmap(chain)`` with ``solver._newton_forward`` (JAX leaves
   its lanes route because ``newton_kernel_fits(18, 366)`` is False).
   float64: every output within 1e-8 of its scale.  fp32: kinematics and
   contact distances within 1e-5 of scale of JAX's fp32, the new qpos
   within 1e-5 of the float64 step's, and the solve's x held by its cost:
   φ(x) within 1e-6·|φ(x0)| of φ at the float64 solve (φ the float64
   system's cost), and no higher than φ at JAX's fp32 solve plus that
   tolerance.  JAX's fp32 route parts from float64 in one env of four
   here (1.6e-4·|φ(x0)|); the port's fp32 does not.
5. One CPU PPO step of ``Go2Getup`` at a tiny width through the CLI: finite
   losses, K1 and K4 on every substep (the settle's 125 included), and a
   ``final_params.pkl`` that the JAX package serves, in a process where
   ``import torch`` fails, to the port's actions (rtol 1e-5).
6. The rough-terrain joystick: 3 control steps of the flat joystick policy
   from a JAX reset against JAX's lanes route with the Pallas kernels in
   interpret mode, as tests/test_torch_go2_slice.py runs flat ground.
7. Domain randomisation: the Go2 randomiser on the full and the rough
   scene (the floor found by name), one DR step of each on the CPU, and
   one DR control step of handstand against JAX's, the JAX randomiser's
   fields carried in.  JAX's per-env route on the full scene batches any
   leaf, so no field is added on the JAX side (tests/test_torch_dr.py has
   to, for JAX's lanes route).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu import physics as jphysics
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.physics import collision as jcol
from rsr_mjx_tpu.physics import constraint as jC
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.train import configs as jconfigs
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import ppo as jppo
from rsr_mjx_tpu.train import running_statistics as jrs
from rsr_mjx_tpu.train import sac as jsac
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch import physics as pphysics
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.envs.go2 import snapshot
from rsr_mjx_tpu_torch.physics import collision as pcol
from rsr_mjx_tpu_torch.physics import constraint as pC
from rsr_mjx_tpu_torch.physics import io as pio
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.physics import types as pT
from rsr_mjx_tpu_torch.train import cli as pcli
from rsr_mjx_tpu_torch.train import configs as pconfigs
from rsr_mjx_tpu_torch.train import networks as pnets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL, ROUGH = 'Go2Getup', 'Go2JoystickRoughTerrain'
B = 4
TOL = {'float32': 1e-6, 'float64': 1e-12}


def _x64(dtype: str) -> None:
  if dtype == 'float64':
    jax.config.update('jax_enable_x64', True)  # conftest restores it


def _rotations(rng, n):
  """(3, 3, n) rotation matrices from seeded unit quaternions."""
  q = rng.normal(size=(n, 4))
  w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


def _axis_turn(m, angle):
  """m (3, 3, n) turned by ``angle`` about each frame's own x axis."""
  angle = np.broadcast_to(angle, m.shape[-1:])
  c, s = np.cos(angle), np.sin(angle)
  o, z = np.ones_like(c), np.zeros_like(c)
  rot = np.array([[o, z, z], [z, c, -s], [z, s, c]])
  return np.einsum('ijn,jkn->ikn', m, rot)


def _geometry(group, rng, P=24):
  """Seeded (p1, m1, s1, p2, m2, s2) of P pairs x B envs, float64 numpy:
  positions (3, P, B), frames (3, 3, P, B), sizes (3, P, B).  The first
  columns hold the special cases."""
  n = P * B
  m1 = _rotations(rng, n)
  m2 = _rotations(rng, n)
  p1 = rng.uniform(-0.3, 0.3, size=(3, n))
  size = lambda: np.stack([rng.uniform(0.01, 0.08, n),
                           rng.uniform(0.02, 0.15, n),
                           rng.uniform(0.02, 0.1, n)])
  s1, s2 = size(), size()
  p2 = p1 + rng.uniform(-0.2, 0.2, size=(3, n))
  k = B  # special cases take the first pair of every env
  t1, t2 = group.split('_')
  if t2 == 'capsule' and t1 == 'capsule':
    # parallel, near-parallel, and crossing capsules side by side
    m2[:, :, 0:k] = m1[:, :, 0:k]
    m2[:, :, k:2 * k] = _axis_turn(m1[:, :, k:2 * k], 1e-5)
    m2[:, :, 2 * k:3 * k] = _axis_turn(m1[:, :, 2 * k:3 * k], 3e-4)
    p2[:, 0:3 * k] = p1[:, 0:3 * k] + 0.5 * rng.uniform(
        -0.1, 0.1, size=(3, 3 * k))
  if t1 == 'sphere':
    p2[:, 0:k] = p1[:, 0:k]  # coincident centres
    if t2 == 'capsule':  # a sphere centre on the capsule's axis
      p2[:, k:2 * k] = p1[:, k:2 * k] - 0.3 * s2[1, k:2 * k] * m2[:, 2,
                                                                  k:2 * k]
  if t1 == 'plane':
    # capsule and box ends below the plane, sphere centres in it
    p2[:, 0:k] = p1[:, 0:k] + 0.01 * m1[:, 2, 0:k]
  shape = lambda a: a.reshape(a.shape[:-1] + (P, B))
  return tuple(shape(a) for a in (p1, m1, s1, p2, m2, s2))


def _jax_lists(arrs, dtype):
  p1, m1, s1, p2, m2, s2 = (jnp.asarray(a, dtype) for a in arrs)
  v = lambda a: [a[i] for i in range(3)]
  mm = lambda a: [[a[i, j] for j in range(3)] for i in range(3)]
  return v(p1), mm(m1), v(s1), v(p2), mm(m2), v(s2)


def _torch_lists(arrs, dtype):
  p1, m1, s1, p2, m2, s2 = (torch.from_numpy(a.astype(dtype)) for a in arrs)
  v = lambda a: [a[i] for i in range(3)]
  mm = lambda a: [[a[i, j] for j in range(3)] for i in range(3)]
  return v(p1), mm(m1), v(s1), v(p2), mm(m2), v(s2)


def _slot_arrays(slots, make_frame):
  """(dist, pos, frame) of every slot, each numpy with a leading slot axis;
  the frames as the collider builds them."""
  out = []
  for dist, pos, n in slots:
    frame = make_frame(n)
    out.append((np.asarray(dist), np.stack([np.asarray(x) for x in pos]),
                np.stack([np.stack([np.asarray(x) for x in row])
                          for row in frame])))
  return [np.stack([o[i] for o in out]) for i in range(3)]


def _close(p, j, tol, name):
  scale = max(1.0, float(np.abs(j).max()))
  np.testing.assert_allclose(p, j, rtol=0, atol=tol * scale, err_msg=name)


# -- 1. the pair groups ---------------------------------------------------------


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
@pytest.mark.parametrize('group', [
    'plane_capsule', 'plane_box', 'sphere_sphere', 'sphere_capsule',
    'sphere_box', 'capsule_capsule', 'capsule_box'])
def test_pair_group_matches_jax(group, dtype):
  _x64(dtype)
  seed = sorted(pio.GROUP_NCON).index(group)
  arrs = _geometry(group, np.random.default_rng(seed))
  jslots = jcol._GROUP_FN[group](*_jax_lists(arrs, dtype))
  pslots = pcol._GROUP_FN[group](*_torch_lists(arrs, dtype))
  assert len(pslots) == len(jslots) == pio.GROUP_NCON[group]
  j = _slot_arrays(jslots, jcol._make_frame)
  p = _slot_arrays(pslots, pcol._make_frame)
  for name, pp, jj in zip(('dist', 'pos', 'frame'), p, j):
    assert pp.dtype == np.dtype(dtype) and pp.shape == jj.shape, name
    assert np.isfinite(pp).all(), name
    _close(pp, jj, TOL[dtype], f'{group} {name}')
  dist = p[0]
  assert (dist < 0).any() and (dist > 0).any()  # both regimes are seen
  if group == 'sphere_sphere':  # coincident centres: a zero normal
    assert (p[2][0, 0, :, 0] == 0).all()


# -- 2. the heightfield -----------------------------------------------------------


@pytest.fixture(scope='module')
def rough_models():
  return jenvs.load(ROUGH).model, penvs.load(ROUGH, device='cpu').model


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_hfield_sphere_matches_jax(rough_models, dtype):
  _x64(dtype)
  jm, pm = rough_models
  tbl = dict(pm.pairs)['hfield_sphere']
  hgeom = int(tbl[0, 0])
  feet = tbl[:, 1]
  nb = 16
  rng = np.random.default_rng(3)
  ncol = int(pm.hfield_ncol[0])
  size = pm.hfield_size[0]
  gxpos = np.zeros((pm.ngeom, 3, nb))
  gxmat = np.tile(np.eye(3)[None, :, :, None], (pm.ngeom, 1, 1, nb))
  # the heightfield moved and turned in half of the envs
  gxpos[hgeom, :, nb // 2:] = rng.uniform(-1, 1, size=(3, nb // 2))
  gxmat[hgeom, :, :, nb // 2:] = _axis_turn(
      np.tile(np.eye(3)[..., None], (1, 1, nb // 2)),
      rng.uniform(-0.2, 0.2, nb // 2))
  # feet (in the field's frame) inside, past each edge, on grid lines and
  # on the far corner, 1-3 cm about the surface
  grid = lambda k: (2.0 * k / (ncol - 1) - 1.0) * size[0]
  local = rng.uniform(-9.5, 9.5, size=(len(feet), 3, nb))
  local[:, 2] = rng.uniform(0.0, 0.1, size=(len(feet), nb))
  local[0, 0, 0:4] = [10.5, -10.5, 3.0, -3.0]
  local[0, 1, 0:4] = [2.0, -2.0, 10.5, -10.5]
  local[1, 0, 0:4] = [grid(0), grid(17), grid(128), grid(255)]
  local[1, 1, 0:4] = [grid(40), grid(255), grid(0), grid(128)]
  local[2, :2, 0:2] = [[size[0], size[0]], [-size[1], size[1]]]
  local = local.astype(np.float32).astype(np.float64)
  for i, g in enumerate(feet):
    gxpos[g] = gxpos[hgeom] + np.einsum('ijn,jn->in', gxmat[hgeom], local[i])
  radius = np.asarray(jm.geom_size)[:, :, None]

  cfg = jcol._cfg_of(jm)
  jslots = jcol._hfield_sphere_lanes(
      cfg, jnp.asarray(jm.hfield_data, dtype), jnp.asarray(gxpos, dtype),
      jnp.asarray(gxmat, dtype), jnp.asarray(radius, dtype),
      dict(jm.pairs)['hfield_sphere'].arr)
  jd = np.concatenate([np.asarray(s[0]) for s in jslots])
  jpos = np.stack([np.concatenate([np.asarray(s[1][i]) for s in jslots])
                   for i in range(3)])
  jn = np.stack([np.concatenate([np.asarray(s[2][i]) for s in jslots])
                 for i in range(3)])
  pmd = pm if dtype == 'float32' else pm.to('cpu', torch.float64)
  t = lambda a: torch.from_numpy(a.astype(dtype))
  (pd, ppos, pn), = pcol._hfield_sphere(pmd, tbl, t(radius), t(gxpos),
                                        t(gxmat))
  _close(pd.numpy(), jd, TOL[dtype], 'dist')
  _close(torch.stack(ppos).numpy(), jpos, TOL[dtype], 'pos')
  _close(torch.stack(pn).numpy(), jn, TOL[dtype], 'normal')
  assert pd.shape == (len(feet), nb) and pd.dtype == getattr(torch, dtype)
  assert (pd < 0).any() and (pd > 0).any()
  # the terrain is not flat: normals tilt
  assert (torch.stack(pn)[2] < 1 - 1e-4).any()


# -- 3. the snapshots -------------------------------------------------------------


def _np(x):
  return None if x is None else np.asarray(x)


@pytest.mark.parametrize('name,task,nefc,groups', [
    (FULL, 'full_flat', 366, {'plane_sphere': 4, 'plane_capsule': 26,
                              'sphere_sphere': 6, 'sphere_capsule': 24,
                              'capsule_capsule': 70}),
    (ROUGH, 'rough_terrain', 58, {'hfield_sphere': 4}),
])
def test_snapshot_matches_jax(name, task, nefc, groups):
  jenv = jenvs.load(name)
  penv = penvs.load(name, device='cpu')
  jm, pm = jenv.model, penv.model
  for f in pT.SIZE_FIELDS + ('ncon', 'ncon_sel'):
    assert getattr(pm, f) == getattr(jm, f), f
  for f in pT.OPT_TENSOR_FIELDS:
    np.testing.assert_array_equal(_np(getattr(pm.opt, f)),
                                  _np(getattr(jm.opt, f)), err_msg=f)
  for f in pT.OPT_STATIC_FIELDS:
    assert getattr(pm.opt, f) == getattr(jm.opt, f), f
  for f in pT.NUMERIC_FIELDS:
    x, y = _np(pm.numeric[f]), _np(getattr(jm, f))
    assert (x is None) == (y is None), f
    if x is not None:
      np.testing.assert_array_equal(x, y, err_msg=f)
  for f in pT.STATIC_FIELDS:
    np.testing.assert_array_equal(pm.static[f], getattr(jm, f).arr,
                                  err_msg=f)
  assert [n for n, _ in pm.pairs] == [n for n, _ in jm.pairs]
  for (_, x), (_, y) in zip(pm.pairs, jm.pairs):
    np.testing.assert_array_equal(x, y.arr)  # geoms and condim
  assert {n: len(t) for n, t in pm.pairs if len(t)} == groups
  assert {k: v for k, v in pm.names.items() if k != 'key'} == {
      k: dict(v) for k, v in jm.names}
  # the keyframes, as the JAX envs take them (jp.array: float32)
  for key in ('home', 'handstand', 'footstand', 'pre_recovery'):
    for read in ('keyframe_qpos', 'keyframe_ctrl'):
      np.testing.assert_array_equal(
          getattr(penv, read)(key),
          getattr(jenv, read)(key).astype(np.float32), err_msg=key)
  pl, jl = pC.layout_cached(pm), jC.layout_cached(jm)
  assert (pl.nefc, pl.n_fri, pl.n_lim) == (nefc, 18, 24)
  assert (pl.nefc, pl.n_eq, pl.n_fri, pl.n_lim, pl.n_con) == (
      jl.nefc, jl.n_eq, jl.n_fri, jl.n_lim, jl.n_con)
  np.testing.assert_array_equal(pl.kind, jl.kind)
  assert pC.contact_condims(pm) == jC.contact_condims(jm)
  if task == 'full_flat':
    cd = np.bincount(pC.contact_condims(pm))
    assert (cd[1], cd[3]) == (100, 56)  # self-collision pairs, floor slots
  else:
    assert pm.hfield_data.shape == (256 * 256,)
    from rsr_mjx_tpu_torch.envs.go2 import scene
    np.testing.assert_array_equal(
        pm.hfield_data.numpy(),
        scene.reference_heightfield().astype(np.float32))
  # the committed file is what a fresh build writes
  committed = pio.load_model_npz(snapshot.path(task), device='cpu')
  fresh = snapshot.build(task)
  for f in pT.NUMERIC_FIELDS:
    x, y = _np(committed.numeric[f]), _np(fresh.numeric[f])
    assert (x is None) == (y is None), f
    if x is not None:
      np.testing.assert_array_equal(x, y, err_msg=f)
  for f in pT.STATIC_FIELDS:
    np.testing.assert_array_equal(committed.static[f], fresh.static[f],
                                  err_msg=f)
  for (n1, x), (n2, y) in zip(committed.pairs, fresh.pairs):
    assert n1 == n2
    np.testing.assert_array_equal(x, y)
  assert committed.names == fresh.names


# -- 4. one full-collision substep -------------------------------------------------


@pytest.fixture(scope='module')
def full_models():
  jm = jenvs.load(FULL).model
  pm = penvs.load(FULL, device='cpu').model
  return jm, pm


def _deep_contact_states(jm):
  """Seeded states: random orientation and joints (two envs with the legs
  folded into each other), trunk low, random velocities and targets
  (float32 numpy)."""
  rng = np.random.default_rng(0)
  lo, hi = np.asarray(jm.jnt_range)[1:].T
  qpos = np.zeros((B, 19))
  qpos[:, 2] = rng.uniform(0.08, 0.2, B)
  q = rng.normal(size=(B, 4))
  qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
  qpos[:, 7:] = rng.uniform(lo, hi, (B, 12))
  # the first two envs fold their legs inwards, into each other
  qpos[:2, 7:] = np.tile([0.8, 0.9, -1.8, -0.8, 0.9, -1.8], 2)
  qpos[0, [8, 11, 14, 17]] = 2.0
  qvel = rng.uniform(-1, 1, (B, 18))
  ctrl = qpos[:, 7:] + rng.uniform(-0.3, 0.3, (B, 12))
  return tuple(x.astype(np.float32) for x in (qpos, qvel, ctrl))


def _jax_step(jm, states, dtype):
  if dtype == 'float64':
    jm = jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, jm)
  jdt = jnp.dtype(dtype)

  def one(qpos, qvel, ctrl):
    d = jphysics.make_data(jm, dtype=jdt).replace(qpos=qpos, qvel=qvel,
                                                  ctrl=ctrl)
    return jphysics.step(jm, d)

  out = jax.jit(jax.vmap(one))(*(x.astype(dtype) for x in states))
  return jax.tree.map(np.asarray, out)


def _port_step(pm, states, dtype, record=None):
  dt = getattr(torch, dtype)
  pm = pm.to('cpu', dt)
  qpos, qvel, ctrl = (torch.from_numpy(x).to(dt) for x in states)
  d = pphysics.make_data(pm, B).replace(qpos=qpos, qvel=qvel, ctrl=ctrl)
  if record is None:
    return pphysics.step(pm, d)
  real = plk._newton_lanes_core

  def recorded(kind, it, ls, *args):
    record['system'] = (kind,) + args
    record['schedule'] = (it, ls)
    return real(kind, it, ls, *args)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(plk, '_newton_lanes_core', recorded)
    return pphysics.step(pm, d)


def _phi(system, x):
  """The solve's cost at x (nv, B) on the recorded float64 system."""
  kind, M, a0, _, J, aref, D, fl = system
  ones_m, fric_m = plk._row_masks(tuple(np.asarray(kind).tolist()), M.device,
                                  M.dtype)
  xa = x - a0
  quad = 0.5 * torch.sum(xa * torch.sum(M * xa[None], dim=1), dim=0)
  r = torch.sum(J * x[:, None, :], dim=0) - aref
  return quad + torch.sum(plk._penalty_cost_rows(
      r, D, fl, ones_m[:, None], fric_m[:, None]), dim=0)


FIELDS = ('qpos', 'qvel', 'qacc', 'xpos', 'geom_xpos', 'site_xpos', 'qM',
          'qfrc_bias', 'qfrc_smooth', 'qacc_smooth', 'efc_force',
          'qfrc_constraint', 'sensordata')


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
def test_full_scene_substep_matches_jax(full_models, dtype):
  _x64(dtype)
  jm, pm = full_models
  states = _deep_contact_states(jm)
  jd = _jax_step(jm, states, dtype)
  rec = {}
  pd = _port_step(pm, states, dtype, record=rec if dtype == 'float32' else
                  None)
  # the states are deep: floor slots and self-collision slots penetrate
  _, _, condim = pcol.contact_static_ids(pm)
  dist = pd.contact.dist
  assert (dist[:, condim == 3] < 0).sum(1).min() >= 4
  assert (dist[:2, condim == 1] < 0).sum(1).min() >= 2
  assert rec.get('schedule', (1, 5)) == (1, 5)
  if dtype == 'float64':
    for f in FIELDS + ('contact.dist',):
      j = jd.contact.dist if f == 'contact.dist' else getattr(jd, f)
      p = (pd.contact.dist if f == 'contact.dist' else getattr(pd, f))
      _close(p.numpy(), j, 1e-8, f)
    return
  # kinematics and the narrow phase (of the state the step starts from)
  # against JAX's fp32
  for f in ('xpos', 'geom_xpos', 'site_xpos', 'contact.dist'):
    j = jd.contact.dist if f == 'contact.dist' else getattr(jd, f)
    p = pd.contact.dist if f == 'contact.dist' else getattr(pd, f)
    _close(p.numpy(), j, 1e-5, f)
  # the solve, by its cost on the float64 system (Go2 is Euler without
  # damping: the integrator's qacc is the solve's x); the new state against
  # the float64 step, which the float64 case holds to JAX's
  rec64 = {}
  pd64 = _port_step(pm, states, 'float64', record=rec64)
  _close(pd.qpos.double().numpy(), pd64.qpos.numpy(), 1e-5, 'qpos')
  system = rec64['system']
  x0, x64 = system[3], pd64.qacc.t()
  phi0, phi64 = _phi(system, x0), _phi(system, x64)
  phi_p = _phi(system, pd.qacc.double().t())
  phi_j = _phi(system, torch.from_numpy(np.array(jd.qacc)).double().t())
  assert ((phi_p - phi64).abs() <= 1e-6 * phi0.abs()).all(), (
      (phi_p - phi64) / phi0.abs())
  # no worse than JAX's fp32 route (as tests/test_fused_solve.py holds the
  # JAX kernel to its XLA solve); JAX's fp32 solve parts from float64 by
  # 1.6e-4 of φ(x0) in env 1 here
  assert (phi_p <= phi_j + 1e-6 * phi0.abs()).all(), (phi_p, phi_j)
  assert (phi64 < phi0).all()


# -- 5. one PPO step of getup ---------------------------------------------------------


# The JAX package's deterministic Go2 policy on a port-written pickle, in a
# process where ``import torch`` fails.
_JAX_READER = r'''
import sys
sys.modules['torch'] = None  # any import of torch now raises ImportError
import jax, numpy as np
from rsr_mjx_tpu.train import networks, ppo, running_statistics, sac
params = sac.load_params(sys.argv[1])
net = networks.make_ppo_networks(
    {'state': (42,), 'privileged_state': (91,)}, 12,
    policy_hidden_layer_sizes=(16, 16), value_hidden_layer_sizes=(16, 16),
    policy_obs_key='state', value_obs_key='privileged_state')
policy = ppo._make_policy_factory(net, running_statistics.normalize)(
    params, deterministic=True)
obs = dict(np.load(sys.argv[2]))
np.save(sys.argv[3], np.asarray(policy(obs, jax.random.PRNGKey(0))[0]))
'''


def test_getup_ppo_step_and_checkpoint(tmp_path, monkeypatch):
  calls = dict.fromkeys(('spd_solve_plain', 'newton_generic_plain'), 0)
  for name in calls:
    real = getattr(plk, name)

    def counted(*a, _real=real, _name=name):
      calls[_name] += 1
      return _real(*a)

    monkeypatch.setattr(plk, name, counted)
  table = pconfigs.ppo_config

  def tiny(env_name):
    cfg = table(env_name)
    cfg.network_factory.update(policy_hidden_layer_sizes=(16, 16),
                               value_hidden_layer_sizes=(16, 16))
    return cfg

  monkeypatch.setattr(pconfigs, 'ppo_config', tiny)
  logdir = tmp_path / 'getup'
  _, (norm, net), metrics = pcli.main([
      '--env', 'Go2Getup', '--device', 'cpu', '--logdir', str(logdir),
      '--num_timesteps', '4', '--num_envs', '2', '--batch_size', '2',
      '--num_minibatches', '1', '--unroll_length', '2',
      '--num_updates_per_batch', '1', '--episode_length', '3',
      '--num_evals', '0'])
  assert all(np.isfinite(v) for v in metrics.values())
  for k in ('training/policy_loss', 'training/v_loss',
            'training/entropy_loss'):
    assert k in metrics and metrics[k] != 0, k
  # the reset's forward and 125 settle substeps, then one unroll of 2
  # control steps of 5 substeps: one K1 and one K4 each
  assert calls == {'spd_solve_plain': 136, 'newton_generic_plain': 136}
  assert net.value.layers[0].in_features == 91
  pkl = str(logdir / 'final_params.pkl')
  normalizer, params = pnets.load_ppo_params(pkl)
  rng = np.random.default_rng(0)
  obs = {k: (normalizer.mean[k] + normalizer.std[k]
             * rng.normal(size=(8,) + normalizer.mean[k].shape)
             ).astype(np.float32) for k in ('state', 'privileged_state')}
  assert obs['state'].shape == (8, 42)
  np.savez(tmp_path / 'obs.npz', **obs)
  env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=ROOT)
  done = subprocess.run(
      [sys.executable, '-c', _JAX_READER, pkl, str(tmp_path / 'obs.npz'),
       str(tmp_path / 'act.npy')], env=env, cwd=ROOT, capture_output=True,
      text=True, timeout=300)
  assert done.returncode == 0, done.stderr[-2000:]
  jact = np.load(tmp_path / 'act.npy')
  with torch.no_grad():
    served = pnets.make_policy(
        normalizer, params, device='cpu', obs_key='state',
        value_obs_key='privileged_state')(
            {k: torch.from_numpy(v) for k, v in obs.items()}).numpy()
  assert jact.shape == (8, 12) and np.abs(jact).max() > 0
  np.testing.assert_allclose(served, jact, rtol=1e-5, atol=1e-6)


# -- 6. the rough-terrain joystick -----------------------------------------------------

NO_NOISE = {'noise_config.level': 0.0}
JOYSTICK = os.path.join(ROOT, 'logs', 'go2_joystick_50M_r5',
                        'final_params.pkl')
JOY_INIT_KEYS = ('command', 'steps_until_next_cmd', 'steps_until_next_pert',
                 'pert_duration_seconds', 'pert_duration', 'pert_mag')


def _joystick_policies():
  params = jsac.load_params(JOYSTICK)
  nf = jconfigs.ppo_config(ROUGH).network_factory
  net = jnets.make_ppo_networks(
      {'state': (48,), 'privileged_state': (123,)}, 12,
      policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes),
      policy_obs_key=nf.policy_obs_key, value_obs_key=nf.value_obs_key)
  pol = jppo._make_policy_factory(net, jrs.normalize)(params,
                                                      deterministic=True)
  jpol = jax.jit(lambda obs: pol(obs, jax.random.PRNGKey(0))[0])
  ppol = pnets.make_policy(*pnets.load_ppo_params(JOYSTICK), device='cpu',
                           obs_key='state', value_obs_key='privileged_state')
  return jpol, ppol


def _obs_close(p, j, tol):
  """Each observation within ``tol`` of its scale (the privileged state
  holds the accelerometer and actuator forces, of tens)."""
  for k in ('state', 'privileged_state'):
    j_k = np.asarray(j[k])
    np.testing.assert_allclose(
        p[k].numpy(), j_k, rtol=tol,
        atol=tol * max(1.0, float(np.abs(j_k).max())), err_msg=k)


def _handover(jstate, base, keys):
  """Hand the JAX reset's draws to the port env ``base``."""
  t = lambda x: torch.from_numpy(np.array(x))
  init = dict(qpos=t(jstate.data.qpos), qvel=t(jstate.data.qvel),
              **{k: t(jstate.info[k]) for k in keys})
  base.sample_init = lambda generator, batch: init


def test_rough_terrain_slice_matches_jax(monkeypatch):
  """The flat joystick policy on the reference terrain, 3 control steps
  from a JAX reset against JAX's lanes route (the heightfield collider
  and K4 at 58 rows, Pallas in interpret mode): observations within 1e-5
  of their scale at reset (one forward), then the repo's post-solve
  tolerance 1e-2; done exactly."""
  n = 3
  jenv = jwrappers.wrap_for_training(
      jenvs.load(ROUGH, config_overrides=NO_NOISE), episode_length=1000)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), n))
  far = jnp.full((n,), 50, jnp.int32)  # no command change within 3 steps
  jstate.info['steps_until_next_cmd'] = far
  jstate.info['first_info']['steps_until_next_cmd'] = far
  base = penvs.load(ROUGH, device='cpu', config_overrides=NO_NOISE)
  _handover(jstate, base, JOY_INIT_KEYS)
  penv = pwrappers.wrap_for_training(base, episode_length=1000, num_envs=n)
  pstate = penv.reset(torch.Generator().manual_seed(0))
  jpolicy, ppolicy = _joystick_policies()
  _obs_close(pstate.obs, jstate.obs, 1e-5)
  monkeypatch.setattr(jlk, '_INTERPRET', True)
  jFF._CACHE.clear()
  try:
    jstep = jax.jit(jenv.step)
    for _ in range(3):
      jstate = jstep(jstate, jpolicy(jstate.obs))
      with torch.no_grad():
        pstate = penv.step(pstate, ppolicy(pstate.obs))
      _obs_close(pstate.obs, jstate.obs, 1e-2)
      np.testing.assert_allclose(pstate.reward.numpy(),
                                 np.asarray(jstate.reward), rtol=1e-2,
                                 atol=1e-4)
      np.testing.assert_array_equal(pstate.done.numpy(),
                                    np.asarray(jstate.done))
      np.testing.assert_array_equal(pstate.info['last_contact'].numpy(),
                                    np.asarray(jstate.info['last_contact']))
  finally:
    jFF._CACHE.clear()
  # feet on the terrain, which is not flat under them
  assert pstate.info['last_contact'].any()
  assert not np.allclose(pstate.data.contact.dist.numpy(), 0.0)


# -- 7. domain randomisation on the new scenes ---------------------------------------

GO2_FIELDS = {'geom_friction', 'dof_frictionloss', 'dof_armature',
              'actuator_gainprm', 'actuator_biasprm', 'dof_damping',
              'body_ipos', 'body_mass', 'qpos0'}


@pytest.mark.parametrize('name', [FULL, 'Go2Handstand', ROUGH])
def test_go2_randomizer_on_new_scenes(name):
  """The Go2 randomiser finds the floor by name on either scene, changes
  its fields alone, and one DR control step runs on the CPU."""
  base = penvs.load(name, device='cpu')
  m = base.model
  rand = penvs.get_domain_randomizer(name)
  mb = rand(m, torch.Generator().manual_seed(1), 3)
  assert mb.batched == frozenset(GO2_FIELDS)
  floor = m.names['geom']['floor']
  assert m.geom_type[floor] == (1 if name == ROUGH else 0)
  ff = mb.geom_friction[:, floor, 0]
  assert (ff >= 0.4).all() and (ff <= 1.0).all() and len(ff.unique()) == 3
  others = [g for g in range(m.ngeom) if g != floor]
  assert torch.equal(mb.geom_friction[:, others],
                     m.geom_friction[others].expand(3, len(others), 3))
  env = pwrappers.wrap_for_training(
      base, episode_length=10,
      randomization_fn=lambda model: rand(
          model, torch.Generator().manual_seed(1), 3))
  state = env.reset(torch.Generator().manual_seed(2))
  state = env.step(state, torch.zeros(3, 12))
  assert np.isfinite(state.obs['privileged_state'].numpy()).all()
  assert env.unwrapped.model.batched == frozenset(GO2_FIELDS)


def test_dr_step_on_full_scene_matches_jax():
  """One DR control step of handstand: the JAX randomiser's fields carried
  into the port (``Model.with_batched``), JAX's wrapped DR reset handed
  over.  On the full scene JAX takes its per-env route, which batches any
  model leaf.  Observations within 1e-5 of scale at reset, the post-solve
  tolerance 1e-2 after the step."""
  n, name = 3, 'Go2Handstand'
  jbase = jenvs.load(name, config_overrides=NO_NOISE)
  rfn = jenvs.get_domain_randomizer(name)
  rng = jax.random.split(jax.random.PRNGKey(10), n)
  mb, axes = rfn(jbase.model, rng)
  fields = {f: np.asarray(getattr(mb, f)) for f in pT.NUMERIC_FIELDS
            if getattr(axes, f) == 0}
  assert set(fields) == GO2_FIELDS
  jenv = jwrappers.wrap_for_training(
      jbase, episode_length=100,
      randomization_fn=lambda model: rfn(model, rng))
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(2), n))
  base = penvs.load(name, device='cpu', config_overrides=NO_NOISE)
  _handover(jstate, base, ())
  penv = pwrappers.wrap_for_training(
      base, episode_length=100,
      randomization_fn=lambda m: m.with_batched(**fields))
  pstate = penv.reset(torch.Generator().manual_seed(0))
  _obs_close(pstate.obs, jstate.obs, 1e-5)
  acts = np.random.default_rng(3).uniform(-0.5, 0.5, (n, 12)).astype(
      np.float32)
  jstate = jax.jit(jenv.step)(jstate, jnp.asarray(acts))
  with torch.no_grad():
    pstate = penv.step(pstate, torch.from_numpy(acts))
  _obs_close(pstate.obs, jstate.obs, 1e-2)
  np.testing.assert_allclose(pstate.reward.numpy(), np.asarray(jstate.reward),
                             rtol=1e-2, atol=1e-4)
  np.testing.assert_array_equal(pstate.done.numpy(), np.asarray(jstate.done))
  model = penv.unwrapped.model
  for f, v in fields.items():
    np.testing.assert_array_equal(model.numeric[f].numpy(), v, err_msg=f)
  assert base.model.batched == frozenset()
