"""The Go2 flat-terrain model, each stage of its physics step, its sensors
and kernel K4 in the port, each against the JAX package.

A JAX reset of a small Go2JoystickFlatTerrain batch gives the state (the
robot standing on its four feet, 18 mm into the floor, with a random base
velocity); a numpy-seeded change of the joint angles and velocities moves
it off the home pose, so that some feet press in and others lift off.
The JAX lanes stages (Pallas in interpret mode, the code the TPU runs)
compute kinematics, smooth dynamics and the generic-row assembly, and the
port's stages get the SAME lanes inputs, so each stage is held alone.  Tolerances: the model exact; kinematics-only quantities 1e-5;
the stages rtol 1e-4 with atol 1e-5 scaled to large outputs, as
tests/test_torch_stages.py; K4 rtol 1e-4 of each output's scale (fp32
reductions in another order).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.physics import collision as jcol
from rsr_mjx_tpu.physics import constraint as jC
from rsr_mjx_tpu.physics import lanes_assembly as jA
from rsr_mjx_tpu.physics import lanes_kinematics as jK
from rsr_mjx_tpu.physics import lanes_smooth as jS
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.physics import sensors as jsensors
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch import physics as pphysics
from rsr_mjx_tpu_torch.envs.go2 import snapshot
from rsr_mjx_tpu_torch.physics import collision as pcol
from rsr_mjx_tpu_torch.physics import constraint as pC
from rsr_mjx_tpu_torch.physics import fwd_fused as pFF
from rsr_mjx_tpu_torch.physics import io as pio
from rsr_mjx_tpu_torch.physics import lanes_assembly as pA
from rsr_mjx_tpu_torch.physics import lanes_kinematics as pK
from rsr_mjx_tpu_torch.physics import lanes_smooth as pS
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.physics import sensors as psensors
from rsr_mjx_tpu_torch.physics import types as pT

ENV = 'Go2JoystickFlatTerrain'
B = 3
SENSORS = (
    'gyro', 'local_linvel', 'accelerometer', 'position', 'upvector',
    'forwardvector', 'global_linvel', 'global_angvel', 'orientation',
    'FR_global_linvel', 'FL_global_linvel', 'RR_global_linvel',
    'RL_global_linvel', 'FR_pos', 'FL_pos', 'RR_pos', 'RL_pos',
)


def _np(x):
  return None if x is None else np.asarray(x)


def _t(x):
  return torch.from_numpy(np.array(x))


def _close(p, j, name, rtol=1e-4, atol=1e-5):
  p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
  j = np.asarray(j)
  assert p.shape == j.shape, (name, p.shape, j.shape)
  np.testing.assert_allclose(p, j, rtol=rtol,
                             atol=max(atol, 1e-6 * np.abs(j).max()),
                             err_msg=name)


@pytest.fixture(scope='module')
def models():
  return jenvs.load(ENV).model, penvs.load(ENV, device='cpu').model


@pytest.fixture(scope='module')
def stages(models):
  """JAX reset batch moved off the home pose, and every JAX lanes stage on
  it (interpret mode)."""
  jm, pm = models
  env = jenvs.load(ENV)
  state = jax.jit(jax.vmap(env.reset))(
      jax.random.split(jax.random.PRNGKey(0), B))
  rng = np.random.default_rng(0)
  qpos = np.array(state.data.qpos)
  qvel = np.array(state.data.qvel)
  qpos[:, 7:] += rng.uniform(-0.2, 0.2, size=(B, 12)).astype(np.float32)
  qvel[:, 6:] = rng.uniform(-2.0, 2.0, size=(B, 12)).astype(np.float32)
  ctrl = qpos[:, 7:] + rng.uniform(-1.0, 1.0, size=(B, 12)).astype(np.float32)
  xfrc = rng.uniform(-1.0, 1.0, size=(B, jm.nbody, 6)).astype(np.float32)
  d = state.data.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                         ctrl=jnp.asarray(ctrl), xfrc_applied=jnp.asarray(xfrc))
  saved = jlk._INTERPRET
  jlk._INTERPRET = True
  try:
    lanes = lambda x: jnp.moveaxis(x, 0, -1)
    expand = lambda x: x[..., None]
    kl = jK.gather_kin(jm, d)
    kl = jK.KinLeaves(lanes(kl.qpos), *(expand(x) for x in kl[1:]))
    kout = jax.jit(lambda kl: jK.kinematics_lanes(jm, kl))(kl)
    sl = jS.gather_smooth(jm, d)
    batched = ('qpos', 'qvel', 'ctrl', 'qfrc_applied', 'xfrc_applied')
    sl = jS.SmoothLeaves(*(
        lanes(x) if f in batched else expand(x)
        for f, x in zip(jS.SmoothLeaves._fields, sl)
    ))._replace(cdof=kout.cdof, cdof_anchor=kout.cdof_anchor,
                ximat=kout.ximat, xipos=kout.xipos,
                subtree_com=kout.subtree_com)
    sout = jax.jit(lambda sl: jS.smooth_lanes(jm, sl))(sl)
    dyn = dict(qpos=sl.qpos, qvel=sl.qvel, cdof=kout.cdof,
               cdof_anchor=kout.cdof_anchor, geom_xpos=kout.geom_xpos,
               geom_xmat=kout.geom_xmat)
    keep = ('hfield_data', 'geom_size', 'con_friction', 'con_solref',
            'con_solimp', 'con_invweight')
    lv = jC.AssembleLeaves(*(
        dyn[f] if f in dyn
        else x if f in keep or x is None
        else jnp.broadcast_to(x, (B,) + x.shape)
        for f, x in zip(jC.AssembleLeaves._fields, jC.gather_leaves(jm, d))
    ))
    aout = jax.jit(lambda lv: jA.assemble_lanes(jm, lv, dyn_lanes=True))(lv)
  finally:
    jlk._INTERPRET = saved
  return dict(d=d, sl=sl, kout=kout, sout=sout, aout=aout)


def _port_kin(stages):
  return pK.KinOut(*(_t(x) for x in stages['kout']))


# -- the model ---------------------------------------------------------------


def test_go2_model_matches_jax(models):
  """The snapshot with the env's config applied equals ``put_model`` of the
  JAX scene (compiled with the same config), field by field."""
  jm, pm = models
  for f in pT.SIZE_FIELDS + ('ncon', 'ncon_sel'):
    assert getattr(pm, f) == getattr(jm, f), f
  assert (pm.nq, pm.nv, pm.nu, pm.nsensor, pm.nsensordata, pm.ncon,
          pm.ncon_sel) == (19, 18, 12, 17, 52, 4, 0)
  for f in pT.OPT_TENSOR_FIELDS:
    np.testing.assert_array_equal(_np(getattr(pm.opt, f)),
                                  _np(getattr(jm.opt, f)), err_msg=f)
  for f in pT.OPT_STATIC_FIELDS:
    assert getattr(pm.opt, f) == getattr(jm.opt, f), f
  for f in pT.NUMERIC_FIELDS:
    x, y = _np(pm.numeric[f]), _np(getattr(jm, f))
    assert (x is None) == (y is None), f
    if x is not None:
      assert x.dtype == np.float32, f
      np.testing.assert_array_equal(x, y, err_msg=f)
  for f in pT.STATIC_FIELDS:
    np.testing.assert_array_equal(pm.static[f], getattr(jm, f).arr,
                                  err_msg=f)
  assert [n for n, _ in pm.pairs] == [n for n, _ in jm.pairs]
  for (_, x), (_, y) in zip(pm.pairs, jm.pairs):
    np.testing.assert_array_equal(x, y.arr)
  assert {k: v for k, v in pm.names.items() if k != 'key'} == {
      k: dict(v) for k, v in jm.names}
  assert float(pm.dof_damping[6]) == 3.0 and float(pm.dof_damping[0]) == 0.0
  assert float(pm.actuator_gainprm[0, 0]) == 60.0


def test_go2_snapshot_round_trip(tmp_path):
  committed = pio.load_model_npz(snapshot.path('flat_terrain'), device='cpu')
  fresh = snapshot.build('flat_terrain')
  out = str(tmp_path / 'm.npz')
  pio.save_model_npz(fresh, out)
  again = pio.load_model_npz(out, device='cpu')
  for a in (committed, again):
    for f in pT.NUMERIC_FIELDS:
      x, y = _np(a.numeric[f]), _np(fresh.numeric[f])
      assert (x is None) == (y is None), f
      if x is not None:
        np.testing.assert_array_equal(x, y, err_msg=f)
    for f in pT.STATIC_FIELDS:
      np.testing.assert_array_equal(a.static[f], fresh.static[f], err_msg=f)
    assert a.names == fresh.names
    assert a.opt.disableflags == fresh.opt.disableflags == 32768
  # the names the env looks up, and the keyframes it reads
  for kind, names in (('site', ('imu', 'FR', 'FL', 'RR', 'RL')),
                      ('geom', ('floor', 'FR', 'FL', 'RR', 'RL')),
                      ('body', ('trunk',)), ('sensor', SENSORS),
                      ('key', ('home', 'pre_recovery'))):
    for n in names:
      assert n in committed.names[kind], (kind, n)
  assert committed.key_qpos.shape == (5, 19)
  assert committed.key_ctrl.shape == (5, 12)
  assert [n for n, t in committed.pairs if len(t)] == ['plane_sphere']


def test_go2_layout_and_route(models):
  jm, pm = models
  jl, pl = jC.layout_cached(jm), pC.layout_cached(pm)
  assert (pl.nefc, pl.n_eq, pl.n_fri, pl.n_lim, pl.n_con) == (58, 0, 18, 24,
                                                              16)
  np.testing.assert_array_equal(pl.kind, jl.kind)
  assert pC.pair_groups(pm) == jC.pair_groups(jm) == [('plane_sphere', 4, 1,
                                                       0)]
  assert pFF.supported(pm) and not pFF.use_basis(pm)
  cube = penvs.load('AirbotCubePushTrain', device='cpu').model
  assert pFF.supported(cube) and pFF.use_basis(cube)


# -- the stages ----------------------------------------------------------------


def test_go2_kinematics_lanes(models, stages):
  """Free joint, 12 hinges, sites and geoms; kinematics only: 1e-5."""
  pm = models[1]
  qpos_l = _t(np.moveaxis(np.asarray(stages['d'].qpos), 0, -1))
  out = pK.kinematics_lanes(pm, pK.gather_kin(pm, qpos_l))
  for f in pK.KinOut._fields:
    _close(getattr(out, f), getattr(stages['kout'], f), f, rtol=1e-5,
           atol=1e-5)


def test_go2_smooth_lanes(models, stages):
  """Free-joint dofs in the mass matrix and bias, position actuators with
  clamped force (the ctrl offsets reach the ±24 / ±35.55 ranges)."""
  pm, sl = models[1], stages['sl']
  out = pS.smooth_lanes(pm, pS.gather_smooth(
      pm, _t(sl.qpos), _t(sl.qvel), _t(sl.ctrl), _t(sl.qfrc_applied),
      _t(sl.xfrc_applied), _port_kin(stages)))
  names = ('qM', 'cvel', 'qfrc_bias', 'qfrc_passive', 'actuator_force',
           'qfrc_actuator', 'qfrc_smooth', 'qacc_smooth')
  for name, p, j in zip(names, out, stages['sout']):
    _close(p, j, name)
  force = np.abs(np.asarray(stages['sout'][4]))
  assert (force == 24.0).any() and (force < 24.0).any()  # clamped and not


def _port_leaves(pm, stages):
  sl, kout = stages['sl'], stages['kout']
  return pC.gather_leaves(pm, _t(sl.qpos), _t(sl.qvel), _t(kout.cdof),
                          _t(kout.cdof_anchor), _t(kout.geom_xpos),
                          _t(kout.geom_xmat))


def test_go2_plane_sphere_narrow_phase(models, stages):
  jm, pm = models
  dist, pos, frame = pC.narrowphase_leaves(pm, _port_leaves(pm, stages))
  kout = stages['kout']
  jd, jp, jf = jcol._collide_lanes(
      jcol._cfg_of(jm), jnp.asarray(jm.geom_size)[..., None], None, None,
      None, None, None, kout.geom_xpos, kout.geom_xmat,
      include_solparams=False)
  _close(dist, jd, 'dist', rtol=1e-5, atol=1e-6)
  _close(pos, jp, 'pos', rtol=1e-5, atol=1e-6)
  _close(frame, jf, 'frame', rtol=1e-5, atol=1e-6)
  # the changed joint angles leave some feet down and lift others
  assert dist.shape == (4, B) and (dist < 0).any() and (dist > 0).any()
  g1, g2, cd = pcol.contact_static_ids(pm)
  np.testing.assert_array_equal(g1, [0, 0, 0, 0])
  np.testing.assert_array_equal(g2, [pm.names['geom'][n]
                                     for n in ('FR', 'FL', 'RR', 'RL')])
  np.testing.assert_array_equal(cd, [3, 3, 3, 3])
  # geoms_colliding on a batch: foot 3 of env 1 lifted off the floor
  d = pphysics.make_data(pm, B)
  lifted = torch.full((B, 4), -0.01)
  lifted[1, 3] = 0.01
  d = d.replace(contact=d.contact.__class__(lifted, g1, g2, cd))
  hit = torch.stack([pcol.geoms_colliding(pm, d, int(g), 0) for g in g2], 1)
  expect = np.ones((B, 4), bool)
  expect[1, 3] = False
  np.testing.assert_array_equal(hit.numpy(), expect)
  assert not pcol.geoms_colliding(pm, d, 1, 0).any()  # no such pair


def test_go2_assemble_generic_rows(models, stages):
  """Row order [18 dof friction | 24 limits | 4 contacts x 2 axes x ±] and
  the row kinds the solve is given."""
  pm = models[1]
  out = pA.assemble_lanes(pm, _port_leaves(pm, stages), basis=False)
  assert len(out) == 5
  for name, p, j in zip(('J', 'aref', 'D', 'floss', 'dist'), out,
                        stages['aout']):
    _close(p, j, name)
  J, aref, D, floss, dist = out
  assert J.shape == (18, 58, B) and dist.shape == (B, 4)
  kind = pC.layout_cached(pm).kind
  np.testing.assert_array_equal(kind, [1] * 18 + [2] * 24 + [3] * 16)
  # friction rows are the identity; contact rows come in ± pairs around
  # the normal: (J+ + J-)/2 is the same for both axes of a contact
  np.testing.assert_array_equal(J[:, :18, 0].numpy(), np.eye(18))
  Jc = J[:, 42:].reshape(18, 4, 2, 2, B)
  normal = Jc.mean(dim=3)
  np.testing.assert_allclose(normal[:, :, 0].numpy(), normal[:, :, 1].numpy(),
                             atol=1e-6)
  # a contact's four rows are stiff where its foot is down, off otherwise
  np.testing.assert_array_equal((D[42:].reshape(4, 4, B) > 0).numpy(),
                                (dist.t() < 0)[:, None].expand(4, 4, B))
  assert (floss[18:] == 0).all()
  with pytest.raises(ValueError):
    pA.assemble_lanes(pm, _port_leaves(pm, stages), basis=True)


# -- sensors -------------------------------------------------------------------


@pytest.fixture(scope='module')
def sensor_values(models, stages):
  """sensordata of both packages on the same filled Data: the JAX lanes
  kinematics and velocities, and a seeded qacc."""
  jm, pm = models
  kout, sout, d = stages['kout'], stages['sout'], stages['d']
  bm = lambda x: jnp.moveaxis(x, -1, 0)
  qacc = np.random.default_rng(1).normal(size=(B, 18)).astype(np.float32) * 5
  fields = dict(
      xpos=bm(kout.xpos), xmat=bm(kout.xmat), xipos=bm(kout.xipos),
      ximat=bm(kout.ximat), geom_xpos=bm(kout.geom_xpos),
      geom_xmat=bm(kout.geom_xmat), site_xpos=bm(kout.site_xpos),
      site_xmat=bm(kout.site_xmat), subtree_com=bm(kout.subtree_com),
      cdof=bm(kout.cdof), cvel=bm(sout[1]), qacc=jnp.asarray(qacc),
  )
  jd = d.replace(**fields)
  js = np.asarray(jax.jit(jax.vmap(
      lambda d: jsensors.sensordata(jm, d).sensordata))(jd))
  pd = pphysics.make_data(pm, B).replace(
      qpos=_t(d.qpos), qvel=_t(d.qvel), **{k: _t(v) for k, v in fields.items()})
  ps = psensors.sensordata(pm, pd).sensordata.numpy()
  return js, ps


@pytest.mark.parametrize('name', SENSORS)
def test_go2_sensor_matches_jax(models, sensor_values, name):
  pm = models[1]
  js, ps = sensor_values
  assert js.shape == ps.shape == (B, 52)
  sid = pm.names['sensor'][name]
  adr, dim = int(pm.sensor_adr[sid]), int(pm.sensor_dim[sid])
  assert np.abs(js[:, adr : adr + dim]).max() > 1e-3, name
  np.testing.assert_allclose(ps[:, adr : adr + dim], js[:, adr : adr + dim],
                             rtol=1e-5, atol=1e-5, err_msg=name)


def test_mat_to_quat_all_branches():
  """Each of the four constructions is taken, and the result rotates as the
  matrix does, with w >= 0."""
  rng = np.random.default_rng(2)
  q = rng.normal(size=(64, 4))
  q[:4] = [[1, 0, 0, 0], [0.01, 1, 0, 0], [0.01, 0, 1, 0], [0.01, 0, 0, 1]]
  q = q / np.linalg.norm(q, axis=1, keepdims=True)
  q = torch.from_numpy(q * np.sign(q[:, :1]))
  mat = pK._qmat(q.t()[None])[0].permute(2, 0, 1)  # (64, 3, 3)
  out = psensors.mat_to_quat(mat)
  np.testing.assert_allclose(out.numpy(), q.numpy(), atol=1e-12)
  jq = jax.vmap(jsensors._mat_to_quat)(jnp.asarray(mat.numpy(), jnp.float32))
  np.testing.assert_allclose(out.numpy(), np.asarray(jq), atol=1e-6)


# -- K4 ------------------------------------------------------------------------


def _seeded_system(rng, nv, kind, b):
  f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
  R = len(kind)
  A = rng.normal(size=(b, nv, nv))
  M = A @ np.swapaxes(A, 1, 2) / nv + 0.55 * np.eye(nv)
  fl = np.where(kind[:, None] == 1, rng.uniform(0.0, 2.0, size=(R, b)), 0.0)
  fl[np.nonzero(kind == 1)[0][:2]] = 0.0  # inert friction rows
  D = rng.uniform(1.0, 50.0, size=(R, b))
  D[np.nonzero(kind == 3)[0][::5]] = 0.0  # separated contacts
  return (f32(np.transpose(M, (1, 2, 0))), f32(rng.normal(size=(nv, b))),
          f32(0.1 * rng.normal(size=(nv, b))),
          f32(0.5 * rng.normal(size=(nv, R, b))), f32(rng.normal(size=(R, b))),
          f32(D), f32(fl))


@pytest.mark.parametrize('schedule', [(1, 5), (6, 6)])
@pytest.mark.parametrize('system', ['seeded', 'go2'])
def test_newton_generic_matches_jax(monkeypatch, models, stages, system,
                                    schedule):
  """K4's plain version against the Pallas kernel in interpret mode, on a
  seeded system with every row kind (2 equality, 20 friction, 10 limit, 21
  contact rows) and on the Go2 rows of the stage fixture.  Tolerance, of
  each output's scale: 1e-4 on the seeded system (fp32 reductions in
  another order), 1e-3 on the Go2 rows, whose Hessian spans the armature
  (5e-3) to the contact stiffness (1e3), so that rounding grows over six
  steps."""
  monkeypatch.setattr(jlk, '_INTERPRET', True)
  tol = 1e-4 if system == 'seeded' else 1e-3
  if system == 'seeded':
    kind = np.array([0] * 2 + [1] * 20 + [2] * 10 + [3] * 21, np.int32)
    args = _seeded_system(np.random.default_rng(5), 20, kind, B)
  else:
    kind = np.asarray(jC.layout_cached(models[0]).kind)
    J, aref, D, floss, _ = (np.array(x) for x in stages['aout'])
    sout = stages['sout']
    args = (np.array(sout[0]), np.array(sout[7]),
            np.zeros_like(np.array(sout[7])), J, aref, D, floss)
  outj = jlk._newton_lanes_core(kind, *schedule,
                                *(jnp.asarray(a) for a in args))
  outp = plk._newton_lanes_core(kind, *schedule,
                                *(torch.from_numpy(a) for a in args))
  for name, j, p in zip(('x', 'force', 'qfrc'), outj, outp):
    j, p = np.asarray(j), p.numpy()
    assert p.shape == j.shape, name
    assert np.isfinite(p).all(), name
    np.testing.assert_allclose(p, j, rtol=tol, atol=tol * np.abs(j).max(),
                               err_msg=name)
  x, force, qfrc = outp
  assert (force[kind == 3] >= 0).all()  # contacts push only
  np.testing.assert_allclose(
      qfrc.numpy(),
      np.einsum('vrb,rb->vb', args[3].astype(np.float64), force.numpy()),
      rtol=1e-4, atol=1e-4 * np.abs(qfrc.numpy()).max())
  # float64 on the CPU path gives the same solve
  x64 = plk.newton_generic_plain(
      kind, *schedule, *(torch.from_numpy(a).double() for a in args))[0]
  np.testing.assert_allclose(x.numpy(), x64.numpy(), rtol=1e-3,
                             atol=1e-3 * np.abs(x64.numpy()).max())


def test_newton_generic_size_guard():
  """The guard of the CUDA route: one env's system must fit the 232448
  bytes of shared memory of a block, nv <= 64; it names nv and R0."""
  assert plk.newton_generic_smem_bytes(18, 58) == 10624
  plk.check_newton_generic_fits(18, 58)
  plk.check_newton_generic_fits(20, 1964)  # the last R that fits at nv 20
  with pytest.raises(ValueError, match=r'nv=20, R0=1965'):
    plk.check_newton_generic_fits(20, 1965)
  plk.check_newton_generic_fits(64, 673)  # two rows of H per lane
  with pytest.raises(ValueError, match=r'nv=64, R0=674'):
    plk.check_newton_generic_fits(64, 674)
  with pytest.raises(ValueError, match=r'nv=65, R0=8'):
    plk.check_newton_generic_fits(65, 8)
  # the CPU route has no such limit and launches nothing
  kind = np.array([1] * 4, np.int32)
  args = _seeded_system(np.random.default_rng(6), 4, kind, 2)
  with pytest.raises(ValueError):  # kind does not cover the rows
    plk._newton_lanes_core(kind[:3], 1, 1, *(torch.from_numpy(a) for a in args))
  plk._newton_lanes_core(kind, 1, 1, *(torch.from_numpy(a) for a in args))
  assert plk.LAUNCHES['_newton_lanes_core'] == 0


@pytest.mark.parametrize('E, go2_bytes, cube_bytes, max_r', [
    (1, 10624, 25512, 1964), (2, 20976, 49608, 996), (4, 41488, 97768, 486),
    (8, 82512, 194088, 225)])
def test_newton_generic_smem_bytes(E, go2_bytes, cube_bytes, max_r):
  """K4's block of E envs: the bytes on the Go2 rows (nv 18, R0 58) and on
  the cube-push generic rows (nv 20, R0 181), their agreement with the
  Layout struct of the CUDA source, the stride rule (4 mod 32 words for
  E > 1), the largest R0 that fits at nv 20, and the E chosen for both
  paths' batches (8) and for a batch too small to give every SM a block."""
  assert plk.newton_generic_smem_bytes(18, 58, E) == go2_bytes
  assert plk.newton_generic_smem_bytes(20, 181, E) == cube_bytes
  src = open(os.path.join(plk.cuda_build.CSRC, 'newton_generic.cu')).read()
  body = src[src.index('struct Layout'):src.index('words = o;')]
  terms = re.findall(r'o \+= ([^;]+);', body)
  for nv, R, nbytes in ((18, 58, go2_bytes), (20, 181, cube_bytes)):
    env = dict(nv=nv, R=R, nvp=(nv + 3) // 4 * 4, ldm=nv | 1, kPartWords=128)
    words = sum(eval(t, {}, env) for t in terms)
    stride = (nbytes // 4 - 2 * R) // E
    assert stride >= words and stride - words < (4 if E == 1 else 32)
    assert stride % 4 == 0 and (E == 1 or stride % 32 == 4)
  fits = lambda R: plk.newton_generic_smem_bytes(20, R, E) <= 232448
  assert fits(max_r) and not fits(max_r + 1)
  go2 = lambda e: plk.newton_generic_smem_bytes(18, 58, e)
  cube = lambda e: plk.newton_generic_smem_bytes(20, 181, e)
  assert plk.envs_per_block(go2, 8192) == 8
  assert plk.envs_per_block(cube, 2048) == 8
  assert plk.envs_per_block(go2, 132 * E) == E
  wide = lambda e: plk.newton_generic_smem_bytes(20, max_r + 1, e)
  if E > 1:  # one row too many for this E: the chooser falls to E / 2
    assert plk.envs_per_block(wide, 8192) == E // 2
  else:
    with pytest.raises(ValueError, match='shared memory'):
      plk.envs_per_block(wide, 8192)
