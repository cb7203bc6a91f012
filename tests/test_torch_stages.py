"""Each stage of the port's physics step against its JAX counterpart.

A JAX reset of a small AirbotCubePushTrain batch (the cube resting on the
table, the arm at its start pose with noise) gives the state; the JAX lanes
stages (Pallas in interpret mode, the code the TPU runs) compute
kinematics, smooth dynamics and the contact-basis assembly, and the port's
stages get the SAME lanes inputs, so each stage is held alone.  Tolerances
are those the repo uses for the same stages (tests/test_fwd_fused.py):
rtol 1e-4, atol 1e-5, with atol scaled to large-magnitude outputs (qM with
joint armature, stiff constraint rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.physics import constraint as jC
from rsr_mjx_tpu.physics import lanes_assembly as jA
from rsr_mjx_tpu.physics import lanes_kinematics as jK
from rsr_mjx_tpu.physics import lanes_smooth as jS
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.physics import constraint as pC
from rsr_mjx_tpu_torch.physics import lanes_assembly as pA
from rsr_mjx_tpu_torch.physics import lanes_kinematics as pK
from rsr_mjx_tpu_torch.physics import lanes_smooth as pS

B = 3


def _close(p, j, name, rtol=1e-4, atol=1e-5):
  p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
  j = np.asarray(j)
  assert p.shape == j.shape, (name, p.shape, j.shape)
  np.testing.assert_allclose(p, j, rtol=rtol,
                             atol=max(atol, 1e-6 * np.abs(j).max()),
                             err_msg=name)


def _t(x):
  return torch.from_numpy(np.array(x))


@pytest.fixture(scope='module')
def stages():
  """JAX reset batch, and every JAX lanes stage on it (interpret mode)."""
  env = jenvs.load('AirbotCubePushTrain')
  jm = env.model
  state = jax.jit(jax.vmap(env.reset))(
      jax.random.split(jax.random.PRNGKey(0), B))
  d = state.data
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
    # the fused region's contract (fwd_fused.py:250-257): the dynamic
    # leaves in lanes, the model leaves broadcast batch-major except the
    # contact parameters
    dyn = dict(qpos=sl.qpos, qvel=sl.qvel, cdof=kout.cdof,
               cdof_anchor=kout.cdof_anchor, geom_xpos=kout.geom_xpos,
               geom_xmat=kout.geom_xmat)
    keep = ('hfield_data', 'geom_size', 'con_friction', 'con_solref',
            'con_solimp', 'con_invweight')
    lv = jC.AssembleLeaves(*(
        dyn[f] if f in dyn
        else x if f in keep else jnp.broadcast_to(x, (B,) + x.shape)
        for f, x in zip(jC.AssembleLeaves._fields,
                        jC.gather_leaves(jm, d))
    ))
    aout = jax.jit(lambda lv: jA.assemble_lanes(
        jm, lv, basis=True, dyn_lanes=True))(lv)
    # the same selected contacts expanded into generic rows (what the JAX
    # package assembles with its basis kernel switched off)
    gout = jax.jit(lambda lv: jA.assemble_lanes(jm, lv, dyn_lanes=True))(lv)
  finally:
    jlk._INTERPRET = saved
  pm = penvs.load('AirbotCubePushTrain', device='cpu').model
  return dict(pm=pm, d=d, sl=sl, kout=kout, sout=sout, aout=aout, gout=gout)


def test_kinematics_lanes(stages):
  pm, d = stages['pm'], stages['d']
  qpos_l = _t(np.moveaxis(np.asarray(d.qpos), 0, -1))
  out = pK.kinematics_lanes(pm, pK.gather_kin(pm, qpos_l))
  for f in pK.KinOut._fields:
    _close(getattr(out, f), getattr(stages['kout'], f), f)


def test_smooth_lanes(stages):
  pm, kout, sl = stages['pm'], stages['kout'], stages['sl']
  kin = pK.KinOut(*(_t(x) for x in kout))
  out = pS.smooth_lanes(pm, pS.gather_smooth(
      pm, _t(sl.qpos), _t(sl.qvel), _t(sl.ctrl), _t(sl.qfrc_applied),
      _t(sl.xfrc_applied), kin))
  names = ('qM', 'cvel', 'qfrc_bias', 'qfrc_passive', 'actuator_force',
           'qfrc_actuator', 'qfrc_smooth', 'qacc_smooth')
  for name, p, j in zip(names, out, stages['sout']):
    _close(p, j, name)


def test_assemble_lanes_basis(stages):
  pm, kout, sl = stages['pm'], stages['kout'], stages['sl']
  lv = pC.gather_leaves(pm, _t(sl.qpos), _t(sl.qvel), _t(kout.cdof),
                        _t(kout.cdof_anchor), _t(kout.geom_xpos),
                        _t(kout.geom_xmat))
  out = pA.assemble_lanes(pm, lv)
  names = ('J_s', 'aref_s', 'D_s', 'floss_s', 'dist', 'U', 'arefU', 'D_c')
  ref = stages['aout']
  assert out[-1] == ref[-1] == 3  # friction axes of condim 4
  for name, p, j in zip(names, out[:-1], ref[:-1]):
    _close(p, j, name)
  # the reset batch has the cube resting on the table: contacts selected
  assert (out[4] < 0.005).sum() >= 4 * B


def test_assemble_lanes_generic_rows_of_selected_contacts(stages):
  """Selection on, basis off: the 24 selected contacts as 144 generic rows
  after the 37 structured ones (the input of kernel K4 on this model)."""
  pm, kout, sl = stages['pm'], stages['kout'], stages['sl']
  lv = pC.gather_leaves(pm, _t(sl.qpos), _t(sl.qvel), _t(kout.cdof),
                        _t(kout.cdof_anchor), _t(kout.geom_xpos),
                        _t(kout.geom_xmat))
  out = pA.assemble_lanes(pm, lv, basis=False)
  assert len(out) == 5
  for name, p, j in zip(('J', 'aref', 'D', 'floss', 'dist'), out,
                        stages['gout']):
    _close(p, j, name)
  J = out[0]
  assert J.shape == (20, 181, B)
  # row (contact c, axis i, ±) is Jn_c ± mu_i A_i_c of the basis form
  J_s, _, _, _, _, U, _, _, naxes = pA.assemble_lanes(pm, lv, basis=True)
  np.testing.assert_array_equal(J[:, :37].numpy(), J_s.numpy())
  Un, Ua = U[:, :24], U[:, 24:].reshape(20, 3, 24, B)
  Jc = J[:, 37:].reshape(20, 24, 3, 2, B)
  for i in range(naxes):
    np.testing.assert_allclose(Jc[:, :, i, 0].numpy(),
                               (Un + Ua[:, i]).numpy(), atol=1e-6)
    np.testing.assert_allclose(Jc[:, :, i, 1].numpy(),
                               (Un - Ua[:, i]).numpy(), atol=1e-6)
