"""One physics step of the port against ``jax.vmap(physics.step)``.

The state is a JAX reset of a small AirbotCubePushTrain batch with a
control applied, converted into the port's Data; the JAX step runs its
batched lanes route with the Pallas kernels in interpret mode (the code the
TPU runs), the port its fused chain with the kernels' plain versions.
Tolerances are those of tests/test_fwd_fused.py for the same quantities:
rtol 1e-4 / atol 1e-5 for kinematics and smooth dynamics, 1e-2 for
qpos/qvel/qacc after the Newton and implicit solves.
"""

import dataclasses

import jax
import numpy as np
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu import physics as jphysics
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch import physics as pphysics
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.physics import types as pT

B = 3
SMOOTH = ('xpos', 'xquat', 'xmat', 'geom_xpos', 'geom_xmat', 'site_xpos',
          'subtree_com', 'cdof', 'qM', 'cvel', 'qfrc_bias', 'qfrc_actuator',
          'qfrc_smooth', 'qacc_smooth')
SOLVED = ('qpos', 'qvel', 'qacc', 'qfrc_constraint')


def port_data(pm, jd) -> pT.Data:
  """The port's batch Data holding the values of a batched JAX Data."""
  t = lambda x: torch.from_numpy(np.array(x))
  d = pphysics.make_data(pm, jd.qpos.shape[0])
  return pT.Data(
      **{f: t(getattr(jd, f)) for f in pT.DATA_FIELDS},
      contact=dataclasses.replace(d.contact, dist=t(jd.contact.dist)),
  )


def assert_close(p, j, name, rtol, atol):
  p, j = p.numpy(), np.asarray(j)
  assert p.shape == j.shape, (name, p.shape, j.shape)
  np.testing.assert_allclose(p, j, rtol=rtol,
                             atol=max(atol, rtol * 1e-2 * np.abs(j).max()),
                             err_msg=name)


def _jax_batch():
  """The JAX model and a reset batch with a control applied."""
  env = jenvs.load('AirbotCubePushTrain')
  state = jax.jit(jax.vmap(env.reset))(
      jax.random.split(jax.random.PRNGKey(1), B))
  ctrl = state.data.ctrl + 0.05 * jax.random.normal(
      jax.random.PRNGKey(2), state.data.ctrl.shape)
  return env.model, state.data.replace(ctrl=ctrl)


def test_step_matches_jax(monkeypatch):
  jm, jd = _jax_batch()

  monkeypatch.setattr(jlk, '_INTERPRET', True)
  jFF._CACHE.clear()
  try:
    jout = jax.jit(jax.vmap(lambda d: jphysics.step(jm, d)))(jd)
  finally:
    jFF._CACHE.clear()

  pm = penvs.load('AirbotCubePushTrain', device='cpu').model
  plk.LAUNCHES.update(dict.fromkeys(plk.LAUNCHES, 0))
  pout = pphysics.step(pm, port_data(pm, jd))
  # the CPU tensors took the plain versions: no kernel launched
  assert not any(plk.LAUNCHES.values())

  for f in SMOOTH:
    assert_close(getattr(pout, f), getattr(jout, f), f, 1e-4, 1e-5)
  assert_close(pout.contact.dist, jout.contact.dist, 'dist', 1e-4, 1e-5)
  for f in SOLVED:
    assert_close(getattr(pout, f), getattr(jout, f), f, 1e-2, 1e-2)
  assert_close(pout.time, jout.time, 'time', 1e-6, 1e-7)


def test_step_in_float64_matches_float32():
  """The CPU path runs in float64 too (the reference the card's fp32 is
  held against); one step from the state above agrees with float32 to the
  same tolerances, and every field stays float64."""
  _, jd = _jax_batch()
  pm32 = penvs.load('AirbotCubePushTrain', device='cpu').model
  pm64 = penvs.load('AirbotCubePushTrain', device='cpu',
                    dtype=torch.float64).model
  d32 = port_data(pm32, jd)
  out32 = pphysics.step(pm32, d32)
  out64 = pphysics.step(pm64, d32.map(torch.Tensor.double))
  for f in pT.DATA_FIELDS:
    assert getattr(out64, f).dtype == torch.float64, f
  assert out64.contact.dist.dtype == torch.float64
  for f in SMOOTH:
    assert_close(getattr(out32, f).double(), getattr(out64, f).numpy(), f,
                 1e-4, 1e-5)
  for f in SOLVED:
    assert_close(getattr(out32, f).double(), getattr(out64, f).numpy(), f,
                 1e-2, 1e-2)
