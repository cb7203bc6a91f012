"""Go2 domain randomisation.

Counterpart of ``rsr_mjx_tpu/envs/go2/randomize.py``, with its draw table
copied: per env, the floor's tangential friction resampled in [0.4, 1.0];
leg-joint frictionloss ±10 % and armature +0–5 %; one scale per actuator,
±5 %, on both ``gainprm[:, 0]`` and ``biasprm[:, 1]`` (so Kp stays coherent
across the two); leg damping (Kd) ±5 %; the torso's COM shifted ±0.2 m;
every body mass ±10 % plus ±3 kg on the torso; the leg home pose ``qpos0``
offset ±0.05 rad.  The draws come from a ``torch.Generator``, one table
entry after another; the result is one model per env
(``Model.with_batched``).  ``body_invweight0`` and ``dof_invweight0`` keep
the nominal model's values, as in the JAX package.
"""

from __future__ import annotations

import torch

from rsr_mjx_tpu_torch.envs import core
from rsr_mjx_tpu_torch.envs.go2 import base as go2_base
from rsr_mjx_tpu_torch.physics.io import name2id
from rsr_mjx_tpu_torch.physics.types import Model

# the Go2 root is a free joint: 6 dofs / 7 qpos entries ahead of the legs
_FREE_NV = 6
_FREE_NQ = 7


def draw_table(model: Model) -> dict:
  """name → (shape per env, low, high)."""
  n_leg = model.nv - _FREE_NV
  return {
      'floor_friction': ((), 0.4, 1.0),
      'frictionloss_scale': ((n_leg,), 0.9, 1.1),
      'armature_scale': ((n_leg,), 1.0, 1.05),
      'kp_scale': ((model.nu,), 0.95, 1.05),
      'kd_scale': ((n_leg,), 0.95, 1.05),
      'com_shift': ((3,), -0.2, 0.2),
      'mass_scale': ((model.nbody,), 0.9, 1.1),
      'torso_extra_mass': ((), -3.0, 3.0),
      'pose_offset': ((n_leg,), -0.05, 0.05),
  }


def domain_randomize(model: Model, generator: torch.Generator,
                     batch_size: int) -> Model:
  """``batch_size`` randomised copies of ``model`` (the Go2 env's, with its
  config's Kp and Kd applied) as one batched model; the draws are made on
  the generator's device."""
  B = batch_size
  d = {}
  for name, (shape, lo, hi) in draw_table(model).items():
    u = core.rand(generator, (B,) + shape)
    d[name] = lo + (hi - lo) * u.to(model.device, model.qpos0.dtype)
  floor = name2id(model, 'geom', 'floor')
  torso = name2id(model, 'body', go2_base.ROOT_BODY)
  per_env = lambda x: x.expand((B,) + x.shape).clone()

  geom_friction = per_env(model.geom_friction)
  geom_friction[:, floor, 0] = d['floor_friction']
  dof_frictionloss = per_env(model.dof_frictionloss)
  dof_frictionloss[:, _FREE_NV:] *= d['frictionloss_scale']
  dof_armature = per_env(model.dof_armature)
  dof_armature[:, _FREE_NV:] *= d['armature_scale']
  gainprm = per_env(model.actuator_gainprm)
  gainprm[:, :, 0] *= d['kp_scale']
  biasprm = per_env(model.actuator_biasprm)
  biasprm[:, :, 1] *= d['kp_scale']
  dof_damping = per_env(model.dof_damping)
  dof_damping[:, _FREE_NV:] *= d['kd_scale']
  body_ipos = per_env(model.body_ipos)
  body_ipos[:, torso] += d['com_shift']
  body_mass = model.body_mass * d['mass_scale']
  body_mass[:, torso] += d['torso_extra_mass']
  qpos0 = per_env(model.qpos0)
  qpos0[:, _FREE_NQ:] += d['pose_offset']
  return model.with_batched(
      geom_friction=geom_friction, dof_frictionloss=dof_frictionloss,
      dof_armature=dof_armature, actuator_gainprm=gainprm,
      actuator_biasprm=biasprm, dof_damping=dof_damping,
      body_ipos=body_ipos, body_mass=body_mass, qpos0=qpos0)
