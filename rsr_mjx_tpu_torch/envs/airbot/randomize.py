"""Airbot domain randomisation.

Counterpart of ``rsr_mjx_tpu/envs/airbot/randomize.py`` (reference:
ppo_train/airbot_training/domain_randomize.py), with its ranges copied:
per env, the table, cube and finger geom frictions, the cube's mass and
the arm's dof damping and frictionloss (dofs 0:8) are scaled.  The draws
come from a ``torch.Generator``, in the JAX function's order; the result
is one model per env (``Model.with_batched``).  ``body_invweight0`` and
``dof_invweight0`` keep the nominal model's values, as in the JAX package.
"""

from __future__ import annotations

import torch

from rsr_mjx_tpu_torch.envs import core
from rsr_mjx_tpu_torch.physics.io import name2id
from rsr_mjx_tpu_torch.physics.types import Model

FRICTION_TABLE_CUBE = (0.68, 1.32)
MASS_CUBE = (0.84, 1.16)
FRICTION_FINGER = (0.76, 1.24)
JOINT_SCALE = (0.92, 1.08)

ARM_DOFS = slice(0, 8)


def finger_geoms(model: Model) -> list:
  """The geoms of the two finger bodies."""
  fingers = (name2id(model, 'body', 'left'), name2id(model, 'body', 'right'))
  return [g for g in range(model.ngeom)
          if int(model.geom_bodyid[g]) in fingers]


def domain_randomize(model: Model, generator: torch.Generator,
                     batch_size: int) -> Model:
  """``batch_size`` randomised copies of ``model`` as one batched model;
  the scales are drawn on the generator's device."""
  B = batch_size

  def uniform(lo_hi):
    u = core.rand(generator, (B,))
    u = u.to(model.device, model.qpos0.dtype)
    return lo_hi[0] + (lo_hi[1] - lo_hi[0]) * u

  table_scale = uniform(FRICTION_TABLE_CUBE)
  cube_friction_scale = uniform(FRICTION_TABLE_CUBE)
  cube_mass_scale = uniform(MASS_CUBE)
  finger_scale = uniform(FRICTION_FINGER)
  damping_scale = uniform(JOINT_SCALE)
  frictionloss_scale = uniform(JOINT_SCALE)

  table = name2id(model, 'geom', 'table-b')
  cube = name2id(model, 'geom', 'geom_for_push')
  cube_body = name2id(model, 'body', 'cube_for_push')
  per_env = lambda x: x.expand((B,) + x.shape).clone()

  geom_friction = per_env(model.geom_friction)
  geom_friction[:, table] *= table_scale[:, None]
  geom_friction[:, cube] *= cube_friction_scale[:, None]
  geom_friction[:, finger_geoms(model)] *= finger_scale[:, None, None]
  body_mass = per_env(model.body_mass)
  body_mass[:, cube_body] *= cube_mass_scale
  dof_damping = per_env(model.dof_damping)
  dof_damping[:, ARM_DOFS] *= damping_scale[:, None]
  dof_frictionloss = per_env(model.dof_frictionloss)
  dof_frictionloss[:, ARM_DOFS] *= frictionloss_scale[:, None]
  return model.with_batched(
      geom_friction=geom_friction, body_mass=body_mass,
      dof_damping=dof_damping, dof_frictionloss=dof_frictionloss)
