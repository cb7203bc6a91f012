"""Unitree Go2 base environment, batched over envs.

Counterpart of ``rsr_mjx_tpu/envs/go2/base.py``: loads the scene, applies
the config's timestep, joint damping Kd and actuator Kp, and exposes the
sensor accessors the tasks use.  The model comes from the committed
snapshot (``snapshot.py``), so the env runs where ``mujoco`` is not
installed; the config's values are applied to the loaded ``Model``
(``dof_invweight0`` and ``body_invweight0`` do not depend on them: MuJoCo
computes both from inertia and armature).  ``task`` names the scene:
``flat_terrain`` (feet-only), ``rough_terrain`` (feet-only on the
reference heightfield) or ``full_flat`` (full collision, for getup,
handstand and footstand).  The JAX env's render-only model
(``_mjm_render``) is compiled on demand by ``visual.render_model``, from
the task and gains this env keeps (``task``, ``gains``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from benchmark.reference.frozen.envs import core
from benchmark.reference.frozen.envs.config import Config
from benchmark.reference.frozen.envs.go2 import snapshot
from benchmark.reference.frozen.physics import io
from benchmark.reference.frozen.physics.io import name2id
from benchmark.reference.frozen.physics.types import Data, Model

FEET_SITES = ['FR', 'FL', 'RR', 'RL']
FEET_GEOMS = ['FR', 'FL', 'RR', 'RL']
FEET_POS_SENSOR = [f'{s}_pos' for s in FEET_SITES]
ROOT_BODY = 'trunk'

UPVECTOR_SENSOR = 'upvector'
GLOBAL_LINVEL_SENSOR = 'global_linvel'
GLOBAL_ANGVEL_SENSOR = 'global_angvel'
LOCAL_LINVEL_SENSOR = 'local_linvel'
ACCELEROMETER_SENSOR = 'accelerometer'
GYRO_SENSOR = 'gyro'


class Go2Env(core.Env):
  """Base class for Go2 environments."""

  def __init__(self, task: str, config: Mapping[str, Any],
               config_overrides: Optional[Mapping[str, Any]] = None,
               device='cuda', dtype: torch.dtype = torch.float32):
    """``dtype`` is that of the physics: float32, or float64 on the CPU as
    a reference (the CUDA kernels take float32 only)."""
    self.task = task
    # (Kp, Kd) as the model takes them: from the config handed in
    self.gains = (config['Kp'], config['Kd'])
    self._config = Config(config)
    if config_overrides:
      self._config.update_from_flattened_dict(config_overrides)
    cfg = self._config

    m = io.load_model_npz(snapshot.path(task), device=device)
    # the config's constants rounded to float32 whatever the dtype, so that
    # a float64 run poses the float32 run's problem.  As in the JAX env,
    # sim_dt comes from the overridden config and Kp, Kd from the config
    # handed in (rsr_mjx_tpu/envs/go2/base.py:63-65): overrides of Kp and
    # Kd do not reach the model
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    damping = m.dof_damping.clone()
    damping[6:] = f32(config['Kd'])
    gainprm = m.actuator_gainprm.clone()
    gainprm[:, 0] = f32(config['Kp'])
    biasprm = m.actuator_biasprm.clone()
    biasprm[:, 1] = -f32(config['Kp'])
    m = m.replace(
        opt=dataclasses.replace(m.opt, timestep=f32(cfg.sim_dt)),
        numeric=dict(m.numeric, dof_damping=damping,
                     actuator_gainprm=gainprm, actuator_biasprm=biasprm),
    )
    if dtype != torch.float32:
      m = m.to(device, dtype)
    self._model = m
    self._imu_site_id = name2id(m, 'site', 'imu')

  # ----- sensor helpers

  def _sensor(self, data: Data, name: str) -> torch.Tensor:
    m = self._model
    sid = name2id(m, 'sensor', name)
    adr, dim = int(m.sensor_adr[sid]), int(m.sensor_dim[sid])
    return data.sensordata[:, adr : adr + dim]

  def get_upvector(self, data: Data) -> torch.Tensor:
    return self._sensor(data, UPVECTOR_SENSOR)

  def get_gravity(self, data: Data) -> torch.Tensor:
    """The unit gravity direction in the imu frame: matᵀ (0, 0, −1)."""
    return -data.site_xmat[:, self._imu_site_id, 2, :]

  def get_global_linvel(self, data: Data) -> torch.Tensor:
    return self._sensor(data, GLOBAL_LINVEL_SENSOR)

  def get_global_angvel(self, data: Data) -> torch.Tensor:
    return self._sensor(data, GLOBAL_ANGVEL_SENSOR)

  def get_local_linvel(self, data: Data) -> torch.Tensor:
    return self._sensor(data, LOCAL_LINVEL_SENSOR)

  def get_accelerometer(self, data: Data) -> torch.Tensor:
    return self._sensor(data, ACCELEROMETER_SENSOR)

  def get_gyro(self, data: Data) -> torch.Tensor:
    return self._sensor(data, GYRO_SENSOR)

  def get_feet_pos(self, data: Data) -> torch.Tensor:
    """(B, 4, 3) foot positions in the imu frame."""
    return torch.stack(
        [self._sensor(data, name) for name in FEET_POS_SENSOR], dim=1)

  # ----- random draws

  def _rand(self, generator: torch.Generator, shape) -> torch.Tensor:
    """U[0, 1) of ``shape``, drawn on the generator's device, on the
    model's device and in the physics dtype."""
    u = core.rand(generator, shape)
    return u.to(self._model.device, self._model.qpos0.dtype)

  def _uniform(self, generator, shape, lo, hi) -> torch.Tensor:
    return lo + (hi - lo) * self._rand(generator, shape)

  def _noisy(self, generator, x: torch.Tensor, scale: float) -> torch.Tensor:
    """x plus uniform noise of half-width level·scale (the tasks' ``noisy``)."""
    level = self._config.noise_config.level
    return x + (2 * self._rand(generator, x.shape) - 1) * (level * scale)

  def _soft_limits(self, factor: float):
    """Soft joint limits about the middle of each leg joint's range:
    centre ± half the range times ``factor`` (getup and handstand)."""
    jr = self._model.jnt_range[1:]
    lo, hi = jr[:, 0], jr[:, 1]
    c, r = (lo + hi) / 2, hi - lo
    return c - 0.5 * r * factor, c + 0.5 * r * factor

  def _torso_height(self, data: Data) -> torch.Tensor:
    return data.site_xpos[:, self._imu_site_id, 2]

  def _privileged_tail(self, data: Data) -> torch.Tensor:
    """The sensor block getup and handstand append to the policy state for
    the critic (49 values): gyro, accelerometer, local linvel, global
    angvel, joint angles and velocities, actuator forces, torso height."""
    return torch.cat([
        self.get_gyro(data), self.get_accelerometer(data),
        self.get_local_linvel(data), self.get_global_angvel(data),
        data.qpos[:, 7:], data.qvel[:, 6:], data.actuator_force,
        self._torso_height(data)[:, None],
    ], dim=-1)

  # ----- Env interface

  @property
  def model(self) -> Model:
    return self._model

  def bind_model(self, model: Model) -> None:
    """Step with ``model`` from now on: one with the same topology, whose
    leaves may be per env (domain randomisation)."""
    self._model = model

  @property
  def action_size(self) -> int:
    return self._model.nu

  @property
  def ctrl_dt(self) -> float:
    return float(self._config.ctrl_dt)

  @property
  def dt(self) -> float:
    """Control period (s)."""
    return self.ctrl_dt

  @property
  def sim_dt(self) -> float:
    return float(self._config.sim_dt)

  def keyframe_qpos(self, name: str) -> np.ndarray:
    m = self._model
    return m.key_qpos[name2id(m, 'key', name)].cpu().numpy().copy()

  def keyframe_ctrl(self, name: str) -> np.ndarray:
    m = self._model
    return m.key_ctrl[name2id(m, 'key', name)].cpu().numpy().copy()
