"""Go2 handstand and footstand tasks, batched over envs.

Counterpart of ``rsr_mjx_tpu/envs/go2/handstand.py`` on the full-collision
scene: balance on the front feet (``Handstand``) or on the rear feet
(``Footstand``).  An episode starts at home (or at the crouch keyframe with
probability ``init_from_crouch``) with an xy offset, a yaw and a root
velocity; the action is a delta from the current ``ctrl``.  An env
terminates when it falls over or when one of its unwanted geoms (the
calves, thighs and hips of the legs it should lift) touches the floor; the
``contact`` term penalises the lifted legs' feet on the floor.  Both read
the floor pairs' contact slots through ``collision.geoms_colliding``.

Randomness comes from the ``torch.Generator`` handed to ``reset`` and
travels in ``info['rng']``; ``sample_init`` holds the reset draws and
``reset_to`` starts a batch from given ones.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from rsr_mjx_tpu_torch.envs import core
from rsr_mjx_tpu_torch.envs.config import Config
from rsr_mjx_tpu_torch.envs.go2 import base as go2_base
from rsr_mjx_tpu_torch.physics import collision as _collision
from rsr_mjx_tpu_torch.physics import lie
from rsr_mjx_tpu_torch.physics.io import name2id


def default_config() -> Config:
  """The JAX env's defaults, key for key."""
  return Config(
      ctrl_dt=0.02,
      sim_dt=0.004,
      episode_length=500,
      Kp=35.0,
      Kd=0.5,
      action_repeat=1,
      action_scale=0.3,
      soft_joint_pos_limit_factor=0.9,
      init_from_crouch=0.0,
      energy_termination_threshold=np.inf,
      noise_config=dict(
          level=1.0,
          scales=dict(
              joint_pos=0.01,
              joint_vel=1.5,
              gyro=0.2,
              gravity=0.05,
              linvel=0.1,
          ),
      ),
      reward_config=dict(
          scales=dict(
              height=1.0,
              orientation=1.0,
              contact=-0.1,
              action_rate=0.0,
              termination=0.0,
              dof_pos_limits=-0.5,
              torques=0.0,
              pose=-0.1,
              stay_still=0.0,
              energy=0.0,
              dof_acc=0.0,
          ),
      ),
  )


def _legs_geoms(legs) -> list:
  """The calf, thigh and hip geoms of ``legs``, in the JAX env's order."""
  return ([f'{leg}_{seg}' for leg in legs for seg in ('calf1', 'calf2')]
          + [f'{leg}_{seg}' for leg in legs
             for seg in ('thigh1', 'thigh2', 'thigh3')]
          + [f'{leg}_hip' for leg in legs])


class Handstand(go2_base.Go2Env):
  """Handstand on the front feet."""

  # the tracked joints (indices into the leg joints), the desired direction
  # of the imu's x axis, the torso height wanted, the geoms that must not
  # touch the floor and the feet whose floor contact costs
  _JOINT_IDS = (6, 7, 8, 9, 10, 11)
  _FORWARD = (0.0, 0.0, -1.0)
  _Z_DES = 0.55
  _UNWANTED = _legs_geoms(('fl', 'fr'))
  _FEET = ('RR', 'RL')

  def __init__(self, config: Optional[Mapping[str, Any]] = None,
               config_overrides: Optional[Mapping[str, Any]] = None,
               device='cuda', dtype: torch.dtype = torch.float32):
    super().__init__('full_flat', config or default_config(),
                     config_overrides, device=device, dtype=dtype)
    m = self._model
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                               device=m.device).to(dtype)
    self._init_q = f(self.keyframe_qpos('home'))
    self._crouch_q = f(self.keyframe_qpos('pre_recovery'))
    self._default_pose = self._init_q[7:]
    self._soft_lowers, self._soft_uppers = self._soft_limits(
        self._config.soft_joint_pos_limit_factor)
    self._floor_geom_id = name2id(m, 'geom', 'floor')
    self._z_des = self._Z_DES
    self._desired_forward_vec = f(self._FORWARD)
    self._joint_ids = torch.tensor(self._JOINT_IDS, device=m.device)
    self._joint_pose = self._default_pose[self._joint_ids]
    self._unwanted_contact_geom_ids = [name2id(m, 'geom', n)
                                       for n in self._UNWANTED]
    self._feet_geom_ids = [name2id(m, 'geom', n) for n in self._FEET]
    self._yaw_axis = f([0.0, 0.0, 1.0])

  @property
  def observation_size(self) -> Dict[str, tuple]:
    n_state = 9 + 3 * self._model.nu
    return {'state': (n_state,), 'privileged_state': (n_state + 49,)}

  def _contacts(self, data, geom_ids) -> torch.Tensor:
    """(B, len(geom_ids)) bool: each geom penetrating the floor."""
    return torch.stack([
        _collision.geoms_colliding(self._model, data, g, self._floor_geom_id)
        for g in geom_ids
    ], dim=1)

  # ----- reset ------------------------------------------------------------

  def sample_init(self, generator: torch.Generator,
                  batch_size: int) -> Dict[str, torch.Tensor]:
    """The random draws of a reset of ``batch_size`` envs: the start pose
    (crouch with probability ``init_from_crouch``, else home) moved by an
    xy offset and turned by a yaw, and the root velocity (zero from the
    crouch)."""
    m = self._model
    B = batch_size
    crouch = self._rand(generator, (B,)) < self._config.init_from_crouch
    qpos = torch.where(crouch[:, None], self._crouch_q, self._init_q).clone()
    qpos[:, 0:2] += self._uniform(generator, (B, 2), -0.5, 0.5)
    yaw = self._uniform(generator, (B,), -3.14, 3.14)
    quat = lie.axis_angle_to_quat(self._yaw_axis.expand(B, 3), yaw)
    qpos[:, 3:7] = lie.quat_mul(qpos[:, 3:7], quat)
    qvel = torch.zeros((B, m.nv), dtype=qpos.dtype, device=m.device)
    qvel[:, 0:6] = self._uniform(generator, (B, 6), -0.5, 0.5)
    qvel = torch.where(crouch[:, None], torch.zeros_like(qvel), qvel)
    return dict(qpos=qpos, qvel=qvel)

  def reset(self, generator: torch.Generator, batch_size: int) -> core.State:
    return self.reset_to(self.sample_init(generator, batch_size), generator)

  def reset_to(self, init: Mapping[str, torch.Tensor],
               generator: torch.Generator) -> core.State:
    """Start a batch from the draws ``init`` (the keys of ``sample_init``);
    ``generator`` serves every later draw of the episode."""
    m = self._model
    dtype, dev = m.qpos0.dtype, m.device
    qpos = init['qpos'].to(dev, dtype)
    B = qpos.shape[0]
    data = core.init(m, qpos=qpos, qvel=init['qvel'].to(dev, dtype),
                     ctrl=qpos[:, 7:])
    z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=dev)
    info = {
        'step': torch.zeros(B, dtype=torch.int32, device=dev),
        'rng': generator,
        'last_act': z(m.nu),
    }
    metrics = {f'reward/{k}': z() for k in self._config.reward_config.scales}
    obs = self._get_obs(data, info)
    return core.State(data, obs, z(), z(), metrics, info)

  # ----- step -------------------------------------------------------------

  def step(self, state: core.State, action: torch.Tensor) -> core.State:
    """Targets are deltas from the current ``ctrl``."""
    cfg = self._config
    info = dict(state.info)
    motor_targets = state.data.ctrl + action * cfg.action_scale
    data = core.step(self._model, state.data, motor_targets, self.n_substeps)
    contact = self._contacts(data, self._unwanted_contact_geom_ids)
    obs = self._get_obs(data, info)
    done = self._get_termination(data, contact)
    scales = cfg.reward_config.scales
    rewards = {k: v * scales[k]
               for k, v in self._get_reward(data, action, info, done).items()}
    reward = torch.clamp(sum(rewards.values()) * self.dt, 0.0, 10000.0)
    info['step'] = info['step'] + 1
    info['last_act'] = action
    metrics = dict(state.metrics)
    for k, v in rewards.items():
      metrics[f'reward/{k}'] = v
    return state.replace(data=data, obs=obs, reward=reward,
                         done=done.to(reward.dtype), metrics=metrics,
                         info=info)

  def _get_termination(self, data, contact) -> torch.Tensor:
    fall = self.get_upvector(data)[:, -1] < -0.25
    energy = torch.sum(torch.abs(data.actuator_force)
                       * torch.abs(data.qvel[:, 6:]), dim=-1)
    energy_term = energy > self._config.energy_termination_threshold
    return fall | torch.any(contact, dim=-1) | energy_term

  def _get_obs(self, data, info: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The noisy 45-dim state and the 94-dim privileged state."""
    sc = self._config.noise_config.scales
    gen = info['rng']
    noisy_gyro = self._noisy(gen, self.get_gyro(data), sc.gyro)
    noisy_gravity = self._noisy(gen, self.get_gravity(data), sc.gravity)
    noisy_joint_angles = self._noisy(gen, data.qpos[:, 7:], sc.joint_pos)
    noisy_joint_vel = self._noisy(gen, data.qvel[:, 6:], sc.joint_vel)
    noisy_linvel = self._noisy(gen, self.get_local_linvel(data), sc.linvel)
    state = torch.cat([
        noisy_linvel,
        noisy_gyro,
        noisy_gravity,
        noisy_joint_angles - self._default_pose,
        noisy_joint_vel,
        info['last_act'],
    ], dim=-1)
    privileged_state = torch.cat([state, self._privileged_tail(data)], dim=-1)
    return {'state': state, 'privileged_state': privileged_state}

  # ----- rewards ----------------------------------------------------------

  def _get_reward(self, data, action, info, done) -> Dict[str, torch.Tensor]:
    """The eleven unscaled terms, each (B,)."""
    sq = torch.square
    dtype = data.qpos.dtype
    forward = data.site_xmat[:, self._imu_site_id, :, 0]  # xmat · e_x
    torso_height = self._torso_height(data)
    joint_angles = data.qpos[:, 7:]
    qvel = data.qvel
    torques = data.actuator_force
    normalized = 0.5 * torch.sum(forward * self._desired_forward_vec,
                                 dim=-1) + 0.5
    return {
        'height': torch.exp(
            -(self._z_des - torch.clamp(torso_height, max=self._z_des))
            / 1.0),
        'orientation': sq(normalized),
        'contact': torch.any(self._contacts(data, self._feet_geom_ids),
                             dim=-1).to(dtype),
        'action_rate': torch.sum(sq(action - info['last_act']), dim=-1),
        'torques': torch.sum(sq(torques), dim=-1),
        'termination': done.to(dtype),
        'dof_pos_limits': torch.sum(
            -torch.clamp(joint_angles - self._soft_lowers, max=0.0)
            + torch.clamp(joint_angles - self._soft_uppers, min=0.0), dim=-1),
        'dof_acc': torch.sum(sq(data.qacc[:, 6:]), dim=-1),
        'pose': torch.sum(
            sq(joint_angles[:, self._joint_ids] - self._joint_pose), dim=-1),
        'stay_still': torch.sum(sq(qvel[:, :2]), dim=-1) + sq(qvel[:, 5]),
        'energy': torch.sum(torch.abs(qvel[:, 6:]) * torch.abs(torques),
                            dim=-1),
    }


class Footstand(Handstand):
  """Stand on the rear feet: the front legs' joints tracked, the imu's x axis wanted up, and the rear legs' geoms
  kept off the floor."""

  _JOINT_IDS = (0, 1, 2, 3, 4, 5)
  _FORWARD = (0.0, 0.0, 1.0)
  _Z_DES = 0.53
  _UNWANTED = _legs_geoms(('rl', 'rr'))
  _FEET = ('FR', 'FL')
