"""Go2 fall-recovery (getup) task, batched over envs.

Counterpart of ``rsr_mjx_tpu/envs/go2/getup.py`` on the full-collision
scene: with probability ``drop_from_height_prob`` an env starts 0.5 m up
with a random orientation and random joints, otherwise at home; the reset
then settles every env for ``settle_time / sim_dt`` substeps holding its
joints and sets the clock back to 0.  The action is a delta from the
current joint angles.  Rewards are the JAX env's nine terms, with the
posture and stand-still terms gated on uprightness; termination is on
energy (its threshold is inf by default).

Randomness comes from the ``torch.Generator`` handed to ``reset`` and
travels in ``info['rng']``; ``sample_init`` holds the reset draws and
``reset_to`` starts a batch from given ones (settle included), which is
how the tests hand the port JAX's draws.

Frozen copy of the port's ``envs/go2/getup.py`` at commit b767582 (the
file is as it was at 521e15e, where the rest of the copy was taken), its
imports renamed.  Importing it adds the full-collision scene,
``full_flat``, to the frozen ``snapshot.TASKS`` (its snapshot is
``assets/go2_full_flat.npz``, a byte copy of the port's), which the
frozen registry leaves out.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from benchmark.reference.frozen.envs import core
from benchmark.reference.frozen.envs.config import Config
from benchmark.reference.frozen.envs.go2 import base as go2_base
from benchmark.reference.frozen.envs.go2 import snapshot

snapshot.TASKS.setdefault('full_flat', 'go2_full_flat.npz')


def default_config() -> Config:
  """The JAX env's defaults, key for key."""
  return Config(
      ctrl_dt=0.02,
      sim_dt=0.004,
      Kp=35.0,
      Kd=0.5,
      episode_length=300,
      drop_from_height_prob=0.6,
      settle_time=0.5,
      action_repeat=1,
      action_scale=0.5,
      soft_joint_pos_limit_factor=0.95,
      energy_termination_threshold=np.inf,
      noise_config=dict(
          level=1.0,
          scales=dict(
              joint_pos=0.03,
              joint_vel=1.5,
              gyro=0.2,
              gravity=0.05,
          ),
      ),
      reward_config=dict(
          scales=dict(
              orientation=1.0,
              torso_height=1.0,
              posture=1.0,
              stand_still=1.0,
              action_rate=-0.001,
              dof_pos_limits=-0.1,
              torques=-1e-5,
              dof_acc=-2.5e-7,
              dof_vel=-0.1,
          ),
      ),
  )


class Getup(go2_base.Go2Env):
  """Recover from a fall and stand up."""

  def __init__(self, config: Optional[Mapping[str, Any]] = None,
               config_overrides: Optional[Mapping[str, Any]] = None,
               device='cuda', dtype: torch.dtype = torch.float32):
    super().__init__('full_flat', config or default_config(),
                     config_overrides, device=device, dtype=dtype)
    m = self._model
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                               device=m.device).to(dtype)
    home = self.keyframe_qpos('home')
    self._init_q = f(home)
    self._default_pose = f(home[7:])
    jr = m.jnt_range[1:]
    self._lowers, self._uppers = jr[:, 0], jr[:, 1]
    self._soft_lowers, self._soft_uppers = self._soft_limits(
        self._config.soft_joint_pos_limit_factor)
    self._settle_steps = int(self._config.settle_time / self.sim_dt)
    self._z_des = 0.275
    self._up_vec = f([0.0, 0.0, -1.0])

  @property
  def observation_size(self) -> Dict[str, tuple]:
    n_state = 6 + 3 * self._model.nu
    return {'state': (n_state,), 'privileged_state': (n_state + 49,)}

  # ----- reset ------------------------------------------------------------

  def sample_init(self, generator: torch.Generator,
                  batch_size: int) -> Dict[str, torch.Tensor]:
    """The random draws of a reset of ``batch_size`` envs: the start pose
    (a drop with probability ``drop_from_height_prob``, else home) and the
    root velocity."""
    m = self._model
    B = batch_size
    drop = self._rand(generator, (B,)) < self._config.drop_from_height_prob
    qpos_drop = torch.zeros((B, m.nq), dtype=self._init_q.dtype,
                            device=m.device)
    qpos_drop[:, 2] = 0.5
    quat = core.randn(generator, (B, 4))
    quat = quat.to(m.device, qpos_drop.dtype)
    qpos_drop[:, 3:7] = quat / (torch.linalg.vector_norm(
        quat, dim=-1, keepdim=True) + 1e-6)
    qpos_drop[:, 7:] = self._uniform(generator, (B, m.nu), self._lowers,
                                     self._uppers)
    qpos = torch.where(drop[:, None], qpos_drop, self._init_q)
    qvel = torch.zeros((B, m.nv), dtype=qpos.dtype, device=m.device)
    qvel[:, 0:6] = self._uniform(generator, (B, 6), -0.5, 0.5)
    return dict(qpos=qpos, qvel=qvel)

  def reset(self, generator: torch.Generator, batch_size: int) -> core.State:
    return self.reset_to(self.sample_init(generator, batch_size), generator)

  def reset_to(self, init: Mapping[str, torch.Tensor],
               generator: torch.Generator) -> core.State:
    """Start a batch from the draws ``init`` (the keys of ``sample_init``):
    settle ``settle_time`` holding the start's joint angles, then set the
    clock to 0.  ``generator`` serves every later draw of the episode."""
    m = self._model
    dtype, dev = m.qpos0.dtype, m.device
    qpos = init['qpos'].to(dev, dtype)
    B = qpos.shape[0]
    data = core.init(m, qpos=qpos, qvel=init['qvel'].to(dev, dtype),
                     ctrl=qpos[:, 7:])
    data = core.step(m, data, qpos[:, 7:], self._settle_steps)
    data = data.replace(time=torch.zeros_like(data.time))
    z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=dev)
    info = {'rng': generator, 'last_act': z(m.nu), 'last_last_act': z(m.nu)}
    metrics = {f'reward/{k}': z() for k in self._config.reward_config.scales}
    obs = self._get_obs(data, info)
    return core.State(data, obs, z(), z(), metrics, info)

  # ----- step -------------------------------------------------------------

  def step(self, state: core.State, action: torch.Tensor) -> core.State:
    """Targets are deltas from the current joint angles."""
    cfg = self._config
    info = dict(state.info)
    motor_targets = state.data.qpos[:, 7:] + action * cfg.action_scale
    data = core.step(self._model, state.data, motor_targets, self.n_substeps)
    obs = self._get_obs(data, info)
    done = self._get_termination(data)
    scales = cfg.reward_config.scales
    rewards = {k: v * scales[k]
               for k, v in self._get_reward(data, action, info).items()}
    reward = torch.clamp(sum(rewards.values()) * self.dt, 0.0, 10000.0)
    info['last_last_act'] = info['last_act']
    info['last_act'] = action
    metrics = dict(state.metrics)
    for k, v in rewards.items():
      metrics[f'reward/{k}'] = v
    return state.replace(data=data, obs=obs, reward=reward,
                         done=done.to(reward.dtype), metrics=metrics,
                         info=info)

  def _get_termination(self, data) -> torch.Tensor:
    energy = torch.sum(torch.abs(data.actuator_force * data.qvel[:, 6:]),
                       dim=-1)
    return energy > self._config.energy_termination_threshold

  def _get_obs(self, data, info: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The noisy 42-dim state and the 91-dim privileged state."""
    sc = self._config.noise_config.scales
    gen = info['rng']
    noisy_gyro = self._noisy(gen, self.get_gyro(data), sc.gyro)
    noisy_gravity = self._noisy(gen, self.get_gravity(data), sc.gravity)
    noisy_joint_angles = self._noisy(gen, data.qpos[:, 7:], sc.joint_pos)
    noisy_joint_vel = self._noisy(gen, data.qvel[:, 6:], sc.joint_vel)
    state = torch.cat([
        noisy_gyro,
        noisy_gravity,
        noisy_joint_angles - self._default_pose,
        noisy_joint_vel,
        info['last_act'],
    ], dim=-1)
    privileged_state = torch.cat([state, self._privileged_tail(data)], dim=-1)
    return {'state': state, 'privileged_state': privileged_state}

  # ----- rewards ----------------------------------------------------------

  def _get_reward(self, data, action, info) -> Dict[str, torch.Tensor]:
    """The nine unscaled terms, each (B,)."""
    sq = torch.square
    torso_height = self._torso_height(data)
    joint_angles = data.qpos[:, 7:]
    gravity = self.get_gravity(data)
    dtype = joint_angles.dtype
    is_upright = self._is_upright(gravity).to(dtype)
    gate = is_upright * self._is_at_desired_height(torso_height).to(dtype)
    torques = data.actuator_force
    last, last_last = info['last_act'], info['last_last_act']
    return {
        'orientation': torch.exp(
            -2.0 * torch.sum(sq(self._up_vec - gravity), dim=-1)),
        'torso_height': torch.exp(
            torch.clamp(torso_height, max=self._z_des)) - 1.0,
        'posture': is_upright * torch.exp(
            -0.5 * torch.sum(sq(joint_angles - self._default_pose), dim=-1)),
        'stand_still': gate * torch.exp(-0.5 * torch.sum(sq(action), dim=-1)),
        'action_rate': (torch.sum(sq(action - last), dim=-1)
                        + torch.sum(sq(action - 2 * last + last_last),
                                    dim=-1)),
        'torques': (torch.sqrt(torch.sum(sq(torques), dim=-1))
                    + torch.sum(torch.abs(torques), dim=-1)),
        'dof_pos_limits': torch.sum(
            -torch.clamp(joint_angles - self._soft_lowers, max=0.0)
            + torch.clamp(joint_angles - self._soft_uppers, min=0.0), dim=-1),
        'dof_acc': torch.sum(sq(data.qacc[:, 6:]), dim=-1),
        'dof_vel': torch.sum(
            sq(torch.clamp(torch.abs(data.qvel[:, 6:]) - 2.0 * np.pi,
                           min=0.0)), dim=-1),
    }

  def _is_upright(self, gravity, ori_tol: float = 0.01) -> torch.Tensor:
    """(B,) bool: the gravity direction within ``ori_tol`` (squared) of
    straight down."""
    return torch.sum(torch.square(self._up_vec - gravity), dim=-1) < ori_tol

  def _is_at_desired_height(self, torso_height,
                            pos_tol: float = 0.005) -> torch.Tensor:
    height = torch.clamp(torso_height, max=self._z_des)
    return (self._z_des - height) < pos_tol
