"""Go2 joystick locomotion task, batched over envs.

Counterpart of ``rsr_mjx_tpu/envs/go2/joystick.py``: 21 reward and cost
terms, action and IMU delay buffers, Bernoulli-masked random-walk command
resampling, optional torso velocity-kick perturbations, and a dict
observation with the 48-dim ``state`` and the 123-dim privileged critic
state.  Reward, done and observations are those of the JAX env written over
a leading env axis.

Randomness: every draw of the JAX env (observation noise, reset pose and
velocity, the exponential command interval, the Bernoulli command masks,
the kick direction) comes from the ``torch.Generator`` handed to ``reset``,
with the same distribution; it travels in ``info['rng']`` as the JAX key
does.  The streams differ from JAX's by nature.  ``sample_init`` holds the
reset draws and ``reset_to`` starts a batch from given ones, which is how
the tests feed both packages the same start.

Every step builds new ``info`` and ``metrics`` dicts (the JAX env mutates
``state.info`` in place).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from benchmark.reference.frozen.envs import core
from benchmark.reference.frozen.envs.config import Config
from benchmark.reference.frozen.envs.go2 import base as go2_base
from benchmark.reference.frozen.physics import collision as _collision
from benchmark.reference.frozen.physics import lie
from benchmark.reference.frozen.physics.io import name2id


def default_config() -> Config:
  """The JAX env's defaults, key for key."""
  return Config(
      ctrl_dt=0.02,
      sim_dt=0.004,
      episode_length=1000,
      Kp=60.0,
      Kd=3.0,
      action_repeat=1,
      action_scale=0.5,
      history_len=1,
      soft_joint_pos_limit_factor=0.95,
      noise_config=dict(
          level=1.0,
          scales=dict(
              joint_pos=0.03,
              joint_vel=1.5,
              gyro=0.2,
              gravity=0.05,
              linvel=0.1,
          ),
      ),
      reward_config=dict(
          scales=dict(
              tracking_lin_vel=3.0,
              tracking_ang_vel=1.5,
              lin_vel_z=-0.5,
              ang_vel_xy=-0.05,
              orientation=-3.0,
              dof_pos_limits=-1.0,
              pose=0.0,
              termination=-1.0,
              stand_still=-1.0,
              torques=-0.0002,
              action_rate=-0.01,
              energy=-0.001,
              feet_clearance=-2.0,
              feet_height=-3.5,
              feet_slip=-0.1,
              feet_air_time=0.8,
              all_feet_air=-1.0,
              symmetric_gait=-0.8,
              lr_symmetry=-0.8,
              fb_symmetry=-0.8,
              feet_off_ground_when_still=-1.0,
          ),
          tracking_sigma=0.25,
          max_foot_height=0.12,
      ),
      pert_config=dict(
          enable=False,
          velocity_kick=[0.0, 3.0],
          kick_durations=[0.05, 0.2],
          kick_wait_times=[1.0, 3.0],
      ),
      command_config=dict(
          a=[0.8, 0.0, 2.0],
          b=[0.8, 0.0, 0.8],
          change_interval=12.0,
      ),
      delay_config=dict(
          action=dict(enable=True, steps=3),
          imu=dict(enable=True, steps=3),
      ),
  )


def _norm(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=-1)


class Joystick(go2_base.Go2Env):
  """Track a joystick command."""

  def __init__(self, task: str = 'flat_terrain',
               config: Optional[Mapping[str, Any]] = None,
               config_overrides: Optional[Mapping[str, Any]] = None,
               device='cuda', dtype: torch.dtype = torch.float32):
    super().__init__(task, config or default_config(), config_overrides,
                     device=device, dtype=dtype)
    m = self._model
    dev = m.device
    f = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                               device=dev).to(dtype)
    home = self.keyframe_qpos('home')
    self._init_q = f(home)
    self._default_pose = f(home[7:])
    jr = m.jnt_range[1:]
    self._lowers, self._uppers = jr[:, 0], jr[:, 1]
    factor = self._config.soft_joint_pos_limit_factor
    self._soft_lowers = self._lowers * factor
    self._soft_uppers = self._uppers * factor
    self._torso_body_id = name2id(m, 'body', go2_base.ROOT_BODY)
    # subtree mass of the trunk = total robot mass
    self._torso_mass = float(m.body_mass.sum().item())
    self._feet_site_id = torch.tensor(
        [name2id(m, 'site', n) for n in go2_base.FEET_SITES], device=dev)
    self._floor_geom_id = name2id(m, 'geom', 'floor')
    self._feet_geom_id = [name2id(m, 'geom', n) for n in go2_base.FEET_GEOMS]
    adrs = []
    for site in go2_base.FEET_SITES:
      adr = int(m.sensor_adr[name2id(m, 'sensor', f'{site}_global_linvel')])
      adrs.append(list(range(adr, adr + 3)))
    self._foot_linvel_sensor_adr = torch.tensor(adrs, device=dev)  # (4, 3)
    self._cmd_a = f(self._config.command_config.a)
    self._cmd_b = f(self._config.command_config.b)
    self._pose_weight = f([1.0, 1.0, 0.1] * 4)
    self._yaw_axis = f([0.0, 0.0, 1.0])

  @property
  def observation_size(self) -> Dict[str, tuple]:
    nu = self._model.nu
    n_state = 9 + 3 * nu + 3
    return {'state': (n_state,),
            'privileged_state': (n_state + 15 + 3 * nu + 4 + 12 + 4 + 3 + 1,)}

  # ----- random draws ---------------------------------------------------

  def _exponential(self, generator, shape) -> torch.Tensor:
    return -torch.log1p(-self._rand(generator, shape))

  def _steps(self, seconds: torch.Tensor) -> torch.Tensor:
    return torch.round(seconds / self.dt).to(torch.int32)

  def sample_init(self, generator: torch.Generator,
                  batch_size: int) -> Dict[str, torch.Tensor]:
    """The random draws of a reset of ``batch_size`` envs: start state,
    first command and its interval, the perturbation schedule."""
    m = self._model
    B = batch_size
    qpos = self._init_q.expand(B, m.nq).clone()
    qpos[:, 0:2] += self._uniform(generator, (B, 2), -0.5, 0.5)
    yaw = self._uniform(generator, (B,), -3.14, 3.14)
    quat = lie.axis_angle_to_quat(self._yaw_axis.expand(B, 3), yaw)
    qpos[:, 3:7] = lie.quat_mul(qpos[:, 3:7], quat)
    qvel = torch.zeros((B, m.nv), dtype=qpos.dtype, device=qpos.device)
    qvel[:, 0:6] = self._uniform(generator, (B, 6), -0.5, 0.5)

    pc = self._config.pert_config
    time_until_next_pert = self._uniform(generator, (B,), *pc.kick_wait_times)
    pert_duration_seconds = self._uniform(generator, (B,),
                                          *pc.kick_durations)
    pert_mag = self._uniform(generator, (B,), *pc.velocity_kick)
    time_until_next_cmd = (self._exponential(generator, (B,))
                           * self._config.command_config.change_interval)
    command = self._uniform(generator, (B, 3), -self._cmd_a, self._cmd_a)
    return dict(
        qpos=qpos, qvel=qvel, command=command,
        steps_until_next_cmd=self._steps(time_until_next_cmd),
        steps_until_next_pert=self._steps(time_until_next_pert),
        pert_duration_seconds=pert_duration_seconds,
        pert_duration=self._steps(pert_duration_seconds),
        pert_mag=pert_mag,
    )

  def sample_command(self, generator: torch.Generator,
                     x_k: torch.Tensor) -> torch.Tensor:
    """Bernoulli-masked random walk of the command (B, 3)."""
    shape = x_k.shape
    y_k = self._uniform(generator, shape, -self._cmd_a, self._cmd_a)
    z_k = (self._rand(generator, shape) < self._cmd_b).to(x_k.dtype)
    w_k = (self._rand(generator, shape) < 0.5).to(x_k.dtype)
    return x_k - w_k * (x_k - y_k * z_k)

  # ----- reset ------------------------------------------------------------

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
    zi = lambda: torch.zeros(B, dtype=torch.int32, device=dev)
    i32 = lambda x: x.to(dev, torch.int32)
    dc = self._config.delay_config
    action_delay_steps = dc.action.steps if dc.action.enable else 0
    imu_delay_steps = dc.imu.steps if dc.imu.enable else 0
    info = {
        'rng': generator,
        'command': init['command'].to(dev, dtype),
        'steps_until_next_cmd': i32(init['steps_until_next_cmd']),
        'last_act': z(m.nu),
        'last_last_act': z(m.nu),
        'feet_air_time': z(4),
        'feet_contact_time': z(4),
        'last_contact': torch.zeros((B, 4), dtype=torch.bool, device=dev),
        'swing_peak': z(4),
        'steps_until_next_pert': i32(init['steps_until_next_pert']),
        'pert_duration_seconds': init['pert_duration_seconds'].to(dev, dtype),
        'pert_duration': i32(init['pert_duration']),
        'steps_since_last_pert': zi(),
        'pert_steps': zi(),
        'pert_dir': z(3),
        'pert_mag': init['pert_mag'].to(dev, dtype),
        'action_buffer': z(action_delay_steps + 1, m.nu),
        'gyro_buffer': z(imu_delay_steps + 1, 3),
        'linvel_buffer': z(imu_delay_steps + 1, 3),
        'gravity_buffer': z(imu_delay_steps + 1, 3),
    }
    metrics = {f'reward/{k}': z() for k in self._config.reward_config.scales}
    metrics['swing_peak'] = z()
    obs = self._get_obs(data, info)
    return core.State(data, obs, z(), z(), metrics, info)

  # ----- step -------------------------------------------------------------

  def step(self, state: core.State, action: torch.Tensor) -> core.State:
    m = self._model
    cfg = self._config
    info = dict(state.info)
    data = state.data
    if cfg.pert_config.enable:
      data = self._maybe_apply_perturbation(data, info)

    if cfg.delay_config.action.enable:
      actual_action = info['action_buffer'][:, 0]
      info['action_buffer'] = torch.cat(
          [info['action_buffer'][:, 1:], action[:, None, :]], dim=1)
    else:
      actual_action = action

    motor_targets = self._default_pose + actual_action * cfg.action_scale
    data = core.step(m, data, motor_targets, self.n_substeps)

    if cfg.delay_config.imu.enable:
      push = lambda buf, x: torch.cat([buf[:, 1:], x[:, None, :]], dim=1)
      info['gyro_buffer'] = push(info['gyro_buffer'], self.get_gyro(data))
      info['linvel_buffer'] = push(info['linvel_buffer'],
                                   self.get_local_linvel(data))
      info['gravity_buffer'] = push(info['gravity_buffer'],
                                    self.get_gravity(data))

    contact = torch.stack([
        _collision.geoms_colliding(m, data, gid, self._floor_geom_id)
        for gid in self._feet_geom_id
    ], dim=1)  # (B, 4) bool
    dtype = data.qpos.dtype
    contact_f = contact.to(dtype)
    contact_filt = contact | info['last_contact']
    first_contact = (info['feet_air_time'] > 0.0).to(dtype) * contact_filt
    info['feet_air_time'] = info['feet_air_time'] + self.dt
    p_fz = data.site_xpos[:, self._feet_site_id, 2]
    info['swing_peak'] = torch.maximum(info['swing_peak'], p_fz)

    obs = self._get_obs(data, info)
    done = self.get_upvector(data)[:, -1] < 0.0

    scales = cfg.reward_config.scales
    rewards = {
        k: v * scales[k]
        for k, v in self._get_reward(data, action, info, done, first_contact,
                                     contact).items()
    }
    reward = torch.clamp(sum(rewards.values()) * self.dt, 0.0, 10000.0)

    info['last_last_act'] = info['last_act']
    info['last_act'] = action
    info['steps_until_next_cmd'] = info['steps_until_next_cmd'] - 1
    due = info['steps_until_next_cmd'] <= 0
    gen = info['rng']
    info['command'] = torch.where(
        due[:, None], self.sample_command(gen, info['command']),
        info['command'])
    info['steps_until_next_cmd'] = torch.where(
        done | due,
        self._steps(self._exponential(gen, due.shape)
                    * cfg.command_config.change_interval),
        info['steps_until_next_cmd'])
    # the reference adds dt to the air time twice per step (before the
    # observation and here)
    info['feet_air_time'] = (info['feet_air_time'] + self.dt) * (~contact)
    info['feet_contact_time'] = ((info['feet_contact_time'] + self.dt)
                                 * contact_f)
    info['last_contact'] = contact
    info['swing_peak'] = info['swing_peak'] * (~contact)
    metrics = dict(state.metrics)
    for k, v in rewards.items():
      metrics[f'reward/{k}'] = v
    metrics['swing_peak'] = torch.mean(info['swing_peak'], dim=-1)

    return state.replace(data=data, obs=obs, reward=reward,
                         done=done.to(reward.dtype), metrics=metrics,
                         info=info)

  def _get_obs(self, data, info: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The noisy 48-dim state and the privileged state, per env."""
    cfg = self._config
    if cfg.delay_config.imu.enable:
      gyro = info['gyro_buffer'][:, 0]
      linvel = info['linvel_buffer'][:, 0]
      gravity = info['gravity_buffer'][:, 0]
    else:
      gyro = self.get_gyro(data)
      linvel = self.get_local_linvel(data)
      gravity = self.get_gravity(data)

    nc = cfg.noise_config
    gen = info['rng']

    def noisy(x, scale):
      return x + (2 * self._rand(gen, x.shape) - 1) * (nc.level * scale)

    noisy_gyro = noisy(gyro, nc.scales.gyro)
    noisy_gravity = noisy(gravity, nc.scales.gravity)
    noisy_linvel = noisy(linvel, nc.scales.linvel)
    joint_angles = data.qpos[:, 7:]
    noisy_joint_angles = noisy(joint_angles, nc.scales.joint_pos)
    joint_vel = data.qvel[:, 6:]
    noisy_joint_vel = noisy(joint_vel, nc.scales.joint_vel)

    state = torch.cat([
        noisy_linvel,
        noisy_gyro,
        noisy_gravity,
        noisy_joint_angles - self._default_pose,
        noisy_joint_vel,
        info['last_act'],
        info['command'],
    ], dim=-1)
    dtype = state.dtype
    feet_vel = data.sensordata[:, self._foot_linvel_sensor_adr.reshape(-1)]
    pert_due = (info['steps_since_last_pert']
                >= info['steps_until_next_pert'])
    privileged_state = torch.cat([
        state,
        self.get_gyro(data),
        self.get_accelerometer(data),
        self.get_gravity(data),
        self.get_local_linvel(data),
        self.get_global_angvel(data),
        joint_angles - self._default_pose,
        joint_vel,
        data.actuator_force,
        info['last_contact'].to(dtype),
        feet_vel,
        info['feet_air_time'],
        data.xfrc_applied[:, self._torso_body_id, :3],
        pert_due.to(dtype)[:, None],
    ], dim=-1)
    return {'state': state, 'privileged_state': privileged_state}

  # ----- rewards ----------------------------------------------------------

  def _get_reward(self, data, action, info, done, first_contact,
                  contact) -> Dict[str, torch.Tensor]:
    """The 21 unscaled terms, each (B,)."""
    cmd = info['command']
    qpos = data.qpos[:, 7:]
    dtype = qpos.dtype
    cmd_norm = _norm(cmd)
    moving = (cmd_norm > 0.01).to(dtype)
    still = (cmd_norm < 0.01).to(dtype)
    rc = self._config.reward_config
    sq = torch.square
    air, con = info['feet_air_time'], info['feet_contact_time']
    feet_vel = data.sensordata[:, self._foot_linvel_sensor_adr]  # (B, 4, 3)
    foot_z = data.site_xpos[:, self._feet_site_id, 2]
    torques = data.actuator_force
    num_air = torch.sum((~contact).to(torch.int32), dim=-1)

    def symmetry(a, b):
      """Squared air and contact time difference of foot pairs a and b."""
      mean = lambda x, p: (x[:, p[0]] + x[:, p[1]]) / 2.0
      return (sq(mean(air, a) - mean(air, b))
              + sq(mean(con, a) - mean(con, b))) * moving

    return {
        'tracking_lin_vel': torch.exp(
            -torch.sum(sq(cmd[:, :2] - self.get_local_linvel(data)[:, :2]),
                       dim=-1) / rc.tracking_sigma),
        'tracking_ang_vel': torch.exp(
            -sq(cmd[:, 2] - self.get_gyro(data)[:, 2]) / rc.tracking_sigma),
        'lin_vel_z': sq(self.get_global_linvel(data)[:, 2]),
        'ang_vel_xy': torch.sum(sq(self.get_global_angvel(data)[:, :2]),
                                dim=-1),
        'orientation': torch.sum(sq(self.get_upvector(data)[:, :2]), dim=-1),
        'stand_still': torch.sum(torch.abs(qpos - self._default_pose),
                                 dim=-1) * still,
        'termination': done.to(dtype),
        'pose': torch.exp(-torch.sum(
            sq(qpos - self._default_pose) * self._pose_weight, dim=-1)),
        'torques': (torch.sqrt(torch.sum(sq(torques), dim=-1))
                    + torch.sum(torch.abs(torques), dim=-1)),
        'action_rate': torch.sum(sq(action - info['last_act']), dim=-1),
        'energy': torch.sum(
            torch.abs(data.qvel[:, 6:]) * torch.abs(torques), dim=-1),
        'feet_slip': torch.sum(
            torch.sum(sq(feet_vel[..., :2]), dim=-1) * contact, dim=-1)
                     * moving,
        'feet_clearance': torch.sum(
            torch.abs(foot_z - rc.max_foot_height)
            * torch.sqrt(_norm(feet_vel[..., :2])), dim=-1),
        'feet_height': torch.sum(
            sq(info['swing_peak'] / rc.max_foot_height - 1.0)
            * first_contact, dim=-1) * moving,
        'feet_air_time': torch.sum((air - 0.1) * first_contact, dim=-1)
                         * moving,
        'dof_pos_limits': torch.sum(
            -torch.clamp(qpos - self._soft_lowers, max=0.0)
            + torch.clamp(qpos - self._soft_uppers, min=0.0), dim=-1),
        'all_feet_air': (num_air >= 3).to(dtype) * moving,
        # diagonal pairs: FL vs RR, FR vs RL
        'symmetric_gait': (
            torch.sum(sq(qpos[:, 3:6] - qpos[:, 6:9]), dim=-1)
            + torch.sum(sq(qpos[:, 0:3] - qpos[:, 9:12]), dim=-1)) * moving,
        'lr_symmetry': symmetry((1, 3), (0, 2)),
        'fb_symmetry': symmetry((0, 1), (2, 3)),
        'feet_off_ground_when_still': num_air.to(dtype) * still,
    }

  # ----- perturbation kicks -------------------------------------------------

  def _maybe_apply_perturbation(self, data, info: Dict[str, Any]):
    """Per env, either apply the running kick or wait for the next one (the
    reference's ``lax.cond``, as a batched ``where``).  Updates ``info`` and
    returns ``data`` with ``xfrc_applied`` set."""
    since, until = info['steps_since_last_pert'], info['steps_until_next_pert']
    pert_steps, pert_dir = info['pert_steps'], info['pert_dir']
    kicking = since >= until

    # the kick: half a sine of the planned impulse along pert_dir
    dur = info['pert_duration_seconds']
    u_t = 0.5 * torch.sin(math.pi * (pert_steps * self.dt) / dur)
    force = u_t * self._torso_mass * info['pert_mag'] / dur
    since_kick = torch.where(pert_steps >= info['pert_duration'],
                             torch.zeros_like(since), since)
    # the wait: count up, and draw the next direction when the wait ends
    angle = self._uniform(info['rng'], since.shape, 0.0, 2 * math.pi)
    new_dir = torch.stack(
        [torch.cos(angle), torch.sin(angle), torch.zeros_like(angle)], dim=-1)
    since_wait = since + 1
    starts = since_wait >= until

    xfrc = torch.zeros_like(data.xfrc_applied)
    xfrc[:, self._torso_body_id, :3] = torch.where(
        kicking[:, None], force[:, None] * pert_dir, xfrc.new_zeros(()))
    info['steps_since_last_pert'] = torch.where(kicking, since_kick,
                                                since_wait)
    info['pert_steps'] = torch.where(
        kicking, pert_steps + 1,
        torch.where(starts, torch.zeros_like(pert_steps), pert_steps))
    info['pert_dir'] = torch.where((~kicking & starts)[:, None], new_dir,
                                   pert_dir)
    return data.replace(xfrc_applied=xfrc)
