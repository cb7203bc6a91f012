"""Airbot Play cube-push environment, batched over envs.

Counterpart of ``rsr_mjx_tpu/envs/airbot/cube_push.py``, its training
variant (``variant='train'``: cube.xml frictions, cube-fall done, no
hysteresis); the port's 'rsr' variant is left out of this copy.
Reward, done and observation are those of the JAX env (its :203-304),
written over a leading env axis.

The model comes from the committed snapshot (``snapshot.py``), so the env
runs where ``mujoco`` is not installed.  Reset noise comes from an explicit
``torch.Generator``; ``reset_to`` starts a batch from given initial states,
which is how the tests feed both packages the same start.

Action contract (5-dim): delta position targets for actuators
(j1, j2, j3, j5, j6) scaled by [0.02, 0.02, 0.02, 0, 0]; the j5 target keeps
the end-effector pointing down (``-(1.57 + q2 + q3)``) and the j6 target
points the gripper along the cube→target bearing.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from benchmark.reference.frozen.envs import core
from benchmark.reference.frozen.envs.airbot import snapshot
from benchmark.reference.frozen.physics import io
from benchmark.reference.frozen.physics.io import name2id
from benchmark.reference.frozen.physics.types import Model

_JOINT_OFFSET = (0.0, -0.5422302, 0.45173569, 1.5718, -1.4794435, 1.1731174)
_CTRL_BASE = (0.0, -0.73151061, 0.455936904, -1.4794435, 1.1731174)
_NEW_CUBE_POS = (0.37342, -0.07989)


class AirbotCubePush(core.Env):
  """Cube-push manipulation task over a batch of envs."""

  def __init__(
      self,
      variant: str = 'train',
      push_reward_weight: float = 6.0,
      siet_to_box_reward_weight: float = 3.0,
      healthy_reward: float = 1.0,
      endpoint_min_z_pos: float | None = None,
      noise_scale: float = 1e-2,
      decimation: int = 4,
      cube_min_x: float | None = None,
      cube_max_x: float | None = None,
      cube_min_y: float | None = None,
      cube_max_y: float | None = None,
      target_min_x: float | None = None,
      target_max_x: float | None = None,
      target_min_y: float | None = None,
      target_max_y: float | None = None,
      max_contacts: int = 24,
      device='cuda',
      dtype: torch.dtype = torch.float32,
  ):
    """``dtype`` is that of the physics: float32, or float64 on the CPU as
    a reference (the CUDA kernels take float32 only)."""
    if variant != 'train':
      raise ValueError(f'the frozen copy has no cube-push variant {variant!r}')
    self.variant = variant
    spawn = dict(
        cube_min_x=0.29, cube_max_x=0.34,
        cube_min_y=-0.04, cube_max_y=0.01,
        target_min_x=0.4364427, target_max_x=0.4864427,
        target_min_y=0.07352592, target_max_y=0.12352592,
    )
    self._endpoint_min_z = (
        0.778 if endpoint_min_z_pos is None else endpoint_min_z_pos
    )
    overrides = dict(
        cube_min_x=cube_min_x, cube_max_x=cube_max_x,
        cube_min_y=cube_min_y, cube_max_y=cube_max_y,
        target_min_x=target_min_x, target_max_x=target_max_x,
        target_min_y=target_min_y, target_max_y=target_max_y,
    )
    spawn.update({k: v for k, v in overrides.items() if v is not None})

    # the snapshot holds the compiled scene; max_contacts > 0 sets the
    # top-k contact selection the fused step requires
    m = io.load_model_npz(snapshot.path(variant), device=device)
    if dtype != torch.float32:
      m = m.to(device, dtype)
    self._model = io._apply_max_contacts(m.replace(ncon_sel=0), max_contacts)
    self._push_w = push_reward_weight
    self._site2box_w = siet_to_box_reward_weight
    self._healthy_w = healthy_reward
    self._noise = noise_scale
    self._decimation = decimation

    m = self._model
    dev = m.device
    # constants rounded to float32 whatever the dtype, so that a float64
    # run poses the float32 run's problem
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev).to(dtype)
    self._action_scale = f([0.02, 0.02, 0.02, 0.0, 0.0])
    self._joint_offset = f(_JOINT_OFFSET)
    self._ctrl_base = f(_CTRL_BASE)
    self._new_cube_pos = f(_NEW_CUBE_POS)
    self._target_lo = f([spawn['target_min_x'], spawn['target_min_y'], 0.82])
    self._target_hi = f([spawn['target_max_x'], spawn['target_max_y'], 0.82])
    self._cube_lo = f([spawn['cube_min_x'], spawn['cube_min_y'], 0.82])
    self._cube_hi = f([spawn['cube_max_x'], spawn['cube_max_y'], 0.82])
    self._cube_body = name2id(m, 'body', 'cube_for_push')
    self._target_body = name2id(m, 'body', 'target_pos')
    self._site_id = name2id(m, 'site', 'endpoint')
    jnames = ['joint1', 'joint2', 'joint3', 'joint4', 'joint5', 'joint6']
    self._joint_qadr = np.array(
        [m.jnt_qposadr[name2id(m, 'joint', j)] for j in jnames]
    )
    self._joint_idx = torch.as_tensor(self._joint_qadr, device=dev)
    self._finger_qadr = int(m.jnt_qposadr[name2id(m, 'joint', 'endleft')])
    self._box_qadr = int(m.jnt_qposadr[m.body_jntadr[self._cube_body]])
    self._target_qadr = int(m.jnt_qposadr[m.body_jntadr[self._target_body]])
    self._lowers = m.actuator_ctrlrange[:, 0]
    self._uppers = m.actuator_ctrlrange[:, 1]

  # -- Env interface ---------------------------------------------------

  @property
  def model(self) -> Model:
    return self._model

  def bind_model(self, model: Model) -> None:
    """Step with ``model`` from now on: one with the same topology whose
    leaves may carry a gradient (env-parameter tuning binds a model with
    the tuned friction to a copy of the env)."""
    self._model = model

  @property
  def action_size(self) -> int:
    return 5

  @property
  def observation_size(self) -> int:
    return 23

  @property
  def ctrl_dt(self) -> float:
    return 0.0025 * self._decimation

  @property
  def sim_dt(self) -> float:
    return 0.0025

  @property
  def n_substeps(self) -> int:
    return self._decimation

  def sample_init(self, generator: torch.Generator, batch_size: int):
    """Random initial (qpos, qvel, ctrl) of ``batch_size`` envs, drawn on the
    generator's device and moved to the model's."""
    m = self._model
    B, n = batch_size, self._noise
    dev = m.device

    def uniform(shape, lo, hi):
      u = core.rand(generator, shape)
      return lo + (hi - lo) * u.to(dev)

    qpos = m.qpos0 + uniform((B, m.nq), -n, n)
    qpos[:, self._joint_idx] += self._joint_offset
    qpos[:, self._finger_qadr] = -0.033
    qvel = uniform((B, m.nv), -n, n)
    ctrl = self._ctrl_base + uniform((B, m.nu), -n, n)
    target_pos = uniform((B, 3), self._target_lo, self._target_hi)
    cube_pos = uniform((B, 3), self._cube_lo, self._cube_hi)
    qpos[:, self._box_qadr : self._box_qadr + 3] = cube_pos
    qpos[:, self._target_qadr : self._target_qadr + 3] = target_pos
    return qpos, qvel, ctrl

  def reset(self, generator: torch.Generator, batch_size: int) -> core.State:
    return self.reset_to(*self.sample_init(generator, batch_size))

  def reset_to(self, qpos: torch.Tensor, qvel: torch.Tensor,
               ctrl: torch.Tensor) -> core.State:
    """Start a batch from initial (qpos (B, nq), qvel (B, nv), ctrl (B, nu));
    as in the JAX env, forward runs before ctrl is set."""
    m = self._model
    data = core.init(m, qpos=qpos, qvel=qvel)
    data = data.replace(ctrl=ctrl.to(data.ctrl.dtype))
    B = qpos.shape[0]
    zero = torch.zeros(B, dtype=m.qpos0.dtype, device=m.device)
    metrics = {
        'push_reward': zero,
        'ctrl_cost': zero,
        'siet_to_box_reward': zero,
    }
    info = {
        'target_pos': data.xpos[:, self._target_body],
        'new_cube_pos': self._new_cube_pos.expand(B, 2).clone(),
        'site_pos': data.site_xpos[:, self._site_id],
        'cube_pos': data.xpos[:, self._cube_body],
        'reached_box': zero,
        'last_action': zero,
    }
    obs = self._get_obs(data, info)
    return core.State(data, obs, zero, zero, metrics, info)

  def step(self, state: core.State, action: torch.Tensor) -> core.State:
    m = self._model
    data0 = state.data
    info = dict(state.info)
    j = self._joint_qadr

    act = data0.ctrl + self._action_scale * action
    act[:, 3] = -(1.57 + data0.qpos[:, j[1]] + data0.qpos[:, j[2]])

    cube_pos0 = data0.xpos[:, self._cube_body]
    target_xy = info['target_pos'][:, :2]
    delta_x = target_xy[:, 0] - cube_pos0[:, 0]
    delta_y = target_xy[:, 1] - cube_pos0[:, 1]
    angle_to_box = torch.atan2(delta_y, delta_x + 0.00001)
    bearing = -angle_to_box + act[:, 0] + 1.5708
    act[:, 4] = bearing
    info['last_action'] = bearing

    act = torch.minimum(torch.maximum(act, self._lowers), self._uppers)
    data1 = core.step(m, data0, act, self._decimation)

    zero = torch.zeros_like(state.reward)
    one = torch.ones_like(state.reward)
    box_target_dis = torch.linalg.vector_norm(
        info['target_pos'] - data1.xpos[:, self._cube_body], dim=-1
    )
    succ_eps = 0.005
    box_target_dis = torch.where(box_target_dis < succ_eps, zero,
                                 box_target_dis)
    push_reward = 1 / (1 + 3 * box_target_dis) * self._push_w

    site_pos = data1.site_xpos[:, self._site_id]
    cube_pos = data1.xpos[:, self._cube_body]
    site_z_reward = torch.where(site_pos[:, 2] < 0.82, one, zero)

    # approach point one cube-length short of the target bearing
    delta_x = target_xy[:, 0] - cube_pos[:, 0]
    delta_y = target_xy[:, 1] - cube_pos[:, 1]
    angle_to_box = torch.atan2(delta_y, delta_x + 0.00001)
    distance = torch.sqrt(delta_x**2 + delta_y**2) + 0.04
    x_ = distance * torch.cos(angle_to_box)
    y_ = distance * torch.sin(angle_to_box)
    ncp = torch.stack([delta_x - x_ + cube_pos[:, 0],
                       delta_y - y_ + cube_pos[:, 1]], dim=-1)
    info['new_cube_pos'] = ncp

    site2cube = torch.linalg.vector_norm(site_pos[:, :2] - ncp, dim=-1)
    site2cube = torch.where(site2cube < 0.042, zero, site2cube - 0.042)
    site2cube_reward = (1 - torch.tanh(5 * site2cube)) * self._site2box_w
    site2cube_reward = torch.where(box_target_dis < 0.005,
                                   self._site2box_w * one, site2cube_reward)

    health_reward = self._healthy_w * torch.abs(
        torch.where(site_pos[:, 2] < self._endpoint_min_z, one, zero) - 1.0)
    reward = push_reward + site2cube_reward + health_reward + site_z_reward
    done = torch.where(cube_pos[:, 2] < 0.6, one, zero)

    reward = torch.clamp(reward, -1e2, 1e2)
    obs = self._get_obs(data1, info)
    metrics = dict(state.metrics)
    metrics.update(
        push_reward=push_reward,
        ctrl_cost=0.0 * reward,
        siet_to_box_reward=site2cube_reward,
    )
    info.update(site_pos=site_pos, cube_pos=cube_pos)
    return state.replace(data=data1, obs=obs, reward=reward, done=done,
                         metrics=metrics, info=info)

  def _get_obs(self, data, info: Dict[str, Any]) -> torch.Tensor:
    """23-dim observation per env."""
    cube = data.xpos[:, self._cube_body]
    site = data.site_xpos[:, self._site_id]
    return torch.cat([
        data.qpos[:, self._joint_idx],
        site,
        info['target_pos'],
        cube,
        info['new_cube_pos'],
        info['target_pos'] - cube,
        cube - site,
    ], dim=-1)
