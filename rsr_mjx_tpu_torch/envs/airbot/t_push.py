"""Airbot Play T-shape push environment, batched over envs.

Counterpart of ``rsr_mjx_tpu/envs/airbot/t_push.py``: a 16-dim observation
(6 arm qpos, endpoint z, target − block deltas of the base and vertical
boxes, the orientation angle ``xita``, the approach vector), a 5-dim delta
action with cube-push's j5/j6 couplings (j6 bears on the T's tail), and a
reward that mixes the base and vertical position terms (0.1515 each) with
the orientation term (0.66).  Reward, done and observation are those of the
JAX env, written over a leading env axis.

The model comes from the committed snapshot (``snapshot.py``, 32 contact
slots of 720 selected), so the env runs where ``mujoco`` is not installed.
Reset noise comes from an explicit ``torch.Generator``; ``reset_to`` starts
a batch from given initial states, which is how the tests feed both
packages the same start.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from rsr_mjx_tpu_torch.envs import core
from rsr_mjx_tpu_torch.envs.airbot import snapshot
from rsr_mjx_tpu_torch.physics import io
from rsr_mjx_tpu_torch.physics.io import name2id
from rsr_mjx_tpu_torch.physics.types import Model

_JOINT_OFFSET = (0.0, -0.57303354, 0.381795, 1.5718, -1.3787, 1.1731174)
_CTRL_BASE = (0.0, -0.57303354, 0.381795, -1.3787, 1.1731174)
_NEW_T_POS = (0.24739072, -0.00496255)
_XITA0 = 0.2876


class AirbotTPush(core.Env):
  """T-shape push manipulation task over a batch of envs."""

  def __init__(
      self,
      push_reward_weight: float = 10.0,
      siet_to_box_reward_weight: float = 3.0,
      healthy_reward: float = 1.0,
      endpoint_min_z_pos: float = 0.78,
      noise_scale: float = 1e-2,
      decimation: int = 4,
      max_contacts: int = 32,
      device='cuda',
      dtype: torch.dtype = torch.float32,
  ):
    """``dtype`` is that of the physics: float32, or float64 on the CPU as
    a reference (the CUDA kernels take float32 only)."""
    m = io.load_model_npz(snapshot.path('t_push'), device=device)
    if dtype != torch.float32:
      m = m.to(device, dtype)
    self._model = io._apply_max_contacts(m.replace(ncon_sel=0), max_contacts)
    self._push_w = push_reward_weight
    self._site2box_w = siet_to_box_reward_weight
    self._healthy_w = healthy_reward
    self._endpoint_min_z = endpoint_min_z_pos
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
    self._new_T_pos = f(_NEW_T_POS)
    self._xita0 = f(_XITA0)
    self._T_body = name2id(m, 'body', 'T_block')
    self._target_body = name2id(m, 'body', 'T_target')
    self._site_id = name2id(m, 'site', 'endpoint')
    self._T_tail = name2id(m, 'site', 'T_tail')
    self._T_target_tail = name2id(m, 'site', 'T_target_tail')
    self._base_geom = name2id(m, 'geom', 'base_block')
    self._vert_geom = name2id(m, 'geom', 'vertical_block')
    self._target_base_geom = name2id(m, 'geom', 'base_target')
    self._target_vert_geom = name2id(m, 'geom', 'vertical_target')
    jnames = ['joint1', 'joint2', 'joint3', 'joint4', 'joint5', 'joint6']
    self._joint_qadr = np.array(
        [m.jnt_qposadr[name2id(m, 'joint', j)] for j in jnames]
    )
    self._joint_idx = torch.as_tensor(self._joint_qadr, device=dev)
    self._lowers = m.actuator_ctrlrange[:, 0]
    self._uppers = m.actuator_ctrlrange[:, 1]

  # -- Env interface ---------------------------------------------------

  @property
  def model(self) -> Model:
    return self._model

  def bind_model(self, model: Model) -> None:
    """Step with ``model`` from now on: one with the same topology, whose
    leaves may be per env (domain randomisation) or carry a gradient."""
    self._model = model

  @property
  def action_size(self) -> int:
    return 5

  @property
  def observation_size(self) -> int:
    return 16

  @property
  def ctrl_dt(self) -> float:
    return 0.00025 * self._decimation

  @property
  def sim_dt(self) -> float:
    return 0.00025

  @property
  def n_substeps(self) -> int:
    return self._decimation

  def sample_init(self, generator: torch.Generator, batch_size: int):
    """Random initial (qpos, qvel, ctrl) of ``batch_size`` envs, drawn on the
    generator's device and moved to the model's."""
    m = self._model
    B, n = batch_size, self._noise
    dev = m.device

    def uniform(shape):
      u = core.rand(generator, shape)
      return -n + 2 * n * u.to(dev, m.qpos0.dtype)

    qpos = m.qpos0 + uniform((B, m.nq))
    qpos[:, self._joint_idx] += self._joint_offset
    qvel = uniform((B, m.nv))
    ctrl = self._ctrl_base + uniform((B, m.nu))
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
        'siet2cube_reward': zero,
        'health_reward': zero,
        'task_complete_reward': zero,
        'site_z_reward': zero,
    }
    info = {
        'target_base_pos': data.geom_xpos[:, self._target_base_geom],
        'target_vertical_pos': data.geom_xpos[:, self._target_vert_geom],
        'target_w': data.xquat[:, self._target_body, 0] * 10,
        'new_T_pos': self._new_T_pos.expand(B, 2).clone(),
        'site_pos': data.site_xpos[:, self._site_id],
        'T_pos': data.xpos[:, self._T_body],
        'xita': self._xita0.expand(B).clone(),
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
    # j6 bearing towards the T tail
    site = data0.site_xpos[:, self._site_id]
    tail_xy = data0.site_xpos[:, self._T_tail, :2]
    angle_to_box = torch.atan2(tail_xy[:, 1] - site[:, 1],
                               tail_xy[:, 0] - site[:, 0] + 0.00001)
    act[:, 4] = -angle_to_box + act[:, 0] + 1.5708
    act = torch.minimum(torch.maximum(act, self._lowers), self._uppers)
    data1 = core.step(m, data0, act, self._decimation)

    zero = torch.zeros_like(state.reward)
    one = torch.ones_like(state.reward)
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    base = data1.geom_xpos[:, self._base_geom]
    vert = data1.geom_xpos[:, self._vert_geom]
    dis_base = norm(info['target_base_pos'] - base)
    dis_base = torch.where(dis_base < 0.005, zero, dis_base)
    push_reward_base = 1.0 / (1 + 10.0 * dis_base)
    dis_vert = norm(info['target_vertical_pos'] - vert)
    dis_vert = torch.where(dis_vert < 0.005, zero, dis_vert)
    push_reward_vert = 1.0 / (1 + 10.0 * dis_vert)

    box_array = vert - base
    target_array = info['target_vertical_pos'] - info['target_base_pos']
    cos = (torch.sum(box_array * target_array, dim=-1)
           / (norm(box_array) * norm(target_array)))
    xita = torch.arccos(torch.clamp(cos, -1, 1))
    info['xita'] = xita
    push_w_reward = 1.0 / (1 + 6.0 * xita)
    push_reward = (0.1515 * push_reward_base + 0.1515 * push_reward_vert
                   + 0.66 * push_w_reward) * self._push_w

    site_pos = data1.site_xpos[:, self._site_id]
    T_tail_pos = data1.site_xpos[:, self._T_tail]
    site_z_reward = torch.where(site_pos[:, 2] < 0.83, one, zero)
    site_z_reward = site_z_reward + 4.0 / (
        1 + 3 * torch.abs(site_pos[:, 2] - 0.805))

    # approach point one tail-length short of the target tail
    target_xy = data1.site_xpos[:, self._T_target_tail, :2]
    delta_x = target_xy[:, 0] - T_tail_pos[:, 0]
    delta_y = target_xy[:, 1] - T_tail_pos[:, 1]
    angle_to_box = torch.atan2(delta_y, delta_x + 0.00001)
    distance = torch.sqrt(delta_x**2 + delta_y**2) + 0.025
    x_ = distance * torch.cos(angle_to_box)
    y_ = distance * torch.sin(angle_to_box)
    info['new_T_pos'] = torch.stack([delta_x - x_ + T_tail_pos[:, 0],
                                     delta_y - y_ + T_tail_pos[:, 1]], dim=-1)

    site2cube = norm(site_pos[:, :2] - info['new_T_pos'])
    site2cube = torch.where(site2cube < 0.02, zero, site2cube - 0.02)
    siet2cube_reward = (1 - torch.tanh(5 * site2cube)) * self._site2box_w
    health_reward = self._healthy_w * torch.abs(
        torch.where(site_pos[:, 2] < self._endpoint_min_z, one, zero) - 1.0)

    reward = push_reward + siet2cube_reward + health_reward + site_z_reward
    T_pos = data1.xpos[:, self._T_body]
    done = torch.where(T_pos[:, 2] < 0.6, one, zero)
    reward = torch.clamp(reward, -1e2, 1e2)
    obs = self._get_obs(data1, info)
    metrics = dict(state.metrics)
    metrics.update(
        push_reward=push_reward,
        siet2cube_reward=siet2cube_reward,
        health_reward=health_reward,
        site_z_reward=site_z_reward,
    )
    info.update(site_pos=site_pos, T_pos=T_pos)
    return state.replace(data=data1, obs=obs, reward=reward, done=done,
                         metrics=metrics, info=info)

  def _get_obs(self, data, info: Dict[str, Any]) -> torch.Tensor:
    """16-dim observation per env (T_shape_env.py:226-237)."""
    site = data.site_xpos[:, self._site_id]
    return torch.cat([
        data.qpos[:, self._joint_idx],
        site[:, 2:3],
        info['target_base_pos'] - data.geom_xpos[:, self._base_geom],
        info['target_vertical_pos'] - data.geom_xpos[:, self._vert_geom],
        info['xita'][:, None],
        info['new_T_pos'] - site[:, :2],
    ], dim=-1)
