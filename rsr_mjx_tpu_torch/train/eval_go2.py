"""Deterministic task-level evaluation of a trained Go2 policy.

Counterpart of ``scripts/eval_go2.py``.  On the joystick tasks it
reports what the reward optimises, the command-tracking error over alive
steps:
  - lin_err = ‖cmd_xy − local_linvel_xy‖ (m/s),
  - ang_err = |cmd_yaw − gyro_z| (rad/s);
on getup, handstand and footstand the torso's uprightness −g_z/|g| from
the gravity sensor (1 when upright) over alive steps, and, where the env
has the criterion (getup: ``_is_upright``, gravity within 0.01 of straight
down, squared), the share of episodes upright at their last alive step.
Both with the episode reward and length.  The flags and defaults are the
JAX script's, plus ``--device``; the parameters are a PPO
``final_params.pkl`` of either package.  ``--video PATH`` then rolls one
env out for ``--video_steps`` control steps on the device (seed + 1),
recording qpos and, on the joystick, the command and the heading at each
step, and renders it at 480 × 640 from the ``track`` camera with the
command arrow (``utils.gait.draw_joystick_command``); the rendering needs
``mujoco`` and a GL backend.

    python -m rsr_mjx_tpu_torch.train.eval_go2 \\
        logs/go2_joystick_50M_r5/final_params.pkl \\
        [--env Go2JoystickFlatTerrain] [--device cuda] [--video go2.mp4]

The pieces: ``rollout`` (the episodes, on the device), ``summarize`` (the
JAX script's numpy post-processing), ``print_summary`` (its lines),
``video_rollout`` (the recorded rollout) and ``render_video``.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from rsr_mjx_tpu_torch.train import eval_policy


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('params_path')
  p.add_argument('--env', default='Go2JoystickFlatTerrain')
  p.add_argument('--episodes', type=int, default=64)
  p.add_argument('--episode_length', type=int, default=500)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--device', default='cuda',
                 help="device of the envs and the policy ('cpu' for a run "
                      "with the kernels' plain versions)")
  p.add_argument('--video', default=None, help='mp4 output path')
  p.add_argument('--video_steps', type=int, default=300)
  return p.parse_args(argv)


@torch.no_grad()
def rollout(env, policy: Callable, state, episode_length: int,
            joystick: bool) -> Tuple[np.ndarray, ...]:
  """``episode_length`` control steps of ``policy`` from ``state`` in the
  wrapped Go2 env; returns (rewards, dones, lin_err, ang_err, upright),
  each (T, B) numpy.  Joystick: lin_err and ang_err are the tracking
  errors; else lin_err is −g_z/|g|, ang_err 0.  ``upright`` is the env's
  ``_is_upright`` (0 where it has none)."""
  base = env.unwrapped
  criterion = getattr(base, '_is_upright', None)
  out = []
  for _ in range(episode_length):
    state = env.step(state, policy(state.obs))
    data = state.data
    zero = torch.zeros_like(state.reward)
    if joystick:
      cmd = state.info['command']
      linvel, gyro = base.get_local_linvel(data), base.get_gyro(data)
      lin_err = torch.linalg.vector_norm(cmd[:, :2] - linvel[:, :2], dim=-1)
      ang_err = torch.abs(cmd[:, 2] - gyro[:, 2])
      upright = zero
    else:
      grav = base.get_gravity(data)
      lin_err = -grav[:, 2] / (torch.linalg.vector_norm(grav, dim=-1) + 1e-9)
      ang_err = zero
      upright = zero if criterion is None else criterion(grav).to(zero.dtype)
    out.append((state.reward, state.done, lin_err, ang_err, upright))
  return tuple(torch.stack(x).cpu().numpy() for x in zip(*out))


def summarize(rews: np.ndarray, dones: np.ndarray, lin_err: np.ndarray,
              ang_err: np.ndarray, episode_length: int,
              upright: np.ndarray = None) -> Dict[str, np.ndarray]:
  """The alive mask (steps up to and including the first done), each
  episode's reward and length, the mean errors over alive steps, as
  ``scripts/eval_go2.py``; with ``upright``, the share of episodes upright
  at their last alive step."""
  first_done = np.argmax(dones > 0, axis=0)
  first_done[~(dones > 0).any(axis=0)] = episode_length - 1
  T = np.arange(episode_length)[:, None]
  alive = T <= first_done[None, :]
  out = dict(
      ep_rew=np.where(alive, rews, 0.0).sum(axis=0),
      ep_len=first_done + 1,
      m_lin=np.where(alive, lin_err, 0.0).sum() / alive.sum(),
      m_ang=np.where(alive, ang_err, 0.0).sum() / alive.sum(),
      finite=np.isfinite(rews).all() and bool(alive.any()))
  if upright is not None:
    out['upright_end'] = upright[first_done, np.arange(dones.shape[1])].mean()
  return out


def print_summary(env_name: str, episode_length: int, joystick: bool,
                  s) -> None:
  """The JAX script's lines, and the upright share where there is one."""
  ep_rew = s['ep_rew']
  print(f'{env_name} deterministic eval over {len(ep_rew)} episodes '
        f'({episode_length} steps):')
  print(f'  episode reward:  mean {ep_rew.mean():.2f}  '
        f'median {np.median(ep_rew):.2f}')
  print(f'  episode length:  mean {s["ep_len"].mean():.0f} / '
        f'{episode_length}')
  if joystick:
    print(f'  lin tracking err: {s["m_lin"]:.3f} m/s   '
          f'(cmd range ±1.5/±0.8 m/s)')
    print(f'  ang tracking err: {s["m_ang"]:.3f} rad/s (cmd range ±1.2 '
          'rad/s)')
  else:
    print(f'  mean uprightness (-g_z, 1=upright): {s["m_lin"]:.3f}')
    if 'upright_end' in s:
      print(f'  upright at the episode end: {s["upright_end"]:.5f}')
  print(f'  all finite: {s["finite"]}')


def heading(qpos: np.ndarray) -> float:
  """The yaw of the free joint's quaternion (w, x, y, z) in ``qpos``."""
  q = qpos[3:7]
  return float(np.arctan2(2 * (q[0] * q[3] + q[1] * q[2]),
                          1 - 2 * (q[2] ** 2 + q[3] ** 2)))


def video_rollout(env0, policy: Callable, steps: int, seed: int, device,
                  joystick: bool):
  """One env of ``policy`` for ``steps`` control steps from the reset of
  ``seed`` (``rendering.rollout_qpos``): (qpos (steps + 1, nq), commands
  (steps, 3), headings (steps,)), the last two recorded after each step
  on the joystick, else empty."""
  from rsr_mjx_tpu_torch.utils import rendering

  cmds, yaws = [], []

  def record(state):
    if joystick:
      cmds.append(state.info['command'][0].cpu().numpy())
      yaws.append(heading(state.data.qpos[0].cpu().numpy()))

  qpos = rendering.rollout_qpos(env0, lambda obs, g: (policy(obs), {}),
                                steps, seed, device, on_step=record)
  return qpos, np.array(cmds).reshape(-1, 3), np.array(yaws)


def render_video(env0, qpos: np.ndarray, cmds: np.ndarray, yaws: np.ndarray,
                 path: str) -> str:
  """Render the recorded rollout at 480 × 640 from the ``track`` camera,
  with the command arrow where commands were recorded, to ``path``; the
  path written."""
  from rsr_mjx_tpu_torch.utils import gait, rendering

  modify = None
  if len(cmds):
    def modify(scn, i):
      j = min(max(i - 1, 0), len(cmds) - 1)
      xyz = qpos[i][:3] + np.array([0.0, 0.0, 0.2])
      gait.draw_joystick_command(scn, cmds[j], xyz, yaws[j],
                                 scl=abs(cmds[j][0]) + 0.3)

  frames = rendering.render_array(rendering.render_model(env0), qpos,
                                  height=480, width=640, camera='track',
                                  modify_scene=modify)
  return rendering.save_video(frames, path, fps=1.0 / env0.dt)


def main(argv=None) -> Dict[str, np.ndarray]:
  """Evaluate as the flags say; returns the summary."""
  args = parse_args(argv)
  if args.video:
    # fail now, not after the evaluation: the renderer needs mujoco
    import mujoco  # noqa: F401
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers

  gen = torch.Generator(device=args.device).manual_seed(args.seed)
  env0 = envs.load(args.env, device=args.device)
  policy = eval_policy.load_policy(args.params_path, args.env,
                                   device=args.device, generator=gen)
  joystick = 'Joystick' in args.env
  env = wrappers.wrap_for_training(env0, episode_length=args.episode_length,
                                   num_envs=args.episodes)
  rews, dones, lin_err, ang_err, upright = rollout(
      env, policy, env.reset(gen), args.episode_length, joystick)
  has_criterion = hasattr(env0, '_is_upright') and not joystick
  summary = summarize(rews, dones, lin_err, ang_err, args.episode_length,
                      upright if has_criterion else None)
  print_summary(args.env, args.episode_length, joystick, summary)
  if args.video:
    qpos, cmds, yaws = video_rollout(env0, policy, args.video_steps,
                                     args.seed + 1, args.device, joystick)
    print(f'  video: {render_video(env0, qpos, cmds, yaws, args.video)}')
  return summary


if __name__ == '__main__':
  main()
