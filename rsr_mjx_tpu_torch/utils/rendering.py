"""Offscreen rollout rendering through the C MuJoCo renderer.

Counterpart of ``rsr_mjx_tpu/utils/rendering.py``.  The physics runs on
the card, so rendering is a host post-process in two parts:

- ``rollout_qpos``: a deterministic rollout of one env (B 1) on the
  env's device, under a policy or zero actions; returns qpos per control
  step as numpy.  It needs no ``mujoco``.
- ``render_array``: each qpos written into a ``mujoco.MjData`` of the
  render model, ``mj_forward``, rasterised (EGL by default: the package's
  ``__init__`` sets ``MUJOCO_GL``).  ``render_model`` compiles that model
  from the port's scene builders (the envs load npz snapshots and hold no
  ``mujoco.MjModel``); Go2 gets the mesh model of ``envs/go2/visual.py``
  where the graft takes.

``render_env_rollout`` chains the three; ``save_video`` writes mp4
(OpenCV, mp4v) or, where that writer cannot open, an animated GIF (PIL).
``mujoco``, ``cv2`` and ``PIL`` are imported by the functions that use
them.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


def _qpos_of(item: Any) -> np.ndarray:
  """Accept a State, Data, a tensor or an array of one env's qpos."""
  if hasattr(item, 'data'):  # envs.core.State
    item = item.data
  if hasattr(item, 'qpos'):  # physics Data
    item = item.qpos
  if isinstance(item, torch.Tensor):
    item = item.detach().cpu().numpy()
  return np.asarray(item).reshape(-1)


def render_model(env):
  """A ``mujoco.MjModel`` of ``env``'s scene for the renderer (same qpos
  layout as the env): the Go2 model of ``visual.render_model``, the Airbot
  scene of the env's variant."""
  import mujoco

  base = env.unwrapped
  from rsr_mjx_tpu_torch.envs.airbot import snapshot as airbot_snapshot
  from rsr_mjx_tpu_torch.envs.airbot.cube_push import AirbotCubePush
  from rsr_mjx_tpu_torch.envs.airbot.t_push import AirbotTPush
  from rsr_mjx_tpu_torch.envs.go2 import visual
  from rsr_mjx_tpu_torch.envs.go2.base import Go2Env

  if isinstance(base, Go2Env):
    return visual.render_model(base.task, base.sim_dt, *base.gains)
  if isinstance(base, AirbotCubePush):
    return mujoco.MjModel.from_xml_string(airbot_snapshot.xml(base.variant))
  if isinstance(base, AirbotTPush):
    return mujoco.MjModel.from_xml_string(airbot_snapshot.xml('t_push'))
  raise TypeError(f'no render model for {type(base).__name__}')


def _default_camera(mjm) -> Optional[str]:
  """'track' where the model has that camera (the reference's rollout
  videos track the robot), else None: the free camera."""
  import mujoco

  cam = mujoco.mj_name2id(mjm, mujoco.mjtObj.mjOBJ_CAMERA, 'track')
  return 'track' if cam >= 0 else None


def render_array(
    mjm,
    trajectory: Sequence[Any],
    height: int = 240,
    width: int = 320,
    camera: Optional[str] = None,
    scene_option=None,
    modify_scene: Optional[Callable] = None,
) -> np.ndarray:
  """Render a qpos trajectory to (T, H, W, 3) uint8 frames.

  Per frame: write qpos into MjData, ``mj_forward`` for the derived
  quantities, rasterise.  ``camera`` None takes 'track' where ``mjm`` has
  it.  ``modify_scene(scene, frame_index)``, if given, may add decoration
  geoms per frame (``utils.gait.draw_joystick_command``).
  """
  import mujoco

  if camera is None:
    camera = _default_camera(mjm)
  d = mujoco.MjData(mjm)
  renderer = mujoco.Renderer(mjm, height=height, width=width)
  frames = []
  try:
    for i, item in enumerate(trajectory):
      d.qpos[:] = _qpos_of(item)
      mujoco.mj_forward(mjm, d)
      if camera is not None:
        renderer.update_scene(d, camera=camera, scene_option=scene_option)
      else:
        renderer.update_scene(d, scene_option=scene_option)
      if modify_scene is not None:
        modify_scene(renderer.scene, i)
      frames.append(renderer.render().copy())
  finally:
    renderer.close()
  return np.stack(frames)


@torch.no_grad()
def rollout_qpos(env, policy: Optional[Callable] = None, n_steps: int = 200,
                 seed: int = 0, device='cuda',
                 on_step: Optional[Callable] = None) -> np.ndarray:
  """(n_steps + 1, nq) qpos of a deterministic rollout of one env.

  ``env`` is an env of ``device`` (``envs.load``, or a wrapper such as
  ``SelectObservationWrapper``); it is stepped as the JAX function steps
  its env, in a batch of one, without an episode limit or auto-reset.
  The reset, the env's later draws and the policy's draw from one
  ``torch.Generator`` on the CPU seeded with ``seed``, whatever the
  device (the envs move their draws to the model's device): a seed gives
  the same draws on the card and on the CPU, so the two rollouts can be
  held to each other; at B 1 that is a few numbers a step.
  ``policy(obs, generator) -> (action, extras)`` (the
  trainers' ``make_policy(params, deterministic=True)``), or None for zero
  actions.  ``on_step(state)``, if given, sees each state after a step
  (``eval_go2`` records the command and the heading)."""
  from rsr_mjx_tpu_torch.envs import wrappers

  dev = torch.device(device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device: pass device="cpu" for a CPU run')
  generator = torch.Generator().manual_seed(seed)
  batched = wrappers.BatchWrapper(env, 1)
  state = batched.reset(generator)
  qpos = [state.data.qpos[0]]
  for _ in range(n_steps):
    if policy is None:
      action = torch.zeros((1, env.action_size), device=dev)
    else:
      action, _ = policy(state.obs, generator)
    state = batched.step(state, action)
    qpos.append(state.data.qpos[0])
    if on_step is not None:
      on_step(state)
  return torch.stack(qpos).cpu().numpy()


def render_env_rollout(
    env,
    policy: Optional[Callable] = None,
    n_steps: int = 200,
    seed: int = 0,
    height: int = 240,
    width: int = 320,
    camera: Optional[str] = None,
    device='cuda',
) -> np.ndarray:
  """``rollout_qpos`` rendered by ``render_array`` with ``render_model``:
  (n_steps + 1, H, W, 3) uint8 frames."""
  qpos = rollout_qpos(env, policy, n_steps, seed, device)
  return render_array(render_model(env), qpos, height=height, width=width,
                      camera=camera)


def save_video(frames: np.ndarray, path: str, fps: float = 50.0) -> str:
  """Write (T, H, W, 3) uint8 frames to mp4 (OpenCV); GIF fallback.

  Returns the path actually written (extension may change on fallback)."""
  frames = np.asarray(frames)
  if frames.dtype != np.uint8:
    frames = np.clip(frames, 0, 255).astype(np.uint8)
  t, h, w = frames.shape[:3]
  os.makedirs(os.path.dirname(os.path.abspath(path)) or '.', exist_ok=True)
  try:
    import cv2

    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*'mp4v'), fps, (w, h)
    )
    if writer.isOpened():
      for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))  # RGB → BGR
      writer.release()
      return path
  except ImportError:
    pass
  # fallback: animated GIF via PIL
  from PIL import Image

  gif_path = os.path.splitext(path)[0] + '.gif'
  imgs = [Image.fromarray(f) for f in frames]
  imgs[0].save(
      gif_path,
      save_all=True,
      append_images=imgs[1:],
      duration=int(1000 / fps),
      loop=0,
  )
  return gif_path
