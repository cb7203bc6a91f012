"""Rendering in the port (``utils/rendering.py``, ``envs/go2/visual.py``,
``eval_go2 --video``) against the JAX package, on the CPU.

- The render model of every registered env against the JAX env's
  (``_mjm_render`` where it has one, else ``_mjm``): nq, nbody, ngeom,
  nmesh, and the mesh vertices (count and sum, to 1e-6 relative); the
  Go2 mesh model exists where JAX's does (flat and rough terrain) and is
  None on the full-collision scene in both packages.
- ``rollout_qpos`` on the CPU against the JAX env's own unbatched
  ``env.step`` from the same handed-over reset, zero actions, 5 control
  steps, qpos within 1e-4.  JAX's unbatched step takes its adaptive
  per-env solver, the port the fixed 6 x 6 schedule of its kernels: on
  the CPU, from 10 of the 16 cube-push resets of keys 0-7 (both
  variants) the two part by 1e-3 to 0.5 within 5 steps, as ROADMAP
  section 3 records for the two solvers; the test takes key 6 of
  AirbotCubePushTrain, where they stay within 1.5e-5.
- ``render_array`` with a stub ``mujoco.Renderer`` (no GL context needed):
  the qpos written per frame, the 'track' camera by default where the
  model has one and the free camera where it has none, ``modify_scene``
  called once per frame with the frame's index.
- ``save_video``: an mp4 whose frame count ``cv2.VideoCapture`` reads back
  as T; with ``cv2`` unimportable, a GIF of T frames.
- ``eval_go2 --video`` with the stub renderer: T + 1 frames of 480 x 640
  from 'track', one command arrow on each.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_stub_renderer
from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs.core import Wrapper
from rsr_mjx_tpu_torch.envs.go2 import visual
from rsr_mjx_tpu_torch.utils import rendering
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = ('AirbotCubePush', 'AirbotCubePushTrain', 'AirbotTPush',
        'Go2JoystickFlatTerrain', 'Go2JoystickRoughTerrain', 'Go2Getup',
        'Go2Handstand', 'Go2Footstand')
MESH_TASKS = {'Go2JoystickFlatTerrain': True, 'Go2JoystickRoughTerrain': True,
              'Go2Getup': False, 'Go2Handstand': False, 'Go2Footstand': False}


@pytest.mark.parametrize('name', ENVS)
def test_render_model_matches_jax(name):
  jenv = jenvs.load(name)
  want = getattr(jenv, '_mjm_render', None) or jenv._mjm
  penv = penvs.load(name, device='cpu')
  got = rendering.render_model(penv)
  for field in ('nq', 'nbody', 'ngeom', 'nmesh', 'ncam'):
    assert getattr(got, field) == getattr(want, field), field
  assert got.mesh_vert.shape == want.mesh_vert.shape
  np.testing.assert_allclose(got.mesh_vert.sum(0), want.mesh_vert.sum(0),
                             rtol=1e-6)
  assert got.opt.timestep == pytest.approx(want.opt.timestep)
  if name in MESH_TASKS:
    vm = visual.visual_model(penv.task, penv.sim_dt)
    assert (vm is not None) == MESH_TASKS[name]
    assert (jenv._mjm_render is not None) == MESH_TASKS[name]
    if vm is not None:
      assert (vm.nq, vm.nmesh, vm.ngeom) == (19, 15, 38)


def test_rollout_qpos_matches_jax_unbatched_steps():
  name, steps = 'AirbotCubePushTrain', 5
  jenv = jenvs.load(name)
  start = jax.jit(jenv.reset)(jax.random.PRNGKey(6))
  step = jax.jit(jenv.step)
  js, want = start, [np.asarray(start.data.qpos)]
  for _ in range(steps):
    js = step(js, jnp.zeros(jenv.action_size))
    want.append(np.asarray(js.data.qpos))

  class Handover(Wrapper):
    """Resets to the JAX env's reset state."""

    def reset(self, generator, batch_size):
      t = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)[None]
      return self.env.reset_to(t(start.data.qpos), t(start.data.qvel),
                               t(start.data.ctrl))

  got = rendering.rollout_qpos(Handover(penvs.load(name, device='cpu')),
                               None, steps, seed=0, device='cpu')
  assert got.shape == (steps + 1, jenv._mjm.nq)
  np.testing.assert_allclose(got, np.stack(want), rtol=0, atol=1e-4)


def test_rollout_qpos_policy_and_draws():
  """The policy sees each state's obs and the one CPU generator; a seed
  gives the same rollout twice; ``on_step`` sees every stepped state."""
  env = penvs.load('AirbotCubePushTrain', device='cpu')
  seen, stepped = [], []

  def policy(obs, generator):
    seen.append((obs.shape, generator.device.type))
    return 0.1 * torch.ones((1, env.action_size)), {}

  q1 = rendering.rollout_qpos(env, policy, 3, seed=4, device='cpu',
                              on_step=stepped.append)
  q2 = rendering.rollout_qpos(env, policy, 3, seed=4, device='cpu')
  np.testing.assert_array_equal(q1, q2)
  assert seen[0] == ((1, env.observation_size), 'cpu') and len(seen) == 6
  assert len(stepped) == 3
  np.testing.assert_array_equal(stepped[-1].data.qpos[0].numpy(), q1[-1])
  assert not np.array_equal(
      q1, rendering.rollout_qpos(env, policy, 3, seed=5, device='cpu'))


def test_render_array_with_stub_renderer(monkeypatch):
  instances = torch_stub_renderer.install(monkeypatch)
  go2 = visual.visual_model('flat_terrain', 0.004)
  traj = np.random.default_rng(0).normal(size=(4, go2.nq)) * 0.1
  calls = []
  frames = rendering.render_array(
      go2, [traj[0], torch.from_numpy(traj[1]), traj[2], traj[3]],
      height=24, width=32, modify_scene=lambda scn, i: calls.append(i))
  assert frames.shape == (4, 24, 32, 3) and frames.dtype == np.uint8
  np.testing.assert_array_equal(frames[:, 0, 0, 0], np.arange(4))
  (r,) = instances
  np.testing.assert_allclose(np.stack(r.qpos), traj)
  assert r.cameras == ['track'] * 4 and r.closed
  assert calls == [0, 1, 2, 3]
  # no 'track' camera: the free camera
  cube = rendering.render_model(penvs.load('AirbotCubePushTrain',
                                           device='cpu'))
  rendering.render_array(cube, np.zeros((2, cube.nq)), height=8, width=8)
  assert instances[-1].cameras == [None, None]


def test_save_video_mp4_and_gif(tmp_path, monkeypatch):
  import cv2
  from PIL import Image

  frames = np.random.default_rng(0).integers(0, 255, (7, 32, 48, 3),
                                              dtype=np.uint8)
  path = rendering.save_video(frames, str(tmp_path / 'v' / 'a.mp4'), fps=10)
  assert path.endswith('a.mp4')
  cap = cv2.VideoCapture(path)
  count = 0
  while cap.read()[0]:
    count += 1
  cap.release()
  assert count == 7
  monkeypatch.setitem(sys.modules, 'cv2', None)  # not importable
  path = rendering.save_video(frames.astype(np.float32),
                              str(tmp_path / 'b.mp4'), fps=10)
  assert path.endswith('b.gif')
  with Image.open(path) as gif:
    assert gif.n_frames == 7 and gif.size == (48, 32)


def test_eval_go2_video_with_stub_renderer(tmp_path, monkeypatch, capsys):
  import cv2
  import mujoco

  from rsr_mjx_tpu_torch.train import eval_go2

  instances = torch_stub_renderer.install(monkeypatch)
  path = str(tmp_path / 'go2.mp4')
  eval_go2.main([os.path.join(ROOT, 'logs', 'go2_joystick_50M_r5',
                              'final_params.pkl'), '--device',
                 'cpu', '--episodes', '2', '--episode_length', '2',
                 '--video', path, '--video_steps', '3'])
  assert f'video: {path}' in capsys.readouterr().out
  (r,) = instances
  assert (r.height, r.width) == (480, 640)
  assert r.cameras == ['track'] * 4
  assert r.decor == [[mujoco.mjtGeom.mjGEOM_ARROW.value]] * 4
  cap = cv2.VideoCapture(path)
  count = 0
  while cap.read()[0]:
    count += 1
  assert count == 4
