"""The port's utilities (``rsr_mjx_tpu_torch.utils``) against the JAX
package's, and the train CLI's logging sinks and ``--render`` guard.

- ``reward.tolerance``: the eight sigmoids over seeded inputs at several
  bounds, margins and values at the margin, against JAX's, to 1e-6
  relative and 4 float32 ulps of 1 absolute (both compute in float32, in
  [0, 1]; tanh_squared's 1 − tanh² cancels, so one ulp of tanh between
  the two libraries shows as up to 2 ulps of 1); the same ``ValueError``
  messages.
- ``gait.get_rz`` against JAX's to 1e-6, ``GAIT_PHASES`` equal.
- ``gait.draw_joystick_command``: the geom written into a ``MjvScene``
  (no GL needed) equal to JAX's: category, type, size, pos, mat, rgba.
- ``train/cli.py`` on a tiny CPU run: ``--use_tb`` writes an event file
  under ``logdir/tb``, ``--use_wandb`` warns (wandb made unimportable)
  and trains on, ``progress.png`` is drawn with two evaluations,
  ``--render`` writes ``rollout.mp4`` (through a stub ``mujoco.Renderer``:
  no GL context needed), and ``--render`` without ``mujoco`` fails before
  the first training step.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_stub_renderer
from rsr_mjx_tpu.utils import gait as jgait
from rsr_mjx_tpu.utils import reward as jreward
from rsr_mjx_tpu_torch.utils import gait as pgait
from rsr_mjx_tpu_torch.utils import reward as preward
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ATOL = 4 * np.finfo(np.float32).eps
SIGMOIDS = ('gaussian', 'hyperbolic', 'long_tail', 'reciprocal', 'cosine',
            'linear', 'quadratic', 'tanh_squared')


@pytest.mark.parametrize('sigmoid', SIGMOIDS)
def test_tolerance_matches_jax(sigmoid):
  x = np.random.default_rng(0).uniform(-3, 3, size=257).astype(np.float32)
  x[:3] = (0.0, 0.5, -0.25)  # on the bounds
  for bounds, margin, value in (((0.0, 0.5), 0.7, 0.3),
                                ((-0.25, 0.25), 2.0, 0.1),
                                ((0.0, 0.0), 0.3, 0.05),
                                ((-1.0, 1.5), 0.0, 0.1)):
    want = np.asarray(jreward.tolerance(jnp.asarray(x), bounds, margin,
                                        sigmoid, value))
    got = preward.tolerance(torch.from_numpy(x), bounds, margin, sigmoid,
                            value)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=ATOL)
  # a number is taken as float32, as JAX takes a weak-typed scalar
  np.testing.assert_allclose(
      float(preward.tolerance(1.3, (0.0, 1.0), 0.5, sigmoid, 0.2)),
      float(jreward.tolerance(1.3, (0.0, 1.0), 0.5, sigmoid, 0.2)),
      rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize('args', [
    dict(bounds=(1.0, 0.0)),
    dict(margin=-0.1),
    dict(margin=1.0, sigmoid='gaussian', value_at_margin=0.0),
    dict(margin=1.0, sigmoid='tanh_squared', value_at_margin=1.0),
    dict(margin=1.0, sigmoid='linear', value_at_margin=1.0),
    dict(margin=1.0, sigmoid='cosine', value_at_margin=-0.1),
    dict(margin=1.0, sigmoid='triangle'),
])
def test_tolerance_raises_as_jax(args):
  with pytest.raises(ValueError) as jerr:
    jreward.tolerance(jnp.asarray([2.0]), **args)
  with pytest.raises(ValueError) as perr:
    preward.tolerance(torch.tensor([2.0]), **args)
  assert str(perr.value) == str(jerr.value)


def test_get_rz_and_gait_phases_match_jax():
  phi = np.random.default_rng(1).uniform(-np.pi, np.pi,
                                         size=101).astype(np.float32)
  for height in (0.08, 0.12):
    np.testing.assert_allclose(
        pgait.get_rz(torch.from_numpy(phi), height).numpy(),
        np.asarray(jgait.get_rz(jnp.asarray(phi), height)), rtol=1e-6,
        atol=1e-7)
  assert abs(float(pgait.get_rz(-np.pi))) < 1e-6
  assert pgait.GAIT_PHASES.keys() == jgait.GAIT_PHASES.keys()
  for k, v in jgait.GAIT_PHASES.items():
    np.testing.assert_array_equal(pgait.GAIT_PHASES[k], v)


def test_draw_joystick_command_matches_jax():
  import mujoco

  mjm = mujoco.MjModel.from_xml_string(
      '<mujoco><worldbody><geom type="sphere" size="0.1"/></worldbody>'
      '</mujoco>')
  rng = np.random.default_rng(2)
  scenes = [mujoco.MjvScene(mjm, maxgeom=8) for _ in range(2)]
  for _ in range(3):
    cmd, xyz = rng.uniform(-1, 1, 3), rng.uniform(-1, 1, 3)
    theta, scl = rng.uniform(-np.pi, np.pi), rng.uniform(0.3, 1.5)
    for mod, scn in zip((jgait, pgait), scenes):
      mod.draw_joystick_command(scn, cmd, xyz, theta, scl=scl)
  assert scenes[0].ngeom == scenes[1].ngeom == 3
  for i in range(3):
    j, p = scenes[0].geoms[i], scenes[1].geoms[i]
    assert p.category == j.category == mujoco.mjtCatBit.mjCAT_DECOR
    assert p.type == j.type == mujoco.mjtGeom.mjGEOM_ARROW.value
    for field in ('size', 'pos', 'mat', 'rgba'):
      np.testing.assert_array_equal(getattr(p, field), getattr(j, field))


# -- train/cli.py: the logging sinks, progress.png, the --render guard -------

TINY = ['--device', 'cpu', '--num_timesteps', '16', '--num_envs', '4',
        '--batch_size', '2', '--num_minibatches', '2', '--unroll_length', '2',
        '--num_updates_per_batch', '1', '--episode_length', '3',
        '--num_eval_envs', '4']


def test_cli_tb_wandb_render_and_progress_png(tmp_path, monkeypatch):
  import cv2

  from rsr_mjx_tpu_torch.train import cli

  monkeypatch.setitem(sys.modules, 'wandb', None)  # not importable
  renderers = torch_stub_renderer.install(monkeypatch)  # needs no GL
  logdir = tmp_path / 'run'
  with pytest.warns(UserWarning, match='wandb not installed'):
    _, _, metrics = cli.main(TINY + ['--num_evals', '2', '--use_tb',
                                     '--use_wandb', '--render',
                                     '--render_steps', '2', '--logdir',
                                     str(logdir)])
  assert np.isfinite(metrics['eval/episode_reward'])
  (r,) = renderers  # the rollout behind --render: 3 frames, free camera
  assert len(r.qpos) == 3 and r.cameras == [None] * 3
  cap = cv2.VideoCapture(str(logdir / 'rollout.mp4'))
  assert cap.isOpened() and cap.get(cv2.CAP_PROP_FRAME_COUNT) == 3
  (event_file,) = os.listdir(logdir / 'tb')
  assert event_file.startswith('events.out.tfevents')
  tags = _scalar_tags((logdir / 'tb' / event_file).read_bytes())
  assert tags.count('eval/episode_reward') == 2
  assert (logdir / 'progress.png').stat().st_size > 0
  assert (logdir / 'final_params.pkl').exists()


def _scalar_tags(data: bytes):
  """The scalar tags of a TensorBoard event file, in order (records: an
  8-byte length, its 4-byte CRC, the Event, its 4-byte CRC)."""
  import struct

  from tensorboardX.proto import event_pb2

  tags, i = [], 0
  while i < len(data):
    (n,) = struct.unpack('<Q', data[i:i + 8])
    event = event_pb2.Event.FromString(data[i + 12:i + 12 + n])
    tags += [v.tag for v in event.summary.value]
    i += 12 + n + 4
  return tags


def test_cli_progress_png_needs_two_evaluations(tmp_path):
  from rsr_mjx_tpu_torch.train import cli

  history = [{'step': 0, 'eval/episode_reward': 1.0}]
  assert not cli.plot_progress(history, str(tmp_path / 'p.png'), 't')
  history.append({'step': 8, 'eval/episode_reward': 2.0,
                  'eval/episode_reward_std': 0.5})
  assert cli.plot_progress(history, str(tmp_path / 'p.png'), 't')
  assert (tmp_path / 'p.png').stat().st_size > 0


def test_cli_render_without_mujoco_fails_before_training(tmp_path,
                                                         monkeypatch):
  from rsr_mjx_tpu_torch.train import cli, ppo

  monkeypatch.setitem(sys.modules, 'mujoco', None)
  trained = []
  monkeypatch.setattr(ppo, 'train', lambda **kw: trained.append(kw))
  with pytest.raises(ImportError):
    cli.main(TINY + ['--num_evals', '1', '--render', '--logdir',
                     str(tmp_path / 'r')])
  assert not trained
  assert not (tmp_path / 'r').exists()
