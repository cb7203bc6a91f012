"""Deployment in the port (``rsr_mjx_tpu_torch.deploy``) against the JAX
package's, on the CPU.

- The observation builders and ``t_orientation_error`` on seeded readings
  equal to JAX's (the same numpy code), and the obs-log text equal byte
  for byte.
- Both control loops with tests/test_deploy.py's fake arm (a T arm of the
  same kind for T-push) and a seeded action policy: the command sequences,
  step counts and step-complete calls equal to the JAX loops'.
- The synthetic-tag cases of tests/test_perception.py through both
  packages give the same points (they need ``cv2``).
- ``RosRobotInterface()`` raises ImportError in both where ``rospy`` is
  not installed.
- ``PolicyInference``: the JAX one restoring the Orbax checkpoint
  ``logs/cube_ppo_15M_r4/checkpoints/16629760`` against the port's on
  ``logs/cube_ppo_15M_r4/final_params.pkl``, and both on
  ``logs/cube_sac_500k_r5/final_params.pkl`` (``algorithm='sac'``), over
  64 observations (the 51 rows of ``data_rsr_demo/real_obs.txt`` and the
  first 13 of ``obs.txt``), deterministic: returned actions within 1e-6,
  action-log rows equal to 5 decimals.  A JAX Orbax directory raises a
  ValueError naming the ``final_params.pkl`` beside it; the port's own
  checkpoint directory serves the same policy; a ``network_factory``
  whose sizes differ from the weights' raises; the stochastic path draws
  from the seeded generator.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_deploy
import test_perception
from rsr_mjx_tpu import deploy as jdeploy
from rsr_mjx_tpu.deploy import perception as jP
from rsr_mjx_tpu.deploy import ros_adapter as jros
from rsr_mjx_tpu.deploy import t_push as jt
from rsr_mjx_tpu_torch import deploy as pdeploy
from rsr_mjx_tpu_torch.deploy import perception as pP
from rsr_mjx_tpu_torch.deploy import ros_adapter as pros
from rsr_mjx_tpu_torch.deploy import t_push as pt
from torch_testing import child_env, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'data_rsr_demo')
PPO = os.path.join(ROOT, 'logs', 'cube_ppo_15M_r4')
SAC_PKL = os.path.join(ROOT, 'logs', 'cube_sac_500k_r5', 'final_params.pkl')


def _rows():
  real = np.loadtxt(os.path.join(DATA, 'real_obs.txt'), delimiter=',')
  more = np.loadtxt(os.path.join(DATA, 'obs.txt'), delimiter=',')
  return np.concatenate([real, more[:64 - len(real)]])


def test_observation_builders_and_logs_match_jax(tmp_path):
  rng = np.random.default_rng(0)
  for i in range(5):
    joints, end = rng.uniform(-1, 1, 6), rng.uniform(-0.3, 0.3, 3)
    marker, p0, p1, newp = (rng.uniform(0.2, 0.4, 2) for _ in range(4))
    for name, mod in (('jax', jdeploy), ('port', pdeploy)):
      mod.build_cube_observation(joints, end, marker,
                                 obs_log_path=str(tmp_path / f'{name}_c'))
    for name, mod in (('jax', jt), ('port', pt)):
      mod.build_t_observation(joints, end, p0, p1, newp,
                              obs_log_path=str(tmp_path / f'{name}_t'))
    np.testing.assert_array_equal(
        pdeploy.build_cube_observation(joints, end, marker),
        jdeploy.build_cube_observation(joints, end, marker))
    assert pt.t_orientation_error(p0, p1) == jt.t_orientation_error(p0, p1)
  for kind in ('c', 't'):
    port = (tmp_path / f'port_{kind}').read_bytes()
    assert port == (tmp_path / f'jax_{kind}').read_bytes()
    assert len(port.splitlines()) == 5


class SeededPolicy:
  """Seeded actions of the policy's width (the loops' policy contract)."""

  def __init__(self, obs_width, seed=0):
    self.rng, self.obs_width = np.random.default_rng(seed), obs_width

  def get_action(self, obs, deterministic=True):
    assert obs.shape == (self.obs_width,) and deterministic
    return self.rng.uniform(-0.02, 0.02, 5)


class FakeTArm(test_deploy.FakeRobot, pt.TRobotInterface):
  """test_deploy's fake arm with a T that turns 30 % of the way to the
  target's bearing per command."""

  def __init__(self):
    super().__init__([0.0, 0.0], [0.0, 0.0])
    self.angle, self.p1 = 0.6, np.array([0.30, 0.10])
    d = (pt.T_TARGET_VERT - pt.T_TARGET_BASE)[:2]
    self.length, self.bearing = np.linalg.norm(d), np.arctan2(d[1], d[0])

  def get_t_points(self):
    a = self.bearing + self.angle
    p0 = self.p1 + self.length * np.array([np.cos(a), np.sin(a)])
    return p0, self.p1.copy(), p0 + 0.025 * (p0 - self.p1) / self.length

  def send_joint_position_cmd(self, joint_positions):
    super().send_joint_position_cmd(joint_positions)
    self.angle *= 0.7


@pytest.mark.parametrize('task', ['cube', 't'])
def test_control_loops_match_jax(task):
  out = {}
  for name, loop in (
      ('jax', jdeploy.run_cube_push_control_loop if task == 'cube'
       else jt.run_t_push_control_loop),
      ('port', pdeploy.run_cube_push_control_loop if task == 'cube'
       else pt.run_t_push_control_loop)):
    if task == 'cube':
      robot = test_deploy.FakeRobot([0.30, 0.0], (0.455355, 0.082943, 0.82))
    else:
      robot = FakeTArm()
    steps = loop(robot, SeededPolicy(23 if task == 'cube' else 16),
                 max_steps=30, joint_timeout=0.1, obs_log_path=None,
                 logger=lambda *_: None)
    out[name] = (steps, np.array(robot.commands), robot.steps_completed)
  (js, jc, jdone), (ps, pc, pdone) = out['jax'], out['port']
  assert ps == js == 30 and pdone == jdone
  assert 0 < len(pc) < 30
  np.testing.assert_array_equal(pc, jc)


def _perception_case(P, case):
  """One synthetic-tag case of tests/test_perception.py through module
  ``P``; returns its output as a list of arrays."""
  T = test_perception
  cfg = T._cfg()
  if case == 'camera_pose':
    frame = T._frame_with_tags(cfg, {3: np.array([0.05, -0.03, 0.7])})
    return [P.solve_tag_camera_pos(P.TagDetector().detect(frame)[3], cfg)]
  if case == 'localizer':
    frame = T._frame_with_tags(cfg, {0: np.array([-0.02, 0.03, 0.65])})
    loc = P.MarkerLocalizer(cfg)
    return [loc.process(frame), loc.get_marker_position()]
  if case == 'no_detection':
    loc = P.MarkerLocalizer(cfg)
    return [loc.process(np.full((720, 1280, 3), 255, np.uint8)),
            loc.get_marker_position()]
  if case == 't_two_tags':
    frame = T._frame_with_tags(cfg, {0: np.array([0.06, 0.0, 0.7]),
                                     1: np.array([-0.06, 0.02, 0.7])})
    return list(P.TMarkerLocalizer(cfg).process(frame))
  if case == 't_one_tag':
    frame = T._frame_with_tags(cfg, {0: np.array([0.0, 0.0, 0.7])})
    return list(P.TMarkerLocalizer(cfg).process(frame))
  frame = T._frame_with_tags(cfg, {0: np.array([0.0, 0.0, 0.738])})
  return [P.extrinsic_self_calibration(frame, cfg)]


@pytest.mark.parametrize('case', ['camera_pose', 'localizer', 'no_detection',
                                  't_two_tags', 't_one_tag', 'calibration'])
def test_perception_matches_jax(case):
  want, got = _perception_case(jP, case), _perception_case(pP, case)
  assert len(got) == len(want)
  for g, w in zip(got, want):
    if w is None:
      assert g is None
    else:
      np.testing.assert_array_equal(g, w)
  assert any(w is not None for w in want) == (case != 'no_detection')


def test_ros_adapter_needs_rospy():
  for mod in (jros, pros):
    assert not mod._HAS_ROS
    with pytest.raises(ImportError, match='rospy'):
      mod.RosRobotInterface()


# -- PolicyInference ------------------------------------------------------


# The JAX PolicyInference restores through ``ppo.train``, which asks that
# the envs divide over the devices: it runs in a process of its own,
# without the 8 virtual devices of tests/conftest.py, once for the module.
_JAX_SERVER = """
import sys
import numpy as np
from rsr_mjx_tpu import deploy, envs
obs, out = np.load(sys.argv[1]), sys.argv[2]
env = envs.load('AirbotCubePushTrain')
for algo, ckpt in zip(('ppo', 'sac'), sys.argv[3:]):
  pi = deploy.PolicyInference(ckpt, env, algorithm=algo,
                              action_log_path=f'{out}/{algo}_log.txt')
  np.save(f'{out}/{algo}.npy', np.stack([pi.get_action(o) for o in obs]))
"""


@pytest.fixture(scope='module')
def jax_actions(tmp_path_factory):
  """{algorithm: (actions, action log)} of the JAX PolicyInference on the
  rows: PPO restoring the Orbax checkpoint, SAC its pickle."""
  tmp = tmp_path_factory.mktemp('jax')
  np.save(tmp / 'obs.npy', _rows())
  env = child_env(JAX_PLATFORMS='cpu', PYTHONPATH=ROOT)
  env.pop('XLA_FLAGS', None)
  done = subprocess.run(
      [sys.executable, '-c', _JAX_SERVER, str(tmp / 'obs.npy'), str(tmp),
       os.path.join(PPO, 'checkpoints', '16629760'), SAC_PKL], env=env,
      cwd=ROOT, capture_output=True, text=True, timeout=600)
  assert done.returncode == 0, done.stderr[-2000:]
  return {algo: (np.load(tmp / f'{algo}.npy'),
                 np.loadtxt(tmp / f'{algo}_log.txt', delimiter=','))
          for algo in ('ppo', 'sac')}


def _port_actions(path, tmp_path, **kw):
  from rsr_mjx_tpu_torch import envs as penvs

  log = tmp_path / 'port_actions.txt'
  pi = pdeploy.PolicyInference(
      path, penvs.load('AirbotCubePushTrain', device='cpu'),
      action_log_path=str(log), device='cpu', **kw)
  acts = np.stack([pi.get_action(o) for o in _rows()])
  return acts, np.loadtxt(log, delimiter=',')


@pytest.mark.parametrize('algo', ['ppo', 'sac'])
def test_policy_inference_matches_jax(jax_actions, algo, tmp_path):
  """PPO: the port on final_params.pkl against JAX on its Orbax
  checkpoint; SAC: both on the pickle."""
  ja, jlog = jax_actions[algo]
  pa, plog = _port_actions(
      os.path.join(PPO, 'final_params.pkl') if algo == 'ppo' else SAC_PKL,
      tmp_path, algorithm=algo)
  assert pa.shape == ja.shape == (64, 5) and pa.dtype == np.float32
  np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-6)
  assert plog.shape == jlog.shape == (64, 5)
  np.testing.assert_array_almost_equal(plog, jlog, decimal=5)
  np.testing.assert_allclose(pa, plog * 0.02, atol=0.02 * 5e-7 + 1e-9)


def test_policy_inference_sources(tmp_path):
  """The pickle, the directory holding it and a port checkpoint directory
  serve one policy; a JAX Orbax directory raises with the pickle's path;
  a factory of other sizes raises."""
  from rsr_mjx_tpu_torch import envs as penvs
  from rsr_mjx_tpu_torch.train import checkpoint, networks, sac

  env = penvs.load('AirbotCubePushTrain', device='cpu')
  serve = lambda path, **kw: pdeploy.PolicyInference(
      path, env, action_log_path=None, device='cpu', **kw).get_action(
          _rows()[0])
  want = serve(os.path.join(PPO, 'final_params.pkl'))
  np.testing.assert_array_equal(serve(PPO), want)
  normalizer, params = sac.load_params(os.path.join(PPO, 'final_params.pkl'))
  checkpoint.save(str(tmp_path / 'checkpoints' / '40'),
                  networks.networks_from_numpy(normalizer, params, 'cpu'))
  np.testing.assert_array_equal(serve(str(tmp_path / 'checkpoints')), want)
  for orbax in (os.path.join(PPO, 'checkpoints', '16629760'),
                os.path.join(PPO, 'checkpoints')):
    with pytest.raises(ValueError, match='final_params.pkl') as err:
      serve(orbax)
    assert os.path.join(PPO, 'final_params.pkl') in str(err.value)
  ok = functools.partial(networks.make_ppo_networks,
                         policy_hidden_layer_sizes=(32,) * 4)
  np.testing.assert_array_equal(serve(PPO, network_factory=ok), want)
  with pytest.raises(ValueError, match='network_factory'):
    serve(PPO, network_factory=functools.partial(
        networks.make_ppo_networks, policy_hidden_layer_sizes=(64, 64)))
  with pytest.raises(FileNotFoundError):
    serve(str(tmp_path / 'nothing'))


def test_policy_inference_stochastic_draws_from_the_seed():
  from rsr_mjx_tpu_torch import envs as penvs

  env = penvs.load('AirbotCubePushTrain', device='cpu')
  obs = _rows()[:4]
  draw = lambda seed, algo, path: np.stack([
      p.get_action(o, deterministic=False) for p in [pdeploy.PolicyInference(
          path, env, algorithm=algo, action_log_path=None, seed=seed,
          device='cpu')] for o in obs])
  for algo, path in (('ppo', PPO), ('sac', SAC_PKL)):
    a = draw(7, algo, path)
    np.testing.assert_array_equal(a, draw(7, algo, path))
    assert not np.array_equal(a, draw(8, algo, path))
    assert np.all(np.abs(a) <= 0.02)


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_policy_inference_raises_without_a_card():
  from rsr_mjx_tpu_torch import envs as penvs

  with pytest.raises(RuntimeError, match='no CUDA device'):
    pdeploy.PolicyInference(os.path.join(PPO, 'final_params.pkl'),
                            penvs.load('AirbotCubePushTrain', device='cpu'))
