"""The port's evaluation CLIs (``train/eval_policy.py``, ``train/eval_go2.py``)
against the JAX scripts (``scripts/eval_policy.py``, ``scripts/eval_go2.py``).

1. Each CLI's ``rollout`` from the JAX package's reset of 4 envs, with the
   deterministic policy of the same ``final_params.pkl`` loaded by the
   CLI's ``load_policy``, against a rollout built from the JAX package's
   own functions (``ppo._make_policy_factory``, the wrapped ``env.step``,
   the Pallas kernels in interpret mode) and the JAX scripts' per-step
   metrics, for 3 control steps: cube-push (the cube-to-target distance),
   the Go2 joystick (the tracking errors; observation noise off and no
   command change within the steps, as tests/test_torch_go2_slice.py) and
   getup (uprightness and the upright criterion; from the home branch,
   noise off, as tests/test_torch_go2_tasks_slice.py).  Tolerance: the
   repo's post-solve 1e-2 of each quantity's scale
   (tests/test_torch_go2_tasks_slice.py:161); dones exactly.
2. Each ``summarize`` equals the JAX scripts' numpy post-processing
   (transcribed below from ``scripts/eval_policy.py:106-112`` and
   ``scripts/eval_go2.py:99-107``) exactly, on the same arrays.
3. The SAC branch of ``eval_policy`` end to end on the CPU (2 episodes x
   2 steps, a stochastic policy) and the printed lines.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.train import configs
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import ppo, running_statistics, sac
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.train import eval_go2, eval_policy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = os.path.join(ROOT, 'logs')
CUBE = ('AirbotCubePushTrain',
        os.path.join(LOGS, 'cube_ppo_15M_r4', 'final_params.pkl'))
JOYSTICK = ('Go2JoystickFlatTerrain',
            os.path.join(LOGS, 'go2_joystick_50M_r5', 'final_params.pkl'))
GETUP = ('Go2Getup', os.path.join(LOGS, 'go2_getup_5M_r5',
                                  'final_params.pkl'))
B, STEPS = 4, 3
NO_NOISE = {'noise_config.level': 0.0}
JOYSTICK_INIT = ('command', 'steps_until_next_cmd', 'steps_until_next_pert',
                 'pert_duration_seconds', 'pert_duration', 'pert_mag')


def _jax_policy(name, path, jbase):
  """The deterministic policy as ``scripts/eval_go2.py`` builds it."""
  nf = configs.ppo_config(name).network_factory
  net = jnets.make_ppo_networks(
      jbase.observation_size, jbase.action_size,
      policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes),
      policy_obs_key=nf.get('policy_obs_key', 'state'),
      value_obs_key=nf.get('value_obs_key', 'state'))
  policy = ppo._make_policy_factory(net, running_statistics.normalize)(
      sac.load_params(path), deterministic=True)
  return jax.jit(lambda obs: policy(obs, jax.random.PRNGKey(0))[0])


def _jax_rollout(jenv, jstate, jpolicy, metric):
  """STEPS steps; (rewards, dones, *metric(state)) each (T, B)."""
  jstep = jax.jit(jenv.step)
  rows = []
  for _ in range(STEPS):
    jstate = jstep(jstate, jpolicy(jstate.obs))
    rows.append([np.asarray(x) for x in
                 (jstate.reward, jstate.done, *metric(jstate))])
  return [np.stack(x) for x in zip(*rows)]


def _close(p, j, what):
  """Within 1e-2 of the quantity's scale."""
  scale = max(1.0, float(np.abs(j).max()))
  np.testing.assert_allclose(p, j, rtol=1e-2, atol=1e-2 * scale,
                             err_msg=what)


def _port_env(name, init, **load_kw):
  base = penvs.load(name, device='cpu', **load_kw)
  base.sample_init = lambda generator, batch: init
  env = pwrappers.wrap_for_training(base, episode_length=1000, num_envs=B)
  return env, env.reset(torch.Generator().manual_seed(0))


@pytest.fixture
def interpret(monkeypatch):
  """The JAX lanes route through the Pallas kernels in interpret mode."""
  monkeypatch.setattr(jlk, '_INTERPRET', True)
  jFF._CACHE.clear()
  yield
  jFF._CACHE.clear()


def test_eval_policy_rollout_matches_jax(interpret):
  name, path = CUBE
  jbase = jenvs.load(name)
  jenv = jwrappers.wrap_for_training(jbase, episode_length=1000)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(2), B))
  t = lambda x: torch.from_numpy(np.array(x))
  d = jstate.data
  env, state = _port_env(name, tuple(t(x) for x in (d.qpos, d.qvel, d.ctrl)))
  policy = eval_policy.load_policy(path, name, device='cpu')
  port = eval_policy.rollout(env, policy, state, STEPS)
  ref = _jax_rollout(jenv, jstate, _jax_policy(name, path, jbase),
                     lambda s: (jnp.linalg.norm(s.obs[:, -6:-3], axis=-1),))
  for p, j, what in zip(port, ref, ('reward', 'done', 'distance')):
    assert p.shape == (STEPS, B), what
    if what == 'done':
      np.testing.assert_array_equal(p, j)
    else:
      _close(p, j, what)


def test_eval_go2_joystick_rollout_matches_jax(interpret):
  name, path = JOYSTICK
  jbase = jenvs.load(name, config_overrides=NO_NOISE)
  jenv = jwrappers.wrap_for_training(jbase, episode_length=1000)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), B))
  far = jnp.full((B,), 50, jnp.int32)  # no command change within 3 steps
  jstate.info['steps_until_next_cmd'] = far
  jstate.info['first_info']['steps_until_next_cmd'] = far
  t = lambda x: torch.from_numpy(np.array(x))
  init = dict(qpos=t(jstate.data.qpos), qvel=t(jstate.data.qvel),
              **{k: t(jstate.info[k]) for k in JOYSTICK_INIT})
  env, state = _port_env(name, init, config_overrides=NO_NOISE)
  policy = eval_policy.load_policy(path, name, device='cpu')
  port = eval_go2.rollout(env, policy, state, STEPS, joystick=True)

  def errors(s):  # scripts/eval_go2.py:76-81
    cmd = s.info['command']
    linvel = jax.vmap(jbase.get_local_linvel)(s.data)
    gyro = jax.vmap(jbase.get_gyro)(s.data)
    return (jnp.linalg.norm(cmd[:, :2] - linvel[:, :2], axis=-1),
            jnp.abs(cmd[:, 2] - gyro[:, 2]))

  ref = _jax_rollout(jenv, jstate, _jax_policy(name, path, jbase), errors)
  for p, j, what in zip(port, ref, ('reward', 'done', 'lin_err', 'ang_err')):
    if what == 'done':
      np.testing.assert_array_equal(p, j)
    else:
      _close(p, j, what)
  assert not port[4].any()  # no upright criterion on the joystick


def test_eval_go2_getup_rollout_matches_jax():
  name, path = GETUP
  over = dict(NO_NOISE, drop_from_height_prob=0.0)
  jbase = jenvs.load(name, config_overrides=over)
  jenv = jwrappers.wrap_for_training(jbase, episode_length=1000)
  keys = jax.random.split(jax.random.PRNGKey(1), B)
  jstate = jax.jit(jenv.reset)(keys)
  # the home branch's pre-settle draws (getup.py:115-130): the home pose and
  # the root velocity; the port settles them as JAX's reset does
  qvel = jax.vmap(lambda k: jnp.zeros(jbase.model.nv).at[0:6].set(
      jax.random.uniform(jax.random.split(jax.random.split(k, 3)[0])[1],
                         (6,), minval=-0.5, maxval=0.5)))(keys)
  t = lambda x: torch.from_numpy(np.array(x))
  init = dict(qpos=t(jnp.broadcast_to(jbase._init_q, (B, jbase.model.nq))),
              qvel=t(qvel))
  env, state = _port_env(name, init, config_overrides=over)
  policy = eval_policy.load_policy(path, name, device='cpu')
  port = eval_go2.rollout(env, policy, state, STEPS, joystick=False)

  def posture(s):  # scripts/eval_go2.py:83-86, and the env's criterion
    grav = jax.vmap(jbase.get_gravity)(s.data)
    return (-grav[:, 2] / (jnp.linalg.norm(grav, axis=-1) + 1e-9),
            jnp.zeros(B), jax.vmap(jbase._is_upright)(grav))

  ref = _jax_rollout(jenv, jstate, _jax_policy(name, path, jbase), posture)
  for p, j, what in zip(port, ref, ('reward', 'done', 'uprightness',
                                    'ang_err', 'upright')):
    if what in ('done', 'upright', 'ang_err'):
      np.testing.assert_array_equal(p, j.astype(p.dtype), err_msg=what)
    else:
      _close(p, j, what)
  assert port[2].min() > 0.95  # settled on its feet from the home pose


def _arrays(seed, T=7, n=5):
  rng = np.random.default_rng(seed)
  dones = (rng.random((T, n)) < 0.15).astype(np.float32)
  dones[:, 0] = 0  # one episode that never ends
  return (rng.normal(size=(T, n)).astype(np.float32), dones,
          rng.random((T, n)).astype(np.float32),
          rng.random((T, n)).astype(np.float32))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_eval_policy_summary_is_the_jax_scripts(seed):
  rews, dones, dists, _ = _arrays(seed)
  T, n = dones.shape
  # scripts/eval_policy.py:106-112
  first_done = np.argmax(dones > 0, axis=0)
  first_done[~(dones > 0).any(axis=0)] = T - 1
  idx = np.arange(n)
  min_dist = np.array([dists[: first_done[e] + 1, e].min() for e in idx])
  ep_rew = np.array([rews[: first_done[e] + 1, e].sum() for e in idx])
  s = eval_policy.summarize(rews, dones, dists, T)
  np.testing.assert_array_equal(s['first_done'], first_done)
  np.testing.assert_array_equal(s['min_dist'], min_dist)
  np.testing.assert_array_equal(s['ep_rew'], ep_rew)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_eval_go2_summary_is_the_jax_scripts(seed):
  rews, dones, lin_err, ang_err = _arrays(seed)
  episode_length = dones.shape[0]
  # scripts/eval_go2.py:99-107
  first_done = np.argmax(dones > 0, axis=0)
  first_done[~(dones > 0).any(axis=0)] = episode_length - 1
  T = np.arange(episode_length)[:, None]
  alive = T <= first_done[None, :]
  ep_rew = np.where(alive, rews, 0.0).sum(axis=0)
  ep_len = first_done + 1
  m_lin = np.where(alive, lin_err, 0.0).sum() / alive.sum()
  m_ang = np.where(alive, ang_err, 0.0).sum() / alive.sum()
  upright = (lin_err > 0.5).astype(np.float32)
  s = eval_go2.summarize(rews, dones, lin_err, ang_err, episode_length,
                         upright)
  np.testing.assert_array_equal(s['ep_rew'], ep_rew)
  np.testing.assert_array_equal(s['ep_len'], ep_len)
  assert s['m_lin'] == m_lin and s['m_ang'] == m_ang
  assert s['finite'] == (np.isfinite(rews).all() and bool(alive.any()))
  # the share upright at each episode's last alive step
  assert s['upright_end'] == np.mean(
      [upright[first_done[e], e] for e in range(dones.shape[1])])


def test_eval_policy_cli_sac(capsys):
  summary = eval_policy.main([
      os.path.join(LOGS, 'cube_sac_500k_r5', 'final_params.pkl'), '--algo',
      'sac', '--stochastic', '--device', 'cpu', '--episodes', '2',
      '--episode_length', '2'])
  lines = capsys.readouterr().out.splitlines()
  assert lines[0] == 'AirbotCubePushTrain stochastic eval over 2 episodes:'
  assert lines[-1].startswith('  success fraction:  <5cm ')
  assert np.isfinite(summary['ep_rew']).all()
  assert (summary['min_dist'] > 0).all()
