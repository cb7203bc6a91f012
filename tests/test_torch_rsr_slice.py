"""The port's two training paths of this slice, on the CPU.

1. RSR policy training on AirbotCubePush: ``rsr.pipeline.
   policy_params_training`` at a tiny size (B 8, as
   tests/test_rsr_pipeline.py::test_rsr_policy_training_end_to_end) with
   the penalty's gate open (bandwidth 2.0): finite metrics, a nonzero
   ``sim2real_loss``, the deterministic policy.  The RSR CLI
   (``python -m rsr_mjx_tpu_torch.rsr.cli``) on ``data_rsr_demo/``:
   progress.json with the penalty's metrics, checkpoints and a
   ``final_params.pkl`` that the JAX package reads (``sac.load_params``)
   in a process where torch cannot be imported, and whose deterministic
   policy there gives the port's actions (rtol 1e-5: the same fp32 MLP,
   another summation order).  The CLI's default, SAC, on the demo data and
   on the Go2 joystick's 'state' entry (``SelectObservationWrapper``),
   its pickles read by the JAX package the same way.
2. PPO on the Go2 joystick: the Go2 tables equal to the JAX package's for
   every Go2 task; the trained value network on ``privileged_state``
   (logs/go2_joystick_50M_r5/final_params.pkl) against JAX's (rtol 1e-5);
   ``python -m rsr_mjx_tpu_torch.train.cli --env Go2JoystickFlatTerrain``
   at a tiny size: finite metrics, and K1 and K4 (their plain versions on
   the CPU) called once a substep and once for the reset, K2 and K3 never.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu.train import configs as jconfigs
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import running_statistics as jrs
from rsr_mjx_tpu.train import sac as jsac
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.rsr import cli as rsr_cli
from rsr_mjx_tpu_torch.rsr import pipeline as ppipeline
from rsr_mjx_tpu_torch.train import cli as pcli
from rsr_mjx_tpu_torch.train import configs as pconfigs
from rsr_mjx_tpu_torch.train import networks as pnets
from rsr_mjx_tpu_torch.train import running_statistics as prs
from rsr_mjx_tpu_torch.train import sac as psac
from rsr_mjx_tpu_torch.train import sac_networks as psn
from torch_testing import child_env, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, 'data_rsr_demo')
GO2_PARAMS = os.path.join(ROOT, 'logs', 'go2_joystick_50M_r5',
                          'final_params.pkl')
GO2_TASKS = ('Go2JoystickFlatTerrain', 'Go2JoystickRoughTerrain', 'Go2Getup',
             'Go2Handstand', 'Go2Footstand')
TINY_RSR = ['--algorithm', 'ppo', '--data_dir', DEMO, '--device', 'cpu',
            '--num_timesteps', '8', '--num_envs', '4', '--batch_size', '2',
            '--num_minibatches', '2', '--unroll_length', '2',
            '--num_updates_per_batch', '1', '--episode_length', '3',
            '--num_evals', '2', '--num_eval_envs', '4', '--bandwidth', '2.0']


def test_rsr_policy_training_end_to_end():
  env = penvs.load('AirbotCubePush', device='cpu')
  rng = np.random.RandomState(3)
  n, obs_dim, act_dim = 5, 23, 5
  s = rng.randn(n, obs_dim)
  a = rng.randn(n, act_dim)
  progress = []
  make_inference_fn, params = ppipeline.policy_params_training(
      env=env, algorithm='ppo', past_states=s, past_actions=a,
      past_next_states_real=s + 0.1, past_next_states_sim=s + 0.2,
      current_next_states_sim=s + 0.05, bandwidth=2.0, rsr_loss_scale=1.0,
      num_timesteps=32, num_evals=1, episode_length=4, num_envs=8,
      batch_size=8, unroll_length=2, num_minibatches=2,
      num_updates_per_batch=1, num_eval_envs=8, seed=0,
      progress_fn=lambda step, m: progress.append((step, m)), device='cpu')
  (step, metrics), = progress
  assert step == 32
  assert all(np.isfinite(v) for v in metrics.values())
  assert metrics['training/sim2real_loss'] > 0
  assert metrics['training/rsr_distribution_distance'] > 0
  policy = make_inference_fn(params, deterministic=True)
  act, _ = policy(torch.zeros(3, obs_dim), None)
  assert act.shape == (3, act_dim) and torch.isfinite(act).all()
  for bad in (dict(algorithm='sac', restore_checkpoint_path='ckpt'),
              dict(algorithm='a2c'), dict(rsr_loss_scale=-1.0),
              dict(past_states=None)):
    kw = dict(env=env, past_states=s, past_actions=a,
              past_next_states_real=s, past_next_states_sim=s,
              current_next_states_sim=s, device='cpu')
    kw.update(bad)
    with pytest.raises(ValueError, match='SAC cannot resume|algorithm|'
                       'non-negative|required'):
      ppipeline.policy_params_training(**kw)


# The JAX package's deterministic policy on a port-written pickle, in a
# process where ``import torch`` fails.
_JAX_READER = r'''
import sys
sys.modules['torch'] = None  # any import of torch now raises ImportError
import jax, numpy as np
from rsr_mjx_tpu.train import networks, ppo, running_statistics, sac
params = sac.load_params(sys.argv[1])
assert type(params[0]).__module__ == 'rsr_mjx_tpu.train.running_statistics'
net = networks.make_ppo_networks(23, 5, policy_hidden_layer_sizes=(32,) * 4,
                                 value_hidden_layer_sizes=(32,) * 4)
policy = ppo._make_policy_factory(net, running_statistics.normalize)(
    params, deterministic=True)
obs = np.load(sys.argv[2])
np.save(sys.argv[3], np.asarray(policy(obs, jax.random.PRNGKey(0))[0]))
'''


def test_rsr_cli_writes_a_pickle_the_jax_package_reads_without_torch(
    tmp_path):
  logdir = tmp_path / 'rsr'
  make_inference_fn, (norm, net) = rsr_cli.main(
      TINY_RSR + ['--logdir', str(logdir)])
  progress = json.loads((logdir / 'progress.json').read_text())
  assert [p['step'] for p in progress] == [0, 8]
  last = progress[-1]
  assert last['training/sim2real_loss'] > 0
  assert last['training/rsr_distribution_distance'] > 0
  assert np.isfinite(last['eval/episode_reward'])
  assert os.listdir(logdir / 'checkpoints') == ['8']

  pkl = str(logdir / 'final_params.pkl')
  rng = np.random.default_rng(0)
  obs = (norm.mean.numpy() + norm.std.numpy()
         * rng.normal(size=(16, 23))).astype(np.float32)
  np.save(tmp_path / 'obs.npy', obs)
  env = child_env(JAX_PLATFORMS='cpu', PYTHONPATH=ROOT)
  done = subprocess.run(
      [sys.executable, '-c', _JAX_READER, pkl, str(tmp_path / 'obs.npy'),
       str(tmp_path / 'act.npy')], env=env, cwd=ROOT, capture_output=True,
      text=True, timeout=300)
  assert done.returncode == 0, done.stderr[-2000:]
  jact = np.load(tmp_path / 'act.npy')
  normalizer, params = pnets.load_ppo_params(pkl)
  with torch.no_grad():
    served = pnets.make_policy(normalizer, params, device='cpu')(
        torch.from_numpy(obs)).numpy()
    trained = make_inference_fn((norm, net), deterministic=True)(
        torch.from_numpy(obs), None)[0].numpy()
  assert jact.shape == (16, 5) and np.abs(jact).max() > 0
  np.testing.assert_array_equal(served, trained)
  np.testing.assert_allclose(served, jact, rtol=1e-5, atol=1e-6)


# The JAX package's deterministic SAC policy on a port-written pickle, in a
# process where ``import torch`` fails.
_JAX_SAC_READER = r'''
import sys
sys.modules['torch'] = None  # any import of torch now raises ImportError
import numpy as np
from rsr_mjx_tpu.train import running_statistics, sac, sac_networks
normalizer, policy = sac.load_params(sys.argv[1])
assert type(normalizer).__module__ == 'rsr_mjx_tpu.train.running_statistics'
obs_size, action_size = policy[0]['w'].shape[0], policy[-1]['w'].shape[1] // 2
net = sac_networks.make_sac_networks(
    obs_size, action_size,
    hidden_layer_sizes=[layer['w'].shape[1] for layer in policy[:-1]])
obs = np.load(sys.argv[2])
logits = net.policy_logits(policy, running_statistics.normalize(normalizer,
                                                                obs))
np.save(sys.argv[3], np.asarray(net.distribution.mode(logits)))
'''


def _go2_rsr_files(path):
  """Six seeded RSR files at the Go2 policy's widths: obs 48, action 12."""
  rng = np.random.default_rng(4)
  n = 6
  for name, width in (('real_obs.txt', 48), ('real_action.txt', 12),
                      ('past_sim_obs.txt', 48), ('current_sim_obs.txt', 48),
                      ('obs.txt', 48), ('actions.txt', 12)):
    rows = n if width == 12 else n + 1
    np.savetxt(path / name, rng.normal(size=(rows, width)), delimiter=',')
  return str(path)


@pytest.mark.parametrize('case', ['sac cube-push', 'sac go2 state'])
def test_rsr_cli_trains_sac_and_dict_observations(case, tmp_path):
  """The RSR CLI's default ``--algorithm sac`` at a tiny size: on the demo
  data (cube-push), and on a dict-observation env (Go2, seeded data of
  widths 48 and 12) whose 'state' entry ``SelectObservationWrapper``
  feeds the policy.  The checkpoint and ``final_params.pkl`` are read by
  the JAX package in a process where torch cannot be imported; its
  deterministic policy there gives the port's actions (rtol 1e-5)."""
  go2 = case.endswith('state')
  logdir = tmp_path / 'rsr'
  data = _go2_rsr_files(tmp_path) if go2 else DEMO
  argv = ['--data_dir', data, '--device', 'cpu', '--logdir', str(logdir),
          '--num_timesteps', '16', '--num_envs', '4', '--batch_size', '4',
          '--min_replay_size', '8', '--max_replay_size', '12',
          '--episode_length', '3', '--num_evals', '2', '--num_eval_envs',
          '2', '--bandwidth', '2.0']
  if go2:
    argv += ['--env', 'Go2JoystickFlatTerrain']
  make_inference_fn, (norm, net) = rsr_cli.main(argv)
  obs_size, act_size = (48, 12) if go2 else (23, 5)
  assert (net.obs_size, net.action_size) == (obs_size, act_size)
  progress = json.loads((logdir / 'progress.json').read_text())
  assert [p['step'] for p in progress] == [0, 16]
  for key in ('training/critic_loss', 'training/actor_loss',
              'eval/episode_reward'):
    assert np.isfinite(progress[-1][key]), key
  assert os.listdir(logdir / 'checkpoints') == ['run_sac_16.pkl']
  assert float(norm.count) == 16

  pkl = str(logdir / 'final_params.pkl')
  rng = np.random.default_rng(0)
  obs = (norm.mean.numpy() + norm.std.numpy()
         * rng.normal(size=(16, obs_size))).astype(np.float32)
  np.save(tmp_path / 'obs.npy', obs)
  env = child_env(JAX_PLATFORMS='cpu', PYTHONPATH=ROOT)
  done = subprocess.run(
      [sys.executable, '-c', _JAX_SAC_READER, pkl, str(tmp_path / 'obs.npy'),
       str(tmp_path / 'act.npy')], env=env, cwd=ROOT, capture_output=True,
      text=True, timeout=300)
  assert done.returncode == 0, done.stderr[-2000:]
  jact = np.load(tmp_path / 'act.npy')
  normalizer, policy = psac.load_params(pkl)
  with torch.no_grad():
    served = psn.make_policy(normalizer, policy, device='cpu')(
        torch.from_numpy(obs)).numpy()
    trained = make_inference_fn((norm, net), deterministic=True)(
        torch.from_numpy(obs), None)[0].numpy()
  assert jact.shape == (16, act_size) and np.abs(jact).max() > 0
  np.testing.assert_array_equal(served, trained)
  np.testing.assert_allclose(served, jact, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('task', GO2_TASKS)
def test_go2_ppo_config_matches_jax(task):
  jcfg = jconfigs.ppo_config(task).to_dict()
  jcfg['network_factory'] = {
      k: list(v) if isinstance(v, tuple) else v
      for k, v in jcfg['network_factory'].items()}
  assert pconfigs.ppo_config(task) == jcfg


def test_go2_value_network_on_privileged_state_matches_jax():
  normalizer, params = pnets.load_ppo_params(GO2_PARAMS)
  rng = np.random.default_rng(1)
  obs = {k: (normalizer.mean[k] + normalizer.std[k]
             * rng.normal(size=(32,) + normalizer.mean[k].shape)
             ).astype(np.float32) for k in ('state', 'privileged_state')}
  nf = jconfigs.ppo_config('Go2JoystickFlatTerrain').network_factory
  jnet = jnets.make_ppo_networks(
      {'state': 48, 'privileged_state': 123}, 12,
      policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes),
      policy_obs_key=nf.policy_obs_key, value_obs_key=nf.value_obs_key)
  jvalue = np.asarray(jax.jit(lambda o: jnet.value_apply(
      params, jrs.normalize(normalizer, o)))(
          {k: jnp.asarray(v) for k, v in obs.items()}))
  pnorm, pnet = pnets.networks_from_numpy(
      normalizer, params, device='cpu', policy_obs_key='state',
      value_obs_key='privileged_state')
  assert pnet.value.layers[0].in_features == 123
  with torch.no_grad():
    pvalue = pnet.value_apply(prs.normalize(
        pnorm, {k: torch.from_numpy(v) for k, v in obs.items()})).numpy()
  assert pvalue.shape == (32,)
  np.testing.assert_allclose(pvalue, jvalue, rtol=1e-5,
                             atol=1e-5 * np.abs(jvalue).max())


def test_go2_training_cli_runs_k1_and_k4(tmp_path, monkeypatch):
  calls = dict.fromkeys(('spd_solve_plain', 'contact_select_plain',
                         'newton_pyr_plain', 'newton_generic_plain'), 0)
  for name in calls:
    real = getattr(plk, name)

    def counted(*a, _real=real, _name=name):
      calls[_name] += 1
      return _real(*a)

    monkeypatch.setattr(plk, name, counted)
  logdir = tmp_path / 'go2'
  _, (norm, net), metrics = pcli.main([
      '--env', 'Go2JoystickFlatTerrain', '--device', 'cpu', '--logdir',
      str(logdir), '--num_timesteps', '4', '--num_envs', '2',
      '--batch_size', '2', '--num_minibatches', '1', '--unroll_length', '2',
      '--num_updates_per_batch', '1', '--episode_length', '3',
      '--num_evals', '0'])
  assert all(np.isfinite(v) for v in metrics.values())
  assert metrics['training/sim2real_loss'] == 0
  # one unroll of 2 control steps of 5 substeps, and the reset's forward
  assert calls == {'spd_solve_plain': 11, 'newton_generic_plain': 11,
                   'contact_select_plain': 0, 'newton_pyr_plain': 0}
  assert net.value_obs_key == 'privileged_state'
  assert net.value.layers[0].in_features == 123
  assert float(norm.count) == 2 * 2
  normalizer, params = pnets.load_ppo_params(str(logdir / 'final_params.pkl'))
  assert set(normalizer.mean) == {'state', 'privileged_state'}
  assert [layer['w'].shape for layer in params['policy']] == [
      (48, 512), (512, 256), (256, 128), (128, 24)]
