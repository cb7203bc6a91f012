"""The port's PPO training slice against the JAX package's, on the CPU.

1. One whole training step of ``ppo.train`` on AirbotCubePushTrain (B 4,
   unroll 2, batch 2 x 2 minibatches, 1 update, episode length 2 so that
   the second step truncates and resets) against the same step assembled
   from the JAX package's public pieces: ``acting.generate_unroll`` (the
   Pallas kernels in interpret mode), ``running_statistics.update``,
   ``compute_ppo_loss`` and optax.  Both start from the JAX reset of
   PRNGKey(2) (a mild start, tests/test_torch_slice.py) and the JAX
   initial parameters; the JAX action draws, permutation and entropy draws
   are handed to the port.  Tolerances: the rollout's transitions 1e-4
   (they agree to 5e-7 from this start with these draws; from some other
   draws a contact in one env lands on another near-minimum of the fixed
   6-step solve in the two packages and the obs part by up to 0.08, the
   fp32 regime ROADMAP §3 records); on the port's own transitions, the
   normalizer's mean rtol 1e-6 and summed variance within 1e-6 of Σx²
   (it cancels), then on the port's normalizer the loss metrics rtol 1e-5
   and the parameters after the two Adam steps within 1e-6 (a hundredth
   of the learning rate).
2. ``ppo.train`` end to end on the CPU at that size: metrics, env steps,
   checkpoints saved and restored, ``num_timesteps=0``.
3. ``python -m rsr_mjx_tpu_torch.train.cli`` at a tiny size: progress.json
   and final_params.pkl, read back by ``networks.load_ppo_params``.
"""

import functools
import json
import os

import jax
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
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import running_statistics as jrs
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.train import acting as pacting
from rsr_mjx_tpu_torch.train import checkpoint as pcheckpoint
from rsr_mjx_tpu_torch.train import cli as pcli
from rsr_mjx_tpu_torch.train import networks as pnets
from rsr_mjx_tpu_torch.train import ppo as pppo
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ENV = 'AirbotCubePushTrain'
B, T, BATCH, NMB, EPISODE = 4, 2, 2, 2, 2
SIZES = dict(policy_hidden_layer_sizes=(8, 8), value_hidden_layer_sizes=(16, 16))
LOSS = dict(entropy_cost=2e-2, discounting=0.96, reward_scaling=0.1,
            gae_lambda=0.95, clipping_epsilon=0.3, normalize_advantage=True)
LR, CLIP = 1e-4, 1.0


def _jax_step(monkeypatch):
  """The JAX side: reset, initial params, the rollout and its draws."""
  jenv = jwrappers.wrap_for_training(jenvs.load(ENV), episode_length=EPISODE)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(2), B))
  jnet = jnets.make_ppo_networks(23, 5, **SIZES)
  params = jnet.init(jax.random.PRNGKey(0))
  norm0 = jrs.init_state(23)

  def policy(obs, key):  # ppo.train's rollout policy, normalized obs
    logits = jnet.policy_logits(params, jrs.normalize(norm0, obs))
    raw = jnet.distribution.sample_no_postprocess(logits, key)
    return jnet.distribution.postprocess(raw), {
        'log_prob': jnet.distribution.log_prob(logits, raw),
        'raw_action': raw}

  act_key = jax.random.PRNGKey(0)
  monkeypatch.setattr(jlk, '_INTERPRET', True)
  jFF._CACHE.clear()
  try:
    _, data = jax.jit(lambda s, k: jacting.generate_unroll(
        jenv, s, policy, k, T, extra_fields=('truncation',)))(jstate, act_key)
  finally:
    jFF._CACHE.clear()
  # the draws of generate_unroll: per step, the first half of a split
  draws, key = [], act_key
  for _ in range(T):
    cur, key = jax.random.split(key)
    draws.append(jax.random.normal(cur, (B, 5)))
  return jstate, jnet, params, norm0, jax.device_get(data), draws


def test_training_step_matches_jax(monkeypatch, tmp_path):
  jstate, jnet, params, norm0, jdata, act_draws = _jax_step(monkeypatch)
  perm = np.array(jax.random.permutation(jax.random.PRNGKey(7), B))
  loss_keys = [jax.random.PRNGKey(10 + i) for i in range(NMB)]
  ent_draws = [jax.random.normal(k, (T, B // NMB, 5)) for k in loss_keys]

  # the port: ppo.train from the same reset, parameters and draws
  base = penvs.load(ENV, device='cpu')
  d = jstate.data
  init = tuple(torch.from_numpy(np.array(x)) for x in (d.qpos, d.qvel, d.ctrl))
  monkeypatch.setattr(base, 'sample_init', lambda generator, batch: init)
  ckpt = str(tmp_path / 'init')
  pnorm0, sd = pnets.ppo_params_from_numpy(norm0, params, device='cpu')
  net0 = pnets.make_ppo_networks(23, 5, **SIZES)
  net0.load_state_dict(sd)
  pcheckpoint.save(ckpt, (pnorm0, net0))
  queue = [torch.from_numpy(np.array(x)) for x in act_draws + ent_draws]
  monkeypatch.setattr(pnets, 'standard_normal',
                      lambda shape, generator: queue.pop(0))
  monkeypatch.setattr(pppo, 'permutation',
                      lambda n, generator: torch.from_numpy(perm))
  rollouts, steps = [], []
  real_unroll, real_step = pacting.generate_unroll, pppo.minibatch_step

  def unroll(*a, **k):
    out = real_unroll(*a, **k)
    rollouts.append(out[1])
    return out

  def step(networks, optimizer, normalizer, data, noise, *rest):
    metrics = real_step(networks, optimizer, normalizer, data, noise, *rest)
    steps.append((normalizer, data, metrics))
    return metrics

  monkeypatch.setattr(pacting, 'generate_unroll', unroll)
  monkeypatch.setattr(pppo, 'minibatch_step', step)
  _, (pnorm, pnet), metrics = pppo.train(
      base, num_timesteps=BATCH * T * NMB, episode_length=EPISODE,
      num_envs=B, batch_size=BATCH, num_minibatches=NMB, unroll_length=T,
      num_updates_per_batch=1, num_evals=0, normalize_observations=True,
      learning_rate=LR, max_grad_norm=CLIP,
      network_factory=functools.partial(pnets.make_ppo_networks, **SIZES),
      restore_checkpoint_path=ckpt, device='cpu', **LOSS)
  assert not queue and len(rollouts) == 1 and len(steps) == NMB

  # the rollout against the JAX rollout
  pdata = rollouts[0]
  pairs = [('observation', pdata.observation, jdata.observation),
           ('next_observation', pdata.next_observation,
            jdata.next_observation),
           ('reward', pdata.reward, jdata.reward),
           ('action', pdata.action, jdata.action)]
  pairs += [(k, pdata.extras['policy_extras'][k],
             jdata.extras['policy_extras'][k])
            for k in ('raw_action', 'log_prob')]
  for name, p, j in pairs:
    np.testing.assert_allclose(p.numpy(), j, rtol=1e-4, atol=1e-4,
                               err_msg=name)
  np.testing.assert_array_equal(pdata.discount.numpy(), jdata.discount)
  np.testing.assert_array_equal(
      pdata.extras['state_extras']['truncation'].numpy(),
      jdata.extras['state_extras']['truncation'])
  assert pdata.extras['state_extras']['truncation'][-1].tolist() == [1.0] * B

  # the JAX update on the port's transitions: [T, B] → [B, T]
  data = jax.tree.map(lambda x: np.swapaxes(x.numpy(), 0, 1),
                      jlosses.Transition(*pdata))
  jnorm = jrs.update(norm0, data.observation)
  pn = {k: getattr(pnorm, k).numpy() for k in ('count', 'mean',
                                                'summed_variance', 'std')}
  assert pn['count'] == jnorm.count == B * T
  np.testing.assert_allclose(pn['mean'], jnorm.mean, rtol=1e-6, atol=1e-7)
  # Σ(x − m_old)(x − m_new) from m_old = 0 cancels: its fp32 rounding is
  # that of its terms, Σx², not of the result
  x2 = np.square(data.observation.astype(np.float64)).sum((0, 1))
  assert (np.abs(pn['summed_variance'] - jnorm.summed_variance)
          <= 1e-6 * x2).all()
  np.testing.assert_allclose(
      pn['std'], np.sqrt(pn['summed_variance'] / pn['count'] + 1e-6),
      rtol=1e-6)
  # the loss on the port's normalizer, so that both sides see one input
  jnorm = jrs.RunningStatisticsState(**pn)
  loss_fn = jax.jit(jax.value_and_grad(functools.partial(
      jlosses.compute_ppo_loss, ppo_network=jnet, past_data=None, **LOSS),
      has_aux=True))
  opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR))
  state = opt.init(params)
  shuffled = jax.tree.map(
      lambda x: x[perm].reshape((NMB, -1) + x.shape[1:]), data)
  for i in range(NMB):
    mb = jax.tree.map(lambda x: x[i], shuffled)
    jax.tree.map(lambda p, j: np.testing.assert_array_equal(p.numpy(), j),
                 jlosses.Transition(*steps[i][1]), jlosses.Transition(*mb))
    (_, jmetrics), grads = loss_fn(params, jnorm, mb, loss_keys[i])
    for k, v in jmetrics.items():
      np.testing.assert_allclose(steps[i][2][k].numpy(), np.asarray(v),
                                 rtol=1e-5, atol=1e-7, err_msg=k)
    updates, state = opt.update(grads, state, params)
    params = optax.apply_updates(params, updates)
  _, pparams = pnets.ppo_params_to_numpy(pnorm, pnet)
  jax.tree.map(lambda p, j: np.testing.assert_allclose(p, j, rtol=0,
                                                       atol=1e-6),
               pparams, jax.device_get(params))
  assert np.isfinite(metrics['training/total_loss'])


def _small_train(**kw):
  base = penvs.load(ENV, device='cpu')
  args = dict(environment=base, num_timesteps=2 * BATCH * T * NMB,
              episode_length=EPISODE, num_envs=B, num_eval_envs=2,
              batch_size=BATCH, num_minibatches=NMB, unroll_length=T,
              num_updates_per_batch=1, normalize_observations=True,
              learning_rate=LR, max_grad_norm=CLIP,
              network_factory=functools.partial(pnets.make_ppo_networks,
                                                **SIZES),
              device='cpu', **LOSS)
  args.update(kw)
  return pppo.train(**args)


def test_train_end_to_end_and_checkpoints(tmp_path):
  progress, saved = [], []

  def save(step, make_policy, params):
    path = str(tmp_path / 'checkpoints' / str(step))
    pcheckpoint.save(path, params)
    saved.append(path)

  make_policy, (norm, net), metrics = _small_train(
      num_evals=2, progress_fn=lambda s, m: progress.append((s, m)),
      policy_params_fn=save)
  per_step = BATCH * T * NMB
  assert [s for s, _ in progress] == [0, 2 * per_step]
  assert float(norm.count) == 2 * per_step  # every rollout observation
  for key in ('training/sps', 'training/total_loss', 'training/v_loss',
              'training/policy_loss', 'training/entropy_loss',
              'eval/episode_reward', 'eval/avg_episode_length'):
    assert np.isfinite(metrics[key]), key
  assert metrics['eval/avg_episode_length'] == EPISODE
  assert metrics['eval/nan_episodes'] == 0
  obs = torch.zeros(3, 23)
  act, extras = make_policy((norm, net))(obs, torch.Generator())
  assert act.shape == (3, 5) and extras['log_prob'].shape == (3,)
  assert make_policy((norm, net), deterministic=True)(obs, None)[1] == {}

  latest = pcheckpoint.latest_checkpoint(str(tmp_path / 'checkpoints'))
  assert latest == saved[-1]
  _, (norm2, net2), m2 = _small_train(num_timesteps=0,
                                      restore_checkpoint_path=latest)
  assert m2 == {}
  for k, v in net.state_dict().items():
    assert torch.equal(net2.state_dict()[k], v), k
  for name in ('count', 'mean', 'summed_variance', 'std'):
    assert torch.equal(getattr(norm2, name), getattr(norm, name)), name


def test_cli_writes_progress_and_final_params(tmp_path):
  logdir = tmp_path / 'run'
  _, (norm, net), _ = pcli.main([
      '--env', ENV, '--device', 'cpu', '--logdir', str(logdir),
      '--num_timesteps', '8', '--num_envs', '4', '--batch_size', '2',
      '--num_minibatches', '2', '--unroll_length', '2',
      '--num_updates_per_batch', '1', '--episode_length', '3',
      '--num_evals', '0'])
  progress = json.loads((logdir / 'progress.json').read_text())
  assert [p['step'] for p in progress] == [8]
  assert np.isfinite(progress[0]['training/total_loss'])
  assert os.listdir(logdir / 'checkpoints') == ['8']
  # the run's host time by span and its counters (utils.tracing)
  traced = json.loads((logdir / 'tracing.json').read_text())
  assert {'ppo.setup', 'ppo.unroll', 'ppo.minibatch_step',
          'ppo.normalizer_update', 'env.step', 'physics.step'} <= set(
              traced['spans'])
  assert traced['counters']['physics.substeps'] > 0
  normalizer, params = pnets.load_ppo_params(str(logdir / 'final_params.pkl'))
  want_norm, want = pnets.ppo_params_to_numpy(norm, net)
  jax.tree.map(np.testing.assert_array_equal, params, want)
  np.testing.assert_array_equal(normalizer.std, want_norm.std)
  assert [layer['w'].shape for layer in params['policy']] == [
      (23, 32), (32, 32), (32, 32), (32, 32), (32, 10)]
  # the serving path takes the trained pickle as it takes the JAX one
  policy = pnets.make_policy(normalizer, params, device='cpu')
  assert policy(torch.zeros(2, 23)).shape == (2, 5)
