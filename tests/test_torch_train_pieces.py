"""The port's PPO pieces against the JAX package's, on the CPU.

Inputs come from numpy seeds; where a function draws, the JAX draw is
handed to the port.  Tolerances (fp32 throughout, sums in another order):
  - GAE, the distribution and the Welford update: rtol 1e-6 (elementwise
    arithmetic and short sums);
  - the PPO loss, its metrics and its gradients (with and without the RSR
    penalty): each held, as is the JAX package's fp32 result, to the port's
    own evaluation in float64 (see test_ppo_loss_and_gradients_match_jax);
  - clip + Adam, fed the same gradients: parameters within 1e-9 + 1e-6
    relative (the two compute m̂/(√v̂ + ε) in another order);
  - parameters carried between the layouts: exact;
  - the eval wrapper's sums over a scripted episode and the evaluator's
    metrics: rtol 1e-6 (the same float32 sums in the same order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rsr_mjx_tpu.envs import core as jcore
from rsr_mjx_tpu.rsr import loss as jrsr
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.train import acting as jacting
from rsr_mjx_tpu.train import configs as jconfigs
from rsr_mjx_tpu.train import losses as jlosses
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import running_statistics as jrs
from rsr_mjx_tpu_torch import rsr as prsr
from rsr_mjx_tpu_torch.envs import core as pcore
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.train import acting as pacting
from rsr_mjx_tpu_torch.train import configs as pconfigs
from rsr_mjx_tpu_torch.train import losses as plosses
from rsr_mjx_tpu_torch.train import networks as pnets
from rsr_mjx_tpu_torch.train import ppo as pppo
from rsr_mjx_tpu_torch.train import running_statistics as prs
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

T, B, A = 5, 4, 3
SIZES = dict(policy_hidden_layer_sizes=(8, 8), value_hidden_layer_sizes=(16, 16))


def f32(rng, *shape, scale=1.0):
  return (scale * rng.normal(size=shape)).astype(np.float32)


def tensors(tree):
  return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def test_compute_gae_matches_jax():
  rng = np.random.default_rng(0)
  truncation = (rng.random((T, B)) < 0.2).astype(np.float32)
  termination = ((rng.random((T, B)) < 0.2) * (1 - truncation)).astype(
      np.float32)
  args = (truncation, termination, f32(rng, T, B), f32(rng, T, B),
          f32(rng, B))
  kw = dict(lambda_=0.95, discount=0.96)
  jvs, jadv = jlosses.compute_gae(*args, **kw)
  pvs, padv = plosses.compute_gae(*(torch.from_numpy(a) for a in args), **kw)
  np.testing.assert_allclose(pvs.numpy(), jvs, rtol=1e-6, atol=1e-6)
  np.testing.assert_allclose(padv.numpy(), jadv, rtol=1e-6, atol=1e-6)


def test_distribution_matches_jax():
  rng = np.random.default_rng(1)
  logits = f32(rng, 6, 2 * A, scale=3.0)
  raw = f32(rng, 6, A, scale=2.0)
  jd = jnets.NormalTanhDistribution(event_size=A)
  pd = pnets.NormalTanhDistribution(event_size=A)
  key = jax.random.PRNGKey(4)
  noise = torch.from_numpy(np.array(jax.random.normal(key, (6, A))))
  lt, rt = torch.from_numpy(logits), torch.from_numpy(raw)
  pairs = [
      (pd.log_prob(lt, rt), jd.log_prob(logits, raw)),
      (pd.entropy(lt, noise), jd.entropy(logits, key)),
      (pd.mode(lt), jd.mode(logits)),
      (pd.sample_no_postprocess(lt, noise),
       jd.sample_no_postprocess(logits, key)),
      (pd.postprocess(rt), jd.postprocess(raw)),
  ]
  for p, j in pairs:
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-6)


def _stats_case(case, rng):
  """(initial JAX state, batches) of an update case."""
  if case == 'array':
    return jrs.init_state(7), [f32(rng, 3, 2, 7, scale=2.0) + 1.0,
                               f32(rng, 5, 7)]
  if case == 'dict':
    size = {'state': 4, 'privileged_state': 6}
    return jrs.init_state(size), [
        {k: f32(rng, 2, 3, n) for k, n in size.items()} for _ in range(2)]
  # tests/test_train_ppo.py:315: a slightly negative summed variance from
  # fp32 cancellation must be clamped, not reach the sqrt
  state = jrs.init_state(3).replace(
      count=jnp.asarray(81920.0),
      summed_variance=jnp.array([-0.5, 0.0, 1.0]))
  batch = np.broadcast_to(np.float32(0.7), (64, 3)).copy()
  return state, [batch] * 4


@pytest.mark.parametrize('case', ['array', 'dict', 'negative variance'])
def test_running_statistics_update_matches_jax(case):
  jstate, batches = _stats_case(case, np.random.default_rng(2))
  pstate = prs.RunningStatisticsState(**tensors(
      dict(count=jstate.count, mean=jstate.mean,
           summed_variance=jstate.summed_variance, std=jstate.std)))
  for batch in batches:
    jstate = jrs.update(jstate, batch)
    pstate = prs.update(pstate, tensors(batch))
  for name in ('count', 'mean', 'summed_variance', 'std'):
    jax.tree.map(
        lambda p, j: np.testing.assert_allclose(
            p.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6, err_msg=name),
        getattr(pstate, name), getattr(jstate, name))
  assert pstate.count.dtype == torch.float32
  std = pstate.std if case != 'dict' else pstate.std['state']
  assert torch.isfinite(std).all() and (std > 0).all()
  x = tensors(batches[0])
  back = prs.denormalize(pstate, prs.normalize(pstate, x))
  jax.tree.map(lambda b, a: np.testing.assert_allclose(
      b.numpy(), a.numpy(), rtol=1e-5, atol=1e-5), back, x)


def _loss_problem(dict_obs: bool, rng):
  """A JAX network with its params, a fitted normalizer, and a [B, T]
  batch of transitions whose log-probs are near the policy's (so that the
  ratio is clipped in some entries and not in others)."""
  if dict_obs:
    obs_size = {'state': 7, 'privileged_state': 9}
    keys = dict(policy_obs_key='state', value_obs_key='privileged_state')
    obs = lambda: {k: f32(rng, B, T, n) for k, n in obs_size.items()}
  else:
    obs_size, keys = 7, {}
    obs = lambda: f32(rng, B, T, 7)
  jnet = jnets.make_ppo_networks(obs_size, A, **SIZES, **keys)
  params = jnet.init(jax.random.PRNGKey(1))
  normalizer = jrs.update(jrs.init_state(obs_size), obs())
  observation = obs()
  raw = f32(rng, B, T, A)
  logits = jnet.policy_logits(params,
                              jrs.normalize(normalizer, observation))
  log_prob = (np.asarray(jnet.distribution.log_prob(logits, raw))
              + f32(rng, B, T, scale=0.3))
  data = jlosses.Transition(
      observation=observation,
      action=np.tanh(raw),
      reward=f32(rng, B, T, scale=3.0),
      discount=(rng.random((B, T)) > 0.2).astype(np.float32),
      next_observation=obs(),
      extras={'policy_extras': {'log_prob': log_prob, 'raw_action': raw},
              'state_extras': {'truncation': (rng.random((B, T)) < 0.2)
                               .astype(np.float32)}})
  return jnet, params, normalizer, data, obs_size, keys


U32 = 2.0 ** -24  # unit roundoff of float32


def _rsr_problem():
  """Fixed transition sets (obs 7 + act 3 + next obs 7) and JAX's penalty
  state at bandwidth 2.0, where the KDE is not saturated and the penalty
  and its gradient are not zero."""
  rng = np.random.default_rng(7)
  real = f32(rng, 12, 7 + A + 7)
  prev = real + f32(rng, *real.shape, scale=0.5)
  cur = real + f32(rng, *real.shape, scale=0.2)
  return (real, prev, cur), jrsr.build_rsr_data(real, prev, cur,
                                                bandwidth=2.0)


def _port_loss(data, obs_size, keys, normalizer, params, noise, kw, rsr_sets,
               jgrid, dtype):
  """The port's loss, metrics and gradients in ``dtype`` on the CPU, from
  the same float32 inputs as the JAX evaluation (the RSR state rebuilt
  from the same sets on JAX's grid)."""
  pnet = pnets.make_ppo_networks(obs_size, A, **SIZES, **keys)
  pnorm, sd = pnets.ppo_params_from_numpy(normalizer, params, device='cpu')
  pnet.load_state_dict(sd)
  pnet.to(dtype)
  past = None
  if rsr_sets is not None:
    past = prsr.build_rsr_data(
        *(torch.from_numpy(x).to(dtype) for x in rsr_sets), bandwidth=2.0,
        grid=jgrid)
  pdata = jax.tree.map(lambda x: x.to(dtype), tensors(tuple(data)))
  loss, metrics = plosses.compute_ppo_loss(
      pnet, prs.to(pnorm, 'cpu', dtype), plosses.Transition(*pdata),
      noise.to(dtype), past_data=past, **kw)
  loss.backward()
  grads = {k: p.grad.double().numpy() for k, p in pnet.named_parameters()}
  return loss.item(), {k: v.item() for k, v in metrics.items()}, grads


@pytest.mark.parametrize(
    'dict_obs,normalize_advantage,with_rsr',
    [(False, True, False), (True, False, False), (False, True, True),
     (True, False, True)],
    ids=['False-True', 'True-False', 'False-True-rsr', 'True-False-rsr'])
def test_ppo_loss_and_gradients_match_jax(dict_obs, normalize_advantage,
                                          with_rsr):
  """The port's fp32 loss, metrics and gradients against the port's own
  evaluation of the same loss in float64, per metric and per parameter
  tensor at its largest entry:
   - that it is JAX's loss: the JAX package's fp32 result within 1e-4 of
     the float64 one (relative; measured within 4.6e-6, while taking the
     penalty on normalised observations moves it by 4e-3 or more);
   - precision: |port − f64| <= 8·|jax − f64| + 16·u·|f64| (u = 2⁻²⁴): the
     two fp32 results err by the rounding of the same operations in other
     orders, so neither may be far worse than the other; the floor covers
     a JAX result that happens to land on the float64 one.
  (Held elementwise to each other, 1e-5 of the largest entry, they parted
  by 4.56e-6 against 4.38e-6 in a policy bias on one machine's CPU: both
  are that far from float64 there.)  With the RSR cases the penalty
  (bandwidth 2.0, JAX's grid) is in the loss, on the mode action and the
  raw observations, for dict observations the policy's entry."""
  rng = np.random.default_rng(3)
  jnet, params, normalizer, data, obs_size, keys = _loss_problem(dict_obs,
                                                                 rng)
  kw = dict(entropy_cost=2e-2, discounting=0.96, reward_scaling=0.1,
            gae_lambda=0.95, clipping_epsilon=0.3,
            normalize_advantage=normalize_advantage)
  rsr_sets, jpast, jgrid = None, None, None
  if with_rsr:
    rsr_sets, jpast = _rsr_problem()
    jgrid = np.asarray(jpast.grid)
  loss_fn = functools.partial(jlosses.compute_ppo_loss, ppo_network=jnet,
                              past_data=jpast, **kw)
  key = jax.random.PRNGKey(5)
  (jloss, jmetrics), jgrads = jax.jit(
      jax.value_and_grad(loss_fn, has_aux=True))(params, normalizer, data,
                                                 key)
  noise = torch.from_numpy(np.array(jax.random.normal(key, (T, B, A))))
  args = (data, obs_size, keys, normalizer, params, noise, kw, rsr_sets,
          jgrid)
  ploss, pmetrics, pgrads = _port_loss(*args, torch.float32)
  rloss, rmetrics, rgrads = _port_loss(*args, torch.float64)

  def held(p, j, r, what):
    err_p, err_j = np.abs(p - r).max(), np.abs(j - r).max()
    assert err_j <= 1e-4 * np.abs(r).max(), (
        f'{what}: |jax - f64| {err_j:.3g}, f64 {np.abs(r).max():.3g}')
    bound = 8 * err_j + 16 * U32 * np.abs(r).max()
    assert err_p <= bound, (f'{what}: |port - f64| {err_p:.3g} > {bound:.3g} '
                            f'(|jax - f64| {err_j:.3g})')

  assert sorted(pmetrics) == sorted(jmetrics)
  for k, v in jmetrics.items():
    held(pmetrics[k], float(v), rmetrics[k], k)
  held(ploss, float(jloss), rloss, 'loss')
  if with_rsr:
    assert rmetrics['sim2real_loss'] > 1e-3
  assert len(pgrads) == sum(2 * len(jgrads[net]) for net in jgrads)
  for net in ('policy', 'value'):
    for i, jl in enumerate(jgrads[net]):
      for w, name in (('w', 'weight'), ('b', 'bias')):
        k = f'{net}.layers.{i}.{name}'
        held(pgrads[k], np.asarray(jl[w], np.float64).T, rgrads[k],
             f'{net} layer {i} {w}')


def test_rsr_term_is_zero_without_past_data_and_raises_with_it():
  """Zeros with rsr_loss_scale 0 whatever past_data is, and JAX's
  TypeError for a past_data that is not RSRData."""
  rng = np.random.default_rng(3)
  _, params, normalizer, data, obs_size, _ = _loss_problem(False, rng)
  pnet = pnets.make_ppo_networks(obs_size, A, **SIZES)
  pnorm, sd = pnets.ppo_params_from_numpy(normalizer, params, device='cpu')
  pnet.load_state_dict(sd)
  noise = torch.zeros(T, B, A)
  _, m = plosses.compute_ppo_loss(pnet, pnorm, tensors(data), noise,
                                  past_data=object(), rsr_loss_scale=0.0)
  assert m['sim2real_loss'] == 0 and m['rsr_distribution_distance'] == 0
  with pytest.raises(TypeError, match='past_data must be RSRData or None'):
    plosses.compute_ppo_loss(pnet, pnorm, tensors(data), noise,
                             past_data=object())


def test_ppo_params_round_trip():
  obs_size = {'state': 7, 'privileged_state': 9}
  jnet = jnets.make_ppo_networks(obs_size, A, **SIZES,
                                 value_obs_key='privileged_state')
  params = jax.device_get(jnet.init(jax.random.PRNGKey(2)))
  normalizer = jax.device_get(jrs.update(
      jrs.init_state(obs_size),
      {k: f32(np.random.default_rng(0), 3, n) for k, n in obs_size.items()}))
  pnorm, sd = pnets.ppo_params_from_numpy(normalizer, params, device='cpu')
  pnet = pnets.make_ppo_networks(obs_size, A, **SIZES,
                                 value_obs_key='privileged_state')
  pnet.load_state_dict(sd)  # every key and shape of the port's networks
  norm2, params2 = pnets.ppo_params_to_numpy(pnorm, pnet)
  jax.tree.map(np.testing.assert_array_equal, params2, params)
  for name in ('count', 'mean', 'summed_variance', 'std'):
    jax.tree.map(np.testing.assert_array_equal, getattr(norm2, name),
                 getattr(normalizer, name))


def test_mlp_init_is_lecun_uniform():
  net = pnets.make_ppo_networks(23, 5)
  before = {k: v.clone() for k, v in net.state_dict().items()}
  net.init(torch.Generator().manual_seed(0))
  again = pnets.make_ppo_networks(23, 5).init(torch.Generator().manual_seed(0))
  jparams = jnets.make_ppo_networks(23, 5).init(jax.random.PRNGKey(0))
  for name, mlp in (('policy', net.policy), ('value', net.value)):
    assert len(mlp.layers) == len(jparams[name])
    for layer, jl in zip(mlp.layers, jparams[name]):
      bound = np.sqrt(3.0 / layer.in_features)
      w = layer.weight.detach().numpy()
      assert w.shape == np.asarray(jl['w']).T.shape
      assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
      # U(-a, a) has std a/√3; the JAX draw is held to the same bounds
      assert abs(w.std() / (bound / np.sqrt(3)) - 1) < 0.2
      assert np.abs(np.asarray(jl['w'])).max() <= bound
      assert (layer.bias == 0).all()
  assert all(torch.equal(v, again.state_dict()[k])
             for k, v in net.state_dict().items())
  assert (before['value.layers.0.bias'] != 0).any()  # nn.Linear's own init


@pytest.mark.parametrize('update', ['torch_step', 'adam_step_'])
@pytest.mark.parametrize('grad_scale', [0.01, 10.0])
def test_clip_and_adam_match_optax(grad_scale, update):
  """Three steps on the same gradients; at scale 10 the global norm is
  above 1 and the clip acts, at 0.01 it does not.  The update is
  ``torch.optim.Adam.step()`` (SAC, the tuning loop) or ``ppo.adam_step_``
  (PPO's minibatch step, eager and replayed from a CUDA graph)."""
  rng = np.random.default_rng(4)
  params = {'a': f32(rng, 4, 3), 'b': f32(rng, 3)}
  grads = [{k: f32(rng, *v.shape, scale=grad_scale) for k, v in
            params.items()} for _ in range(3)]
  opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))
  jp, state = params, opt.init(params)
  tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
        for k, v in params.items()}
  topt = pppo.make_optimizer(tp.values(), 1e-4)
  for g in grads:
    clipped, _ = optax.clip_by_global_norm(1.0).update(g, None)
    updates, state = opt.update(g, state, jp)
    jp = optax.apply_updates(jp, updates)
    for k, p in tp.items():
      p.grad = torch.from_numpy(g[k].copy())
    pppo.clip_by_global_norm_([p.grad for p in tp.values()], 1.0)
    for k, p in tp.items():
      np.testing.assert_allclose(p.grad.numpy(), np.asarray(clipped[k]),
                                 rtol=1e-6, atol=1e-9)
    topt.step() if update == 'torch_step' else pppo.adam_step_(topt)
    for k, p in tp.items():
      np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                 rtol=1e-6, atol=1e-9)
  moved = max(np.abs(np.asarray(jp[k]) - params[k]).max() for k in params)
  assert moved > 2e-4  # three steps of about lr each


def test_ppo_config_matches_jax():
  pcfg = pconfigs.ppo_config('AirbotCubePushTrain')
  jcfg = jconfigs.ppo_config('AirbotCubePushTrain').to_dict()
  jcfg['network_factory'] = {k: list(v) for k, v in
                             jcfg['network_factory'].items()}
  assert pcfg == jcfg
  with pytest.raises(ValueError, match='Unsupported env'):
    pconfigs.ppo_config('Go2NoSuchTask')


# A scripted episode for the eval wrapper: step t gives reward, done, the
# episode's step count and one metric from row t of each table.  Env 0 is
# done at step 1 and again at step 4 (after its first done nothing more may
# be summed), env 1 never, env 2 at the last step, env 3 at step 3 after a
# NaN reward at step 2 (its episode is kept out of the evaluator's mean).
EPISODE = 6


def scripted_tables():
  rng = np.random.default_rng(9)
  reward = f32(rng, EPISODE, B)
  reward[2, 3] = np.nan
  done = np.zeros((EPISODE, B), np.float32)
  done[1, 0] = done[4, 0] = done[5, 2] = done[3, 3] = 1.0
  steps = rng.integers(1, 50, size=(EPISODE, B)).astype(np.float32)
  return dict(reward=reward, done=done, steps=steps, m=f32(rng, EPISODE, B))


class JaxScripted:

  def __init__(self):
    self.tab = {k: jnp.asarray(v) for k, v in scripted_tables().items()}

  def reset(self, rng):
    z = jnp.zeros(B)
    return jcore.State(data=None, obs=jnp.zeros((B, 2)), reward=z, done=z,
                       metrics={'m': z}, info={'t': jnp.int32(0), 'steps': z})

  def step(self, state, action):
    t, tab = state.info['t'], self.tab
    return state.replace(reward=tab['reward'][t], done=tab['done'][t],
                         metrics={'m': tab['m'][t]},
                         info=dict(state.info, t=t + 1, steps=tab['steps'][t]))


class TorchScripted:

  def __init__(self):
    self.tab = {k: torch.from_numpy(v) for k, v in scripted_tables().items()}

  def reset(self, generator):
    z = torch.zeros(B)
    return pcore.State(data=None, obs=torch.zeros(B, 2), reward=z, done=z,
                       metrics={'m': z}, info={'t': 0, 'steps': z})

  def step(self, state, action):
    t, tab = state.info['t'], self.tab
    return state.replace(reward=tab['reward'][t], done=tab['done'][t],
                         metrics={'m': tab['m'][t]},
                         info=dict(state.info, t=t + 1, steps=tab['steps'][t]))


def test_eval_wrapper_and_evaluator_match_jax():
  jenv = jwrappers.EvalWrapper(JaxScripted())
  penv = pwrappers.EvalWrapper(TorchScripted())
  js, ps = jenv.reset(jax.random.PRNGKey(0)), penv.reset(None)
  for _ in range(EPISODE):
    js = jenv.step(js, jnp.zeros((B, 1)))
    ps = penv.step(ps, torch.zeros(B, 1))
    jm, pm = js.info['eval_metrics'], ps.info['eval_metrics']
    assert set(pm.episode_metrics) == set(jm.episode_metrics) == {'m',
                                                                 'reward'}
    for p, j in [(pm.episode_metrics[k], jm.episode_metrics[k])
                 for k in jm.episode_metrics] + [
                     (pm.active_episodes, jm.active_episodes),
                     (pm.episode_steps, jm.episode_steps)]:
      np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-6)
  np.testing.assert_array_equal(pm.active_episodes.numpy(), [0, 1, 0, 0])

  common = dict(num_eval_envs=B, episode_length=EPISODE, action_repeat=1)
  jev = jacting.Evaluator(
      jwrappers.EvalWrapper(JaxScripted()),
      lambda params: lambda obs, key: (jnp.zeros((B, 1)), {}),
      key=jax.random.PRNGKey(0), **common).run_evaluation(None, {})
  pev = pacting.Evaluator(
      pwrappers.EvalWrapper(TorchScripted()),
      lambda params: lambda obs, gen: (torch.zeros(B, 1), {}),
      generator=torch.Generator().manual_seed(0), **common
  ).run_evaluation(None, {})
  assert pev['eval/nan_episodes'] == jev['eval/nan_episodes'] == 1
  for k in ('eval/episode_reward', 'eval/episode_reward_std',
            'eval/avg_episode_length'):
    np.testing.assert_allclose(pev[k], jev[k], rtol=1e-6)
