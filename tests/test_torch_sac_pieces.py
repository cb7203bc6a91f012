"""The port's SAC pieces against the JAX package's, on the CPU.

Inputs come from numpy seeds; JAX's parameters and JAX's standard-normal
draws (``jax.random.normal`` of the keys the JAX losses take) are handed
to the port.  Tolerances:
  - the replay ring, its gather, size and position: exact;
  - the networks on JAX parameters: rtol 1e-6 (the same fp32 MLP, another
    summation order); the JAX-layout round trip: exact;
  - the three losses: rtol 1e-5; their gradients with respect to their own
    parameters: within 1e-5 of each tensor's largest entry.  Where the two
    fp32 results part by more, each must lie within that tolerance of the
    port's float64 evaluation (the RSR term's KL gain cancels in fp32);
  - two SGD steps (three gradients at the old parameters, three Adams,
    the τ update) against the JAX ``sgd_step`` arithmetic assembled from
    ``make_losses`` and ``optax.adam``: every parameter within 1e-6 (a
    hundredth of the learning rate); the same test parts a sequential
    update (α, then the critics, then the actor at the new values) from
    JAX by more than that;
  - ``sac_config``: equal, key by key, for Airbot and every Go2 task;
  - ``SelectObservationWrapper`` on the Go2 joystick at B 2 from the JAX
    reset: the reset's obs against JAX's wrapper, rtol 1e-5; a step equal
    to the inner env's with the entry selected;
  - ``sac_networks.make_policy`` on ``logs/cube_sac_500k_r5`` against the
    deterministic policy of the JAX ``sac.train``: rtol 1e-5.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.envs import core as jcore
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.rsr import loss as jloss
from rsr_mjx_tpu.train import configs as jconfigs
from rsr_mjx_tpu.train import losses as jlosses
from rsr_mjx_tpu.train import replay_buffer as jrb
from rsr_mjx_tpu.train import running_statistics as jrs
from rsr_mjx_tpu.train import sac as jsac
from rsr_mjx_tpu.train import sac_losses as jsl
from rsr_mjx_tpu.train import sac_networks as jsn
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.rsr import loss as ploss
from rsr_mjx_tpu_torch.train import configs as pconfigs
from rsr_mjx_tpu_torch.train import losses as plosses
from rsr_mjx_tpu_torch.train import ppo as pppo
from rsr_mjx_tpu_torch.train import replay_buffer as prb
from rsr_mjx_tpu_torch.train import running_statistics as prs
from rsr_mjx_tpu_torch.train import sac as psac
from rsr_mjx_tpu_torch.train import sac_losses as psl
from rsr_mjx_tpu_torch.train import sac_networks as psn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAC_PARAMS = os.path.join(ROOT, 'logs', 'cube_sac_500k_r5', 'final_params.pkl')
GO2_TASKS = ('Go2JoystickFlatTerrain', 'Go2JoystickRoughTerrain', 'Go2Getup',
             'Go2Handstand', 'Go2Footstand')
OBS, ACT, N, HIDDEN = 7, 3, 6, (16, 8)
LOSS = dict(reward_scaling=0.1, discounting=0.96, action_size=ACT)


def t(x, dtype=torch.float32):
  return torch.tensor(np.asarray(x), dtype=dtype)


def _transitions(seed, jax_side):
  """A seeded batch of N transitions, truncation set in two rows: a JAX
  ``Transition`` of jnp arrays, or the port's of float32 tensors."""
  rng = np.random.default_rng(seed)
  f32 = lambda *s: rng.normal(size=s).astype(np.float32)
  obs, nobs = f32(N, OBS), f32(N, OBS)
  act = np.tanh(f32(N, ACT))
  reward = f32(N)
  discount = np.array([1, 1, 0, 1, 1, 1], np.float32)
  trunc = np.array([0, 1, 0, 0, 1, 0], np.float32)
  if jax_side:
    a = jnp.asarray
    return jlosses.Transition(a(obs), a(act), a(reward), a(discount), a(nobs),
                              {'policy_extras': {},
                               'state_extras': {'truncation': a(trunc)}})
  return plosses.Transition(t(obs), t(act), t(reward), t(discount), t(nobs),
                            {'policy_extras': {},
                             'state_extras': {'truncation': t(trunc)}})


def _to_dtype(tree, dtype):
  return pwrappers.tree_map(lambda x: x.to(dtype), tree)


def _jax_normalizer(seed):
  rng = np.random.default_rng(seed)
  return jrs.update(jrs.init_state(OBS),
                    jnp.asarray(rng.normal(2.0, 3.0, (40, OBS)), jnp.float32))


def _port_normalizer(jnorm, dtype=torch.float32):
  return prs.map_state(lambda a: t(a, dtype), jnorm)


def _rsr_sets():
  """Three transition sets for the penalty, its gate open (bandwidth 2.0;
  tests/test_torch_rsr.py's 'gradient flows' case at this width)."""
  rng = np.random.RandomState(1)
  real = rng.randn(12, 2 * OBS + ACT).astype(np.float32)
  return [real, real + np.float32(0.1), real + np.float32(0.05)]


def _jax_net_and_params(seed=0):
  jnet = jsn.make_sac_networks(OBS, ACT, HIDDEN)
  return jnet, jax.device_get(jnet.init(jax.random.PRNGKey(seed)))


def _port_net(params, dtype=torch.float32):
  net = psn.make_sac_networks(OBS, ACT, HIDDEN)
  net.load_state_dict(psn.sac_params_from_numpy(params, device='cpu'))
  return net.to(dtype)


def _noises(keys, n=N):
  return [np.asarray(jax.random.normal(k, (n, ACT))) for k in keys]


# ---------------------------------------------------------------------------
# replay buffer
# ---------------------------------------------------------------------------


def test_replay_buffer_ring_matches_jax():
  rng = np.random.default_rng(0)
  dummy = {'obs': np.zeros(3, np.float32), 'r': np.zeros((), np.float32),
           'extras': {'truncation': np.zeros((), np.float32)}}
  jstate = jrb.init(10, jax.tree.map(jnp.asarray, dummy),
                    jax.random.PRNGKey(0))
  pstate = prb.init(10, jax.tree.map(t, dummy))
  assert pstate.capacity == 10
  for b in (4, 4, 4, 3, 7):  # the third batch straddles the end
    batch = {'obs': rng.normal(size=(b, 3)).astype(np.float32),
             'r': rng.normal(size=b).astype(np.float32),
             'extras': {'truncation': (rng.random(b) < 0.5)
                        .astype(np.float32)}}
    jstate = jrb.insert(jstate, jax.tree.map(jnp.asarray, batch))
    pstate = prb.insert(pstate, jax.tree.map(t, batch))
    assert (pstate.insert_position, pstate.size) == (
        int(jstate.insert_position), int(jstate.size))
    for k in ('obs', 'r'):
      np.testing.assert_array_equal(pstate.data[k].numpy(),
                                    np.asarray(jstate.data[k]))
    np.testing.assert_array_equal(
        pstate.data['extras']['truncation'].numpy(),
        np.asarray(jstate.data['extras']['truncation']))
  assert (pstate.insert_position, pstate.size) == (2, 10)
  idx = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (16,), 0, 10))
  got = prb.gather(pstate, torch.from_numpy(np.array(idx)))
  np.testing.assert_array_equal(got['obs'].numpy(),
                                np.asarray(jstate.data['obs'])[idx])
  # sample draws within the filled region from its generator
  part = prb.insert(prb.init(10, {'r': t(0.0)}), {'r': t([5.0, 6.0, 7.0])})
  drawn = prb.sample(part, 64, torch.Generator().manual_seed(0))['r']
  assert set(drawn.tolist()) == {5.0, 6.0, 7.0}


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------


def test_sac_networks_match_jax_and_round_trip():
  jnet, params = _jax_net_and_params()
  net = _port_net(params)
  back = psn.sac_params_to_numpy(net)
  for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
    np.testing.assert_array_equal(a, b)
  assert jax.tree.structure(back) == jax.tree.structure(params)
  rng = np.random.default_rng(1)
  obs = rng.normal(size=(5, OBS)).astype(np.float32)
  act = np.tanh(rng.normal(size=(5, ACT))).astype(np.float32)
  with torch.no_grad():
    logits = net.policy_logits(t(obs)).numpy()
    q = net.q_values(t(obs), t(act)).numpy()
  np.testing.assert_allclose(logits, jnet.policy_logits(params['policy'], obs),
                             rtol=1e-6, atol=1e-7)
  jq = np.asarray(jnet.q_values(params['q'], obs, act))
  assert q.shape == jq.shape == (5, 2)
  np.testing.assert_allclose(q, jq, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _grads_by_key(net, grads, params):
  """{'policy' | 'q': JAX-layout numpy} of a tuple of gradients of
  ``params`` (a list of the net's parameters)."""
  names = {id(p): k for k, p in net.named_parameters()}
  return psn.sac_params_to_numpy({names[id(p)]: g
                                  for p, g in zip(params, grads)})


def _close(port, jaxv, ref64, rtol, scale=None):
  """|port − jax| within rtol (of |jax|, or of ``scale``), or else both
  within it of the port's float64 value."""
  port, jaxv, ref64 = (np.asarray(x, np.float64) for x in (port, jaxv, ref64))
  tol = rtol * (np.abs(jaxv) if scale is None else scale) + 1e-12
  if np.all(np.abs(port - jaxv) <= tol):
    return
  for who, v in (('port', port), ('jax', jaxv)):
    err = np.abs(v - ref64).max()
    assert np.all(np.abs(v - ref64) <= tol), (who, err, tol)


def _port_losses(params, jnorm, normalize, past, dtype, log_alpha, noise):
  """The three port losses and their gradients in ``dtype``."""
  net = _port_net(params, dtype)
  target = _port_net(jax.tree.map(lambda w: w * 0.9, params), dtype).q
  data = None
  if past is not None:
    data = ploss.build_rsr_data(*(t(x, dtype) for x in past[0]),
                                bandwidth=2.0, grid=past[1])
  alpha_loss, critic_loss, actor_loss = psl.make_losses(
      net, **LOSS, normalize_fn=prs.normalize if normalize else None,
      past_data=data, rsr_loss_scale=1.0)
  norm = _port_normalizer(jnorm, dtype)
  tr = _to_dtype(_transitions(5, False), dtype)
  la = torch.tensor(log_alpha, dtype=dtype, requires_grad=True)
  noise = [t(x, dtype) for x in noise]
  alpha = torch.exp(la.detach())
  qp, pp = list(net.q.parameters()), list(net.policy.parameters())
  out = {}
  with torch.enable_grad():
    v = alpha_loss(la, norm, tr, noise[0])
    out['alpha'] = (v.item(), torch.autograd.grad(v, [la])[0].numpy())
    v = critic_loss(norm, target, alpha, tr, noise[1])
    out['critic'] = (v.item(), _grads_by_key(
        net, torch.autograd.grad(v, qp), qp)['q'])
    v = actor_loss(norm, alpha, tr, noise[2])
    out['actor'] = (v.item(), _grads_by_key(
        net, torch.autograd.grad(v, pp), pp)['policy'])
  # each gradient reached only its own parameters
  assert all(p.grad is None for p in net.parameters()) and not la.grad
  return out


@pytest.mark.parametrize('normalize', [True, False])
@pytest.mark.parametrize('rsr', [False, True])
def test_sac_losses_and_gradients_match_jax(normalize, rsr):
  jnet, params = _jax_net_and_params()
  target_params = jax.tree.map(lambda w: w * 0.9, params)
  jnorm = _jax_normalizer(2)
  past = None
  jdata = None
  if rsr:
    sets = _rsr_sets()
    jdata = jloss.build_rsr_data(*sets, bandwidth=2.0)
    past = (sets, np.asarray(jdata.grid))
  alpha_loss, critic_loss, actor_loss = jsl.make_losses(
      jnet, **LOSS, normalize_fn=jrs.normalize if normalize
      else (lambda s, o: o), past_data=jdata, rsr_loss_scale=1.0)
  keys = jax.random.split(jax.random.PRNGKey(7), 3)
  tr = _transitions(5, True)
  log_alpha = jnp.float32(0.3)
  alpha = jnp.exp(log_alpha)
  jout = {
      'alpha': jax.value_and_grad(alpha_loss)(
          log_alpha, params['policy'], jnorm, tr, keys[0]),
      'critic': jax.value_and_grad(critic_loss)(
          params['q'], params['policy'], jnorm, target_params['q'], alpha,
          tr, keys[1]),
      'actor': jax.value_and_grad(actor_loss)(
          params['policy'], jnorm, params['q'], alpha, tr, keys[2]),
  }
  noise = _noises(keys)
  port = _port_losses(params, jnorm, normalize, past, torch.float32, 0.3,
                      noise)
  ref = _port_losses(params, jnorm, normalize, past, torch.float64, 0.3,
                     noise)
  if rsr:  # the penalty is in the actor loss
    no_rsr = _port_losses(params, jnorm, normalize, None, torch.float64, 0.3,
                          noise)
    assert abs(ref['actor'][0] - no_rsr['actor'][0]) > 1e-6
  for name in ('alpha', 'critic', 'actor'):
    jv, jg = jout[name]
    pv, pg = port[name]
    _close(pv, float(jv), ref[name][0], 1e-5)
    for p, j, r in zip(jax.tree.leaves(pg), jax.tree.leaves(jax.device_get(jg)),
                       jax.tree.leaves(ref[name][1])):
      _close(p, j, r, 1e-5, scale=np.abs(r).max())


# ---------------------------------------------------------------------------
# the SGD step
# ---------------------------------------------------------------------------

LR = 1e-4
TAU = 0.005


def _jax_sgd(jnet, params, jnorm, batches, keys):
  """The JAX ``sac.sgd_step`` arithmetic, as sac.py:234-296 assembles it:
  each of ``len(batches)`` steps takes the three gradients at the old
  parameters, then the three optax Adams, then the τ update."""
  alpha_loss, critic_loss, actor_loss = jsl.make_losses(
      jnet, **LOSS, normalize_fn=jrs.normalize)
  aopt, popt, qopt = optax.adam(3e-4), optax.adam(LR), optax.adam(LR)
  la, pol, q, tq = jnp.float32(0.0), params['policy'], params['q'], params['q']
  sa, sp, sq = aopt.init(la), popt.init(pol), qopt.init(q)
  for tr, (ka, kc, kp) in zip(batches, keys):
    al, ga = jax.value_and_grad(alpha_loss)(la, pol, jnorm, tr, ka)
    alpha = jnp.exp(la)
    cl, gc = jax.value_and_grad(critic_loss)(q, pol, jnorm, tq, alpha, tr, kc)
    pl, gp = jax.value_and_grad(actor_loss)(pol, jnorm, q, alpha, tr, kp)
    u, sa = aopt.update(ga, sa)
    la = optax.apply_updates(la, u)
    u, sq = qopt.update(gc, sq)
    q = optax.apply_updates(q, u)
    u, sp = popt.update(gp, sp)
    pol = optax.apply_updates(pol, u)
    tq = jax.tree.map(lambda x, y: x * (1 - TAU) + y * TAU, tq, q)
  return jax.device_get((la, pol, q, tq))


def _sequential_sgd(ts, losses, tr, noise):
  """A different algorithm: α updated first, the critics next with the new
  α, the actor last against the new critics and α."""
  alpha_loss, critic_loss, actor_loss = losses
  net = ts.networks
  for opt, params, make in (
      (ts.alpha_optimizer, [ts.log_alpha],
       lambda: alpha_loss(ts.log_alpha, ts.normalizer_params, tr, noise[0])),
      (ts.q_optimizer, list(net.q.parameters()),
       lambda: critic_loss(ts.normalizer_params, ts.target_q,
                           torch.exp(ts.log_alpha.detach()), tr, noise[1])),
      (ts.policy_optimizer, list(net.policy.parameters()),
       lambda: actor_loss(ts.normalizer_params,
                          torch.exp(ts.log_alpha.detach()), tr, noise[2]))):
    with torch.enable_grad():
      grads = torch.autograd.grad(make(), params)
    for p, g in zip(params, grads):
      p.grad = g
    opt.step()
  with torch.no_grad():
    for a, b in zip(ts.target_q.parameters(), net.q.parameters()):
      a.copy_(a * (1 - TAU) + b * TAU)


@pytest.mark.parametrize('variant', ['sgd_step', 'sequential'])
def test_sgd_step_matches_jax(variant):
  import copy

  jnet, params = _jax_net_and_params(4)
  jnorm = _jax_normalizer(3)
  keys = [jax.random.split(jax.random.PRNGKey(20 + i), 3) for i in range(2)]
  batches = [_transitions(10 + i, True) for i in range(2)]
  jla, jpol, jq, jtq = _jax_sgd(jnet, params, jnorm, batches, keys)

  net = _port_net(params)
  log_alpha = torch.zeros((), requires_grad=True)
  ts = psac.TrainingState(
      networks=net, target_q=copy.deepcopy(net.q).requires_grad_(False),
      log_alpha=log_alpha,
      policy_optimizer=pppo.make_optimizer(net.policy.parameters(), LR),
      q_optimizer=pppo.make_optimizer(net.q.parameters(), LR),
      alpha_optimizer=pppo.make_optimizer([log_alpha], 3e-4),
      normalizer_params=_port_normalizer(jnorm))
  losses = psl.make_losses(net, **LOSS, normalize_fn=prs.normalize)
  metrics = []
  for i in range(2):
    tr = _transitions(10 + i, False)
    noise = [t(x) for x in _noises(keys[i])]
    if variant == 'sgd_step':
      metrics.append(psac.sgd_step(ts, losses, tr, noise, TAU))
    else:
      _sequential_sgd(ts, losses, tr, noise)
  got = psn.sac_params_to_numpy(net)
  target = psn.sac_params_to_numpy({f'q.{k}': v for k, v in
                                    ts.target_q.state_dict().items()})['q']
  pairs = ([(ts.log_alpha.detach().numpy(), jla)]
           + list(zip(jax.tree.leaves(got['policy']), jax.tree.leaves(jpol)))
           + list(zip(jax.tree.leaves(got['q']), jax.tree.leaves(jq)))
           + list(zip(jax.tree.leaves(target), jax.tree.leaves(jtq))))
  worst = max(np.abs(np.asarray(a) - np.asarray(b)).max() for a, b in pairs)
  moved = max(np.abs(a - b).max() for a, b in zip(
      jax.tree.leaves(got['policy']), jax.tree.leaves(params['policy'])))
  assert moved > LR  # two Adam steps of at most lr each moved the policy
  if variant == 'sgd_step':
    assert worst <= 1e-6, worst
    assert ts.gradient_steps == 2
    assert set(metrics[-1]) == {'critic_loss', 'actor_loss', 'alpha_loss',
                                'alpha'}
    np.testing.assert_allclose(metrics[-1]['alpha'].item(), np.exp(jla),
                               rtol=1e-6)
  else:
    assert worst > 1e-6, worst  # the test tells the two algorithms apart


# ---------------------------------------------------------------------------
# configs, wrapper, serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('task', ('AirbotCubePush',) + GO2_TASKS)
def test_sac_config_matches_jax(task):
  jcfg = jconfigs.sac_config(task).to_dict()
  jcfg['network_factory'] = {
      k: list(v) if isinstance(v, tuple) else v
      for k, v in jcfg['network_factory'].items()}
  assert pconfigs.sac_config(task) == jcfg


GO2_INIT_KEYS = ('command', 'steps_until_next_cmd', 'steps_until_next_pert',
                 'pert_duration_seconds', 'pert_duration', 'pert_mag')


def test_select_observation_wrapper_on_go2_matches_jax(monkeypatch):
  """From the JAX reset of PRNGKey(1), noise off (as
  tests/test_torch_go2_slice.py): the reset's selected obs against JAX's,
  rtol 1e-5; a step equal to the inner env's step with the entry selected
  (the inner step against JAX's is tests/test_torch_go2_slice.py's)."""
  B, quiet = 2, {'noise_config.level': 0.0}
  jenv = jwrappers.SelectObservationWrapper(
      jenvs.load('Go2JoystickFlatTerrain', config_overrides=quiet), 'state')
  assert jenv.observation_size == 48
  jstate = jax.jit(jax.vmap(jenv.reset))(
      jax.random.split(jax.random.PRNGKey(1), B))
  far = jnp.full((B,), 50, jnp.int32)  # no command change in the step
  jstate.info['steps_until_next_cmd'] = far
  action = np.random.default_rng(0).uniform(-0.3, 0.3, (B, 12)).astype(
      np.float32)

  base = penvs.load('Go2JoystickFlatTerrain', device='cpu',
                    config_overrides=quiet)
  init = dict(qpos=t(jstate.data.qpos), qvel=t(jstate.data.qvel),
              **{k: torch.from_numpy(np.array(jstate.info[k]))
                 for k in GO2_INIT_KEYS})
  monkeypatch.setattr(base, 'sample_init', lambda generator, batch: init)
  penv = pwrappers.SelectObservationWrapper(base, 'state')
  assert penv.observation_size == 48
  pstate = penv.reset(torch.Generator().manual_seed(0), B)
  assert pstate.obs.shape == (B, 48)
  np.testing.assert_allclose(pstate.obs.numpy(), np.asarray(jstate.obs),
                             rtol=1e-5, atol=1e-5)
  with torch.no_grad():
    pnext = penv.step(pstate, t(action))
    inner = base.step(pstate, t(action))  # the step reads data and info
  assert pnext.obs.shape == (B, 48)
  np.testing.assert_array_equal(pnext.obs.numpy(),
                                inner.obs['state'].numpy())
  np.testing.assert_array_equal(pnext.reward.numpy(), inner.reward.numpy())


class _Flat23(jcore.Env):
  """A JAX env of cube-push's widths (obs 23, action 5) that stands still:
  enough to build the JAX ``sac.train``'s policy."""

  @property
  def model(self):
    return None

  @property
  def observation_size(self):
    return 23

  @property
  def action_size(self):
    return 5

  @property
  def ctrl_dt(self):
    return 0.1

  @property
  def sim_dt(self):
    return 0.1

  def reset(self, rng):
    z = jnp.zeros(())
    return jcore.State(data=jnp.zeros(23), obs=jnp.zeros(23), reward=z,
                       done=z, metrics={}, info={})

  def step(self, state, action):
    return state


def test_serving_a_jax_sac_pickle_matches_the_jax_policy():
  normalizer, params = psac.load_params(SAC_PARAMS)
  assert [layer['w'].shape for layer in params] == [(23, 256), (256, 256),
                                                   (256, 10)]
  make_policy, _, _ = jsac.train(
      _Flat23(), num_timesteps=0, episode_length=1, num_envs=8,
      num_eval_envs=8, num_evals=0, normalize_observations=True,
      max_replay_size=8,
      network_factory=functools.partial(jsn.make_sac_networks,
                                        hidden_layer_sizes=(256, 256)))
  rng = np.random.default_rng(2)
  obs = (normalizer.mean + normalizer.std * rng.normal(size=(32, 23))).astype(
      np.float32)
  jact = np.asarray(make_policy(jsac.load_params(SAC_PARAMS),
                                deterministic=True)(
      jnp.asarray(obs), jax.random.PRNGKey(0))[0])
  with torch.no_grad():
    act = psn.make_policy(normalizer, params, device='cpu')(t(obs)).numpy()
  assert act.shape == (32, 5) and np.abs(jact).max() > 0.1
  np.testing.assert_allclose(act, jact, rtol=1e-5, atol=1e-6)
