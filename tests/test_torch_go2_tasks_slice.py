"""The port's getup, handstand and footstand envs against the JAX package.

1. The trained policies (logs/go2_getup_5M_r5 and logs/go2_handstand_5M_r5,
   state 42 and 45 → 512 → 256 → 128 → 24, a normalizer over the dict
   observation), carried into the port by ``networks.make_policy(
   obs_key='state')``, against JAX's ``make_policy(deterministic=True)``;
   rtol 1e-5 (the same fp32 MLP, another summation order).
2. The getup settle: JAX's wrapped reset of 3 envs from the home branch
   (``drop_from_height_prob`` 0; a random drop can start with capsules
   interpenetrating, where fp32 orders part within a step: the one-substep
   test of tests/test_torch_go2_tasks.py takes such states), its draws
   handed to the port's ``reset_to``, which settles 125 substeps as JAX's
   reset does.  The settled state and the first observation within 1e-3
   (125 substeps of fp32 contact).
3. Three control steps of each task from JAX's reset state, with the
   trained policy (footstand has none: seeded actions), the observation
   noise off: ``state``, ``privileged_state``, reward, done and every
   ``reward/*`` term within the repo's post-solve tolerance 1e-2
   (tests/test_fwd_fused.py), done exactly; handstand and footstand
   observations within 1e-5 of their scale at reset (one forward).  Then the terms
   again, each recomputed by the JAX env's own reward function on the
   port's post-step data and pre-step info, within 1e-5: the parity of
   tests/test_reference_parity.py, without the physics in between.
4. The port's reset draws: the drop branch's share, pose and joint ranges
   (getup); the xy offset, yaw and velocity ranges (handstand).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu import physics as jphysics
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.train import configs
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import ppo, running_statistics, sac
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.train import networks as pnets
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3
NO_NOISE = {'noise_config.level': 0.0}
PARAMS = {
    'Go2Getup': os.path.join(ROOT, 'logs', 'go2_getup_5M_r5',
                             'final_params.pkl'),
    'Go2Handstand': os.path.join(ROOT, 'logs', 'go2_handstand_5M_r5',
                                 'final_params.pkl'),
}
OBS = {'Go2Getup': (42, 91), 'Go2Handstand': (45, 94),
       'Go2Footstand': (45, 94)}


def _jax_policy(name):
  params = sac.load_params(PARAMS[name])
  nf = configs.ppo_config(name).network_factory
  n_state, n_priv = OBS[name]
  net = jnets.make_ppo_networks(
      {'state': (n_state,), 'privileged_state': (n_priv,)}, 12,
      policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes),
      policy_obs_key=nf.policy_obs_key, value_obs_key=nf.value_obs_key)
  policy = ppo._make_policy_factory(net, running_statistics.normalize)(
      params, deterministic=True)
  return jax.jit(lambda obs: policy(obs, jax.random.PRNGKey(0))[0])


def _port_policy(name):
  normalizer, params = pnets.load_ppo_params(PARAMS[name])
  return pnets.make_policy(normalizer, params, device='cpu',
                           obs_key='state', value_obs_key='privileged_state')


@pytest.mark.parametrize('name', sorted(PARAMS))
def test_trained_policy_matches_jax(name):
  normalizer, params = pnets.load_ppo_params(PARAMS[name])
  n_state, n_priv = OBS[name]
  assert [l['w'].shape for l in params['policy']] == [
      (n_state, 512), (512, 256), (256, 128), (128, 24)]
  assert normalizer.mean['privileged_state'].shape == (n_priv,)
  rng = np.random.default_rng(0)
  obs = {k: (normalizer.mean[k] + normalizer.std[k]
             * rng.normal(size=(64,) + normalizer.mean[k].shape)
             ).astype(np.float32) for k in ('state', 'privileged_state')}
  aj = np.asarray(_jax_policy(name)(obs))
  with torch.no_grad():
    ap = _port_policy(name)({k: torch.from_numpy(v)
                             for k, v in obs.items()}).numpy()
  assert ap.shape == (64, 12) and np.abs(ap).max() <= 1.0
  np.testing.assert_allclose(ap, aj, rtol=1e-5, atol=1e-6)


def _jax_getup_draws(env, key):
  """The draws of the JAX getup reset of ``key`` (getup.py:115-130), before
  its settle."""
  rng, key1, key2 = jax.random.split(key, 3)
  qpos = jnp.where(
      jax.random.bernoulli(key1, env._config.drop_from_height_prob),
      env._get_random_qpos(key2), env._init_q)
  rng, key = jax.random.split(rng)
  qvel = jnp.zeros(env.model.nv).at[0:6].set(
      jax.random.uniform(key, (6,), minval=-0.5, maxval=0.5))
  return qpos, qvel


def _rollout(name):
  """JAX's wrapped reset handed to the port, then 3 control steps in both;
  returns the states after the reset and after each step, and the port's
  pre-step info and action of each step."""
  over = dict(NO_NOISE)
  if name == 'Go2Getup':
    over['drop_from_height_prob'] = 0.0
  keys = jax.random.split(jax.random.PRNGKey(1), B)
  jbase = jenvs.load(name, config_overrides=over)
  jenv = jwrappers.wrap_for_training(jbase, episode_length=100)
  jstate = jax.jit(jenv.reset)(keys)
  if name == 'Go2Getup':
    qpos, qvel = jax.vmap(lambda k: _jax_getup_draws(jbase, k))(keys)
  else:
    qpos, qvel = jstate.data.qpos, jstate.data.qvel
  t = lambda x: torch.from_numpy(np.array(x))
  init = dict(qpos=t(qpos), qvel=t(qvel))
  base = penvs.load(name, device='cpu', config_overrides=over)
  base.sample_init = lambda generator, batch: init
  penv = pwrappers.wrap_for_training(base, episode_length=100, num_envs=B)
  plk.LAUNCHES.update(dict.fromkeys(plk.LAUNCHES, 0))
  pstate = penv.reset(torch.Generator().manual_seed(0))
  if name in PARAMS:
    jpolicy, ppolicy = _jax_policy(name), _port_policy(name)
  else:  # no trained footstand policy: seeded actions
    acts = np.random.default_rng(2).uniform(-0.5, 0.5, (3, B, 12)).astype(
        np.float32)
    jpolicy = lambda obs, _a=iter(acts): next(_a)
    ppolicy = lambda obs, _a=iter(acts): torch.from_numpy(next(_a))
  states = [(jax.tree.map(np.asarray, jstate), pstate)]
  steps = []
  jstep = jax.jit(jenv.step)
  for _ in range(3):
    jstate = jstep(jstate, jnp.asarray(jpolicy(jstate.obs)))
    with torch.no_grad():
      action = ppolicy(pstate.obs)
      info = dict(pstate.info)
      pstate = penv.step(pstate, action)
    steps.append((info, action))
    states.append((jax.tree.map(np.asarray, jstate), pstate))
  return dict(jbase=jbase, base=base, states=states, steps=steps)


@pytest.fixture(scope='module', params=['Go2Getup', 'Go2Handstand',
                                        'Go2Footstand'])
def rollout(request):
  return _rollout(request.param)


def _obs_close(p, j, tol):
  """Each observation within ``tol`` of its scale (the privileged state
  holds the accelerometer and actuator forces, of tens)."""
  for k in ('state', 'privileged_state'):
    scale = max(1.0, float(np.abs(j[k]).max()))
    np.testing.assert_allclose(p[k].numpy(), j[k], rtol=tol,
                               atol=tol * scale, err_msg=k)


def test_reset_matches_jax(rollout):
  """Handstand and footstand: the reset itself (one forward).  Getup:
  the port's 125-substep settle from JAX's draws, to JAX's settled
  state."""
  js, ps = rollout['states'][0]
  getup = rollout['base'].__class__.__name__ == 'Getup'
  tol = 1e-3 if getup else 1e-5
  for f in ('qpos', 'qvel', 'ctrl', 'xpos', 'sensordata', 'actuator_force'):
    scale = max(1.0, float(np.abs(getattr(js.data, f)).max()))
    np.testing.assert_allclose(getattr(ps.data, f).numpy(),
                               getattr(js.data, f), rtol=0,
                               atol=tol * scale, err_msg=f)
  assert float(ps.data.time.abs().max()) == 0.0
  _obs_close(ps.obs, js.obs, tol)
  _obs_close(ps.info['first_obs'], js.info['first_obs'], tol)
  assert set(ps.metrics) == set(js.metrics)
  for k, v in js.info.items():
    if k in ('rng', 'first_info', 'first_data', 'first_obs'):
      continue
    pv = ps.info[k]
    assert tuple(pv.shape) == tuple(v.shape), k
    assert str(pv.dtype).split('.')[-1] == str(v.dtype), k
  if getup:
    # the settle ran on the CPU path: one K1 and one K4 call a substep
    # (the reset's forward and 125 substeps), none of them launched
    assert not any(plk.LAUNCHES.values())
    # the robot settles on its feet: gravity nearly straight down in the
    # imu frame
    gravity = rollout['base'].get_gravity(ps.data)
    assert (gravity[:, 2] < -0.95).all()


def test_control_steps_match_jax(rollout):
  for js, ps in rollout['states'][1:]:
    _obs_close(ps.obs, js.obs, 1e-2)
    np.testing.assert_allclose(ps.reward.numpy(), js.reward, rtol=1e-2,
                               atol=1e-4)
    np.testing.assert_array_equal(ps.done.numpy(), js.done)
    for k, v in js.metrics.items():
      np.testing.assert_allclose(ps.metrics[k].numpy(), v, rtol=1e-2,
                                 atol=1e-3, err_msg=k)
    assert np.isfinite(ps.obs['privileged_state'].numpy()).all()
  assert rollout['states'][-1][1].info['steps'].tolist() == [3.0] * B


def _jax_data(jm, pd):
  """A JAX Data per env (leading axis) with the port's post-step fields
  the reward functions read."""
  n = lambda x: jnp.asarray(x.numpy())
  d = jax.vmap(lambda _: jphysics.make_data(jm))(jnp.arange(B))
  return d.replace(
      qpos=n(pd.qpos), qvel=n(pd.qvel), qacc=n(pd.qacc), ctrl=n(pd.ctrl),
      actuator_force=n(pd.actuator_force), sensordata=n(pd.sensordata),
      site_xpos=n(pd.site_xpos), site_xmat=n(pd.site_xmat),
      contact=d.contact.replace(dist=n(pd.contact.dist)))


def test_reward_terms_reference_parity(rollout):
  """Every unscaled term of the port's step against the JAX env's own
  reward function on the port's post-step data and pre-step info."""
  jenv, base = rollout['jbase'], rollout['base']
  scales = base._config.reward_config.scales
  getup = base.__class__.__name__ == 'Getup'
  for (info, action), (_, ps) in zip(rollout['steps'],
                                     rollout['states'][1:]):
    jd = _jax_data(jenv.model, ps.data)
    a = jnp.asarray(action.numpy())
    if getup:
      jinfo = {k: jnp.asarray(info[k].numpy())
               for k in ('last_act', 'last_last_act')}
      terms = jax.vmap(lambda d, a, i: jenv._get_reward(d, a, i, None,
                                                        None))(jd, a, jinfo)
    else:
      jinfo = {'last_act': jnp.asarray(info['last_act'].numpy())}
      done = jnp.asarray(ps.done.numpy()) > 0
      terms = jax.vmap(lambda d, a, i, dn: jenv._get_reward(d, a, i, dn))(
          jd, a, jinfo, done)
    assert set(terms) == set(scales)
    for k, v in terms.items():
      # the unscaled term, from the step's scaled metric (scale 0: the
      # metric is 0 and only the JAX term is checked for finiteness)
      got = ps.metrics[f'reward/{k}'].numpy()
      expect = np.asarray(v, np.float32) * scales[k]
      assert np.isfinite(np.asarray(v)).all(), k
      np.testing.assert_allclose(got, expect, rtol=1e-5,
                                 atol=1e-5 * max(1.0, abs(scales[k])),
                                 err_msg=k)


def test_getup_draws_stay_in_range():
  env = penvs.load('Go2Getup', device='cpu')
  n = 4096
  init = env.sample_init(torch.Generator().manual_seed(5), n)
  qpos, qvel = init['qpos'], init['qvel']
  home = torch.tensor(env.keyframe_qpos('home'))
  drop = (qpos != home).any(dim=1)
  assert abs(drop.float().mean().item() - 0.6) < 0.03
  assert (qpos[~drop] == home).all()
  d = qpos[drop]
  assert (d[:, 2] == 0.5).all() and (d[:, :2] == 0).all()
  np.testing.assert_allclose(d[:, 3:7].norm(dim=1).numpy(), 1.0, atol=1e-5)
  lo, hi = env._lowers, env._uppers
  assert ((d[:, 7:] >= lo) & (d[:, 7:] <= hi)).all()
  assert (qvel[:, :6].abs() <= 0.5).all() and (qvel[:, 6:] == 0).all()
  assert env.observation_size == {'state': (42,), 'privileged_state': (91,)}


def test_handstand_draws_stay_in_range():
  env = penvs.load('Go2Handstand', device='cpu')
  n = 4096
  init = env.sample_init(torch.Generator().manual_seed(6), n)
  qpos, qvel = init['qpos'], init['qvel']
  home = env.keyframe_qpos('home')
  assert ((qpos[:, :2] - torch.tensor(home[:2])).abs() <= 0.5).all()
  assert (qpos[:, 4:6] == 0).all()  # a yaw rotation only
  yaw = 2 * torch.atan2(qpos[:, 6], qpos[:, 3])
  assert yaw.abs().max() <= 3.14 + 1e-5 and yaw.abs().max() > 3.0
  np.testing.assert_array_equal(qpos[:, 7:].numpy(),
                                np.broadcast_to(home[7:], (n, 12)))
  assert (qvel[:, :6].abs() <= 0.5).all() and (qvel[:, 6:] == 0).all()
  # from the crouch (probability 1): the pre_recovery pose, at rest
  crouch = penvs.load('Go2Handstand', device='cpu',
                      config_overrides={'init_from_crouch': 1.0})
  init = crouch.sample_init(torch.Generator().manual_seed(6), 8)
  np.testing.assert_array_equal(
      init['qpos'][:, 7:].numpy(),
      np.broadcast_to(crouch.keyframe_qpos('pre_recovery')[7:], (8, 12)))
  assert (init['qvel'] == 0).all()
  assert env.observation_size == {'state': (45,), 'privileged_state': (94,)}
