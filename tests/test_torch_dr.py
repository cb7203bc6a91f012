"""Domain randomisation in the port against the JAX package.

1. The randomisers (Airbot cube-push, Go2 joystick): the fields each makes
   per env and no other, each scale or draw inside the JAX package's range,
   the untouched leaves bit for bit the nominal ones (``body_invweight0``
   and ``dof_invweight0`` too: neither package re-derives them), and the
   envs distinct.
2. One DR control step of each: the JAX randomiser's batched fields are
   carried into the port (``Model.with_batched``, numpy in), a JAX reset
   of the wrapped DR env is handed to the port's, and one control step of
   the trained policy runs in both (the JAX Pallas kernels in interpret
   mode, the port's kernels as their plain versions): obs within 1e-5 at
   reset (kinematics only), obs and reward within the repo's post-solve
   tolerance 1e-2 after the step.
   The JAX lanes route takes DR-batched contact parameters only when all
   four of them are batched: with ``geom_friction`` alone randomised it
   fails, concatenating a (B, ncon, 5) friction with the (ncon, 2)
   solref (cube-push, a TypeError) or broadcasting shapes (4,) and (4, 3)
   (Go2, a ValueError).  So the JAX side here batches
   ``geom_solref``, ``geom_solimp`` and ``body_invweight0`` too, with
   their nominal values in every env (``_jax_randomizer``); that changes
   no number, and the port's model takes the randomiser's fields alone.
3. K2 with per-env contact parameters: the port's plain version (the 13
   parameter columns as dynamic features, Fd 26, the pair table the dof
   masks alone) against the JAX package's ``lax.top_k`` + one-hot einsum
   branch on the same DR cube-push inputs, exactly.
4. The trainers: a tiny ``sac.train`` and the PPO CLI with
   ``--domain_randomization`` on the CPU; the training envs step with one
   model per env, the evaluator's with the nominal model; the CLI refuses
   an env that has no randomiser.
"""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.physics import constraint as jC
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import lanes_assembly as jA
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.train import configs as jconfigs
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import ppo as jppo
from rsr_mjx_tpu.train import running_statistics as jrs
from rsr_mjx_tpu.train import sac as jsac
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.envs.airbot import randomize as prand_airbot
from rsr_mjx_tpu_torch.envs.go2 import randomize as prand_go2
from rsr_mjx_tpu_torch.physics import constraint as pC
from rsr_mjx_tpu_torch.physics import lanes_assembly as pA
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.physics import types as pT
from rsr_mjx_tpu_torch.train import acting
from rsr_mjx_tpu_torch.train import cli as pcli
from rsr_mjx_tpu_torch.train import networks as pnets
from rsr_mjx_tpu_torch.train import sac as psac
from rsr_mjx_tpu_torch.train import sac_networks as psn
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE, GO2 = 'AirbotCubePushTrain', 'Go2JoystickFlatTerrain'
B = 3
AIRBOT_FIELDS = {'geom_friction', 'body_mass', 'dof_damping',
                 'dof_frictionloss'}
GO2_FIELDS = {'geom_friction', 'dof_frictionloss', 'dof_armature',
              'actuator_gainprm', 'actuator_biasprm', 'dof_damping',
              'body_ipos', 'body_mass', 'qpos0'}
NO_NOISE = {'noise_config.level': 0.0}


def _unchanged(nominal: pT.Model, batched: pT.Model, fields):
  """Every leaf outside ``fields`` is the nominal one, and every batched
  one has the nominal shape behind its env axis."""
  assert batched.batched == frozenset(fields)
  for f in pT.NUMERIC_FIELDS:
    x, y = nominal.numeric[f], batched.numeric[f]
    if f in fields:
      assert tuple(y.shape) == (batched.batch_size,) + tuple(x.shape), f
    elif x is None:
      assert y is None, f
    else:
      assert torch.equal(x, y), f


def _ratio_in(x, nominal, lo, hi):
  r = x / nominal
  assert (r >= lo - 1e-6).all() and (r <= hi + 1e-6).all(), (r, lo, hi)
  return r


def test_airbot_randomizer_fields_and_ranges():
  m = penvs.load(CUBE, device='cpu').model
  n = 64
  mb = prand_airbot.domain_randomize(m, torch.Generator().manual_seed(0), n)
  assert mb.batch_size == n and m.batched == frozenset()
  _unchanged(m, mb, AIRBOT_FIELDS)
  g = lambda kind, name: m.names[kind][name]
  table, cube = g('geom', 'table-b'), g('geom', 'geom_for_push')
  fingers = prand_airbot.finger_geoms(m)
  assert len(fingers) == 6
  gf = mb.geom_friction
  scales = {}
  for gid, rng in [(table, prand_airbot.FRICTION_TABLE_CUBE),
                   (cube, prand_airbot.FRICTION_TABLE_CUBE)] + [
                       (f, prand_airbot.FRICTION_FINGER) for f in fingers]:
    r = _ratio_in(gf[:, gid], m.geom_friction[gid], *rng)
    assert torch.allclose(r, r[:, :1].expand(n, 3), rtol=1e-6)  # one scale
    scales[gid] = r[:, 0]
  for f in fingers[1:]:  # one scale for every finger geom
    torch.testing.assert_close(scales[f], scales[fingers[0]])
  other = [i for i in range(m.ngeom) if i not in [table, cube] + fingers]
  assert torch.equal(gf[:, other], m.geom_friction[other].expand(
      n, len(other), 3))
  cb = g('body', 'cube_for_push')
  _ratio_in(mb.body_mass[:, cb], m.body_mass[cb], *prand_airbot.MASS_CUBE)
  rest = [i for i in range(m.nbody) if i != cb]
  assert torch.equal(mb.body_mass[:, rest], m.body_mass[rest].expand(
      n, len(rest)))
  for f in ('dof_damping', 'dof_frictionloss'):
    x, x0 = getattr(mb, f), getattr(m, f)
    r = _ratio_in(x[:, :8], x0[:8], *prand_airbot.JOINT_SCALE)
    assert torch.allclose(r, r[:, :1].expand(n, 8), rtol=1e-6)
    assert torch.equal(x[:, 8:], x0[8:].expand(n, m.nv - 8))
  # the envs differ, and the draws spread over the range
  for s in (scales[table], scales[cube], mb.body_mass[:, cb]):
    assert len(torch.unique(s)) == n
  assert scales[table].min() < 0.75 and scales[table].max() > 1.25


def test_go2_randomizer_fields_and_ranges():
  m = penvs.load(GO2, device='cpu').model
  n = 64
  mb = prand_go2.domain_randomize(m, torch.Generator().manual_seed(1), n)
  _unchanged(m, mb, GO2_FIELDS)
  floor = m.names['geom']['floor']
  torso = m.names['body']['trunk']
  ff = mb.geom_friction[:, floor, 0]
  assert (ff >= 0.4).all() and (ff <= 1.0).all()
  assert torch.equal(mb.geom_friction[:, floor, 1:],
                     m.geom_friction[floor, 1:].expand(n, 2))
  nonfloor = [i for i in range(m.ngeom) if i != floor]
  assert torch.equal(mb.geom_friction[:, nonfloor],
                     m.geom_friction[nonfloor].expand(n, len(nonfloor), 3))
  for f, (lo, hi) in (('dof_frictionloss', (0.9, 1.1)),
                      ('dof_armature', (1.0, 1.05)),
                      ('dof_damping', (0.95, 1.05))):
    x, x0 = getattr(mb, f), getattr(m, f)
    _ratio_in(x[:, 6:], x0[6:], lo, hi)
    assert torch.equal(x[:, :6], x0[:6].expand(n, 6)), f
  kp = _ratio_in(mb.actuator_gainprm[:, :, 0], m.actuator_gainprm[:, 0],
                 0.95, 1.05)
  # gain and position bias scaled together: Kp stays coherent
  torch.testing.assert_close(
      mb.actuator_biasprm[:, :, 1] / m.actuator_biasprm[:, 1], kp)
  for f, col in (('actuator_gainprm', 0), ('actuator_biasprm', 1)):
    x, x0 = getattr(mb, f), getattr(m, f)
    keep = [c for c in range(x0.shape[1]) if c != col]
    assert torch.equal(x[:, :, keep], x0[:, keep].expand(n, m.nu, len(keep)))
  shift = mb.body_ipos[:, torso] - m.body_ipos[torso]
  assert (shift.abs() <= 0.2 + 1e-6).all() and shift.abs().max() > 0.15
  rest = [i for i in range(m.nbody) if i != torso]
  assert torch.equal(mb.body_ipos[:, rest],
                     m.body_ipos[rest].expand(n, len(rest), 3))
  assert torch.equal(mb.body_mass[:, 0], m.body_mass[0].expand(n))  # world
  _ratio_in(mb.body_mass[:, rest[1:]], m.body_mass[rest[1:]], 0.9, 1.1)
  extra = mb.body_mass[:, torso] - m.body_mass[torso]
  assert (extra >= -0.1 * m.body_mass[torso] - 3.0 - 1e-4).all()
  assert (extra <= 0.1 * m.body_mass[torso] + 3.0 + 1e-4).all()
  off = mb.qpos0[:, 7:] - m.qpos0[7:]
  assert (off.abs() <= 0.05 + 1e-6).all()
  assert torch.equal(mb.qpos0[:, :7], m.qpos0[:7].expand(n, 7))
  assert len(torch.unique(ff)) == n and len(torch.unique(extra)) == n


def test_batched_model_contract():
  m = penvs.load(CUBE, device='cpu').model
  mb = m.with_batched(body_mass=np.stack([m.body_mass.numpy()] * 2))
  assert mb.batch_size == 2 and mb.lanes('body_mass').shape == (m.nbody, 2)
  assert m.lanes('body_mass').shape == (m.nbody, 1)
  # a shared replacement of a batched leaf leaves the batch
  assert m.batch_size is None and mb.replace(body_mass=m.body_mass).batched \
      == frozenset()
  with pytest.raises(ValueError):  # the env counts disagree
    mb.with_batched(dof_damping=torch.zeros(3, m.nv))
  with pytest.raises(ValueError):  # not the nominal shape behind the axis
    m.with_batched(dof_damping=torch.zeros(2, m.nv + 1))


def _jax_randomizer(name):
  """The JAX randomiser with ``geom_solref``, ``geom_solimp`` and
  ``body_invweight0`` batched too (nominal values): the JAX lanes route
  needs every contact parameter batched once one is (module docstring)."""
  rfn = jenvs.get_domain_randomizer(name)

  def fn(model, rng):
    mb, axes = rfn(model, rng)
    n = rng.shape[0]
    extra = {k: jnp.broadcast_to(getattr(model, k),
                                 (n,) + getattr(model, k).shape)
             for k in ('geom_solref', 'geom_solimp', 'body_invweight0')}
    return (dataclasses.replace(mb, **extra),
            dataclasses.replace(axes, **dict.fromkeys(extra, 0)))
  return fn


def _jax_fields(name, jm, key):
  """JAX's randomised fields (numpy, leading env axis) of B envs."""
  mb, axes = jenvs.get_domain_randomizer(name)(
      jm, jax.random.split(key, B))
  return {f: np.asarray(getattr(mb, f)) for f in pT.NUMERIC_FIELDS
          if getattr(axes, f) == 0}


def _cube_policies():
  path = os.path.join(ROOT, 'logs', 'cube_ppo_15M_r4', 'final_params.pkl')
  params = jsac.load_params(path)
  net = jnets.make_ppo_networks(
      23, 5, policy_hidden_layer_sizes=(32, 32, 32, 32),
      value_hidden_layer_sizes=(256, 256, 256, 256, 256))
  pol = jppo._make_policy_factory(net, jrs.normalize)(params,
                                                      deterministic=True)
  jpol = jax.jit(lambda obs: pol(obs, jax.random.PRNGKey(0))[0])
  return jpol, pnets.make_policy(*pnets.load_ppo_params(path), device='cpu')


def _go2_policies():
  path = os.path.join(ROOT, 'logs', 'go2_joystick_50M_r5',
                      'final_params.pkl')
  params = jsac.load_params(path)
  nf = jconfigs.ppo_config(GO2).network_factory
  net = jnets.make_ppo_networks(
      {'state': (48,), 'privileged_state': (123,)}, 12,
      policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes),
      policy_obs_key=nf.policy_obs_key, value_obs_key=nf.value_obs_key)
  pol = jppo._make_policy_factory(net, jrs.normalize)(params,
                                                      deterministic=True)
  jpol = jax.jit(lambda obs: pol(obs, jax.random.PRNGKey(0))[0])
  ppol = pnets.make_policy(*pnets.load_ppo_params(path), device='cpu',
                           obs_key='state', value_obs_key='privileged_state')
  return jpol, ppol


GO2_INIT_KEYS = ('command', 'steps_until_next_cmd', 'steps_until_next_pert',
                 'pert_duration_seconds', 'pert_duration', 'pert_mag')


def _dr_step(name):
  """A JAX DR reset handed to the port, one control step in both, and the
  port's K2 inputs and output of its first substep (cube-push)."""
  kw = {} if name == CUBE else {'config_overrides': NO_NOISE}
  jbase = jenvs.load(name, **kw)
  fields = _jax_fields(name, jbase.model, jax.random.PRNGKey(10))
  jenv = jwrappers.wrap_for_training(
      jbase, episode_length=100, randomization_fn=functools.partial(
          _jax_randomizer(name), rng=jax.random.split(
              jax.random.PRNGKey(10), B)))
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(2), B))
  t = lambda x: torch.from_numpy(np.array(x))
  base = penvs.load(name, device='cpu', **kw)
  if name == CUBE:
    d = jstate.data
    init = tuple(t(x) for x in (d.qpos, d.qvel, d.ctrl))
    jpolicy, ppolicy = _cube_policies()
  else:
    far = jnp.full((B,), 50, jnp.int32)  # no command draw in the step
    jstate.info['steps_until_next_cmd'] = far
    jstate.info['first_info']['steps_until_next_cmd'] = far
    init = dict(qpos=t(jstate.data.qpos), qvel=t(jstate.data.qvel),
                **{k: t(jstate.info[k]) for k in GO2_INIT_KEYS})
    jpolicy, ppolicy = _go2_policies()
  base.sample_init = lambda generator, batch: init
  jdata = jax.tree.map(np.asarray, jstate.data)
  penv = pwrappers.wrap_for_training(
      base, episode_length=100,
      randomization_fn=lambda m: m.with_batched(**fields))
  pstate = penv.reset(torch.Generator().manual_seed(0))
  out = dict(name=name, fields=fields, base=base, penv=penv,
             reset=(jax.tree.map(np.asarray, jstate.obs), pstate.obs))
  recorded = {}

  def record(*args):
    res = select(*args)
    recorded.setdefault('k2', (args, res[0].clone()))
    return res

  select = plk.contact_select_lanes
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jlk, '_INTERPRET', True)
    mp.setattr(plk, 'contact_select_lanes', record)
    jFF._CACHE.clear()
    try:
      jstate = jax.jit(jenv.step)(jstate, jpolicy(jstate.obs))
      with torch.no_grad():
        pstate = penv.step(pstate, ppolicy(pstate.obs))
    finally:
      jFF._CACHE.clear()
  out.update(step=(jax.tree.map(np.asarray, jstate), pstate),
             recorded=recorded, jdata=jdata)
  return out


@pytest.fixture(scope='module')
def dr_cube():
  return _dr_step(CUBE)


@pytest.fixture(scope='module')
def dr_go2():
  return _dr_step(GO2)


def _obs_items(obs):
  return sorted(obs.items()) if isinstance(obs, dict) else [('obs', obs)]


@pytest.mark.parametrize('which', ['dr_cube', 'dr_go2'])
def test_dr_step_matches_jax(which, request):
  dr_step = request.getfixturevalue(which)
  jobs, pobs = dr_step['reset']
  for (k, p), (_, j) in zip(_obs_items(pobs), _obs_items(jobs)):
    np.testing.assert_allclose(p.numpy(), j, rtol=1e-5, atol=1e-5,
                               err_msg=k)
  js, ps = dr_step['step']
  for (k, p), (_, j) in zip(_obs_items(ps.obs), _obs_items(js.obs)):
    np.testing.assert_allclose(p.numpy(), j, rtol=1e-2, atol=1e-2,
                               err_msg=k)
  np.testing.assert_allclose(ps.reward.numpy(), js.reward, rtol=1e-2,
                             atol=1e-3)
  np.testing.assert_array_equal(ps.done.numpy(), js.done)
  # the port stepped with the carried fields, one model per env, and left
  # the env it was given nominal
  model = dr_step['penv'].unwrapped.model
  assert model.batched == frozenset(dr_step['fields'])
  for f, v in dr_step['fields'].items():
    np.testing.assert_array_equal(model.numeric[f].numpy(), v)
    assert len(np.unique(v.reshape(B, -1), axis=0)) == B, f
  assert dr_step['base'].model.batched == frozenset()


def test_dr_model_survives_auto_reset(dr_cube):
  """An env that is done restarts from its first state and keeps its own
  model: the wrapper binds one batched model, and auto-reset replaces
  state only."""
  penv, (_, ps) = dr_cube['penv'], dr_cube['step']
  model = penv.unwrapped.model
  info = dict(ps.info, steps=torch.tensor([99.0, 1.0, 1.0]))  # of 100
  with torch.no_grad():
    ns = penv.step(ps.replace(info=info), torch.zeros(B, 5))
  assert ns.done.tolist() == [1.0, 0.0, 0.0]
  assert penv.unwrapped.model is model
  np.testing.assert_array_equal(ns.data.qpos[0].numpy(),
                                ps.info['first_data'].qpos[0].numpy())
  assert not torch.equal(ns.data.qpos[1], ps.info['first_data'].qpos[1])


def test_k2_with_per_env_contact_params_matches_jax_einsum(dr_cube):
  """K2's plain version on the DR cube-push substep (Fd 26, nst nv)
  against the JAX einsum branch on the same inputs, exactly."""
  dr_step = dr_cube
  (pair_struct, nsel, dist, feat, table), sel = dr_step['recorded']['k2']
  assert tuple(feat.shape) == (480, 26, B) and tuple(table.shape) == (30, 20)
  # the parameter columns are per env: the table's friction differs
  assert not torch.equal(feat[:, 13, 0], feat[:, 13, 1])

  # the JAX branch: run JAX's assemble_lanes on a DR reset state and
  # capture what it concatenates: the (ncon, 26, B) features it selects
  # from (13 dynamic, 13 per-env parameters) and its selection
  jm = jenvs.load(CUBE).model
  fields = dr_step['fields']
  nominal = {k: getattr(jm, k) for k in
             ('geom_solref', 'geom_solimp', 'body_invweight0')}
  mb = dataclasses.replace(
      jm, **{k: jnp.asarray(v) for k, v in fields.items()},
      **{k: jnp.broadcast_to(v, (B,) + v.shape) for k, v in nominal.items()})
  axes = dataclasses.replace(
      jax.tree.map(lambda _: None, jm),
      **dict.fromkeys(list(fields) + list(nominal), 0))
  lv = jax.vmap(jC.gather_leaves, in_axes=(axes, 0))(mb, dr_step['jdata'])
  lanes = lambda x: jnp.moveaxis(jnp.asarray(x), 0, -1)
  dyn = ('qpos', 'qvel', 'cdof', 'cdof_anchor', 'geom_xpos', 'geom_xmat')
  lv = lv._replace(**{f: lanes(getattr(lv, f)) for f in dyn})
  caught = []
  real = jA.jnp

  def concatenate(parts, axis=0):
    out = real.concatenate(parts, axis=axis)
    if axis == 1 and out.ndim == 3 and out.shape[0] in (480, nsel):
      caught.append(np.asarray(out))
    return out

  proxy = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                   if not k.startswith('__')})
  proxy.concatenate = concatenate
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jA, 'jnp', proxy)
    jA.assemble_lanes(jm, lv, basis=True, dyn_lanes=True)
  feats = [c for c in caught if c.shape == (480, 26, B)]
  sels = [c for c in caught if c.shape == (nsel, 26 + 20, B)]
  assert len(feats) == len(sels) == 1
  jfeat, jsel = feats[0], sels[0]
  assert not np.array_equal(jfeat[:, 13, 0], jfeat[:, 13, 1])
  # the port's K2 plain version on exactly those inputs
  pm = dr_step['base'].model
  ptab = torch.from_numpy(pC.contact_dmask(pm).astype(np.float32)[
      pA._pair_slot0(pm)])
  psel, _ = plk.contact_select_lanes(
      pair_struct, nsel, torch.from_numpy(jfeat[:, 0].copy()),
      torch.from_numpy(jfeat.copy()), ptab)
  np.testing.assert_array_equal(psel.numpy(), jsel)
  # and on the recorded substep, K2 is the top-k gather of its inputs
  _, top = jax.lax.top_k(-(dist.numpy().T + 0.0), nsel)
  idx = np.asarray(top).T  # (nsel, B)
  want = np.take_along_axis(feat.numpy(), idx[:, None, :], axis=0)
  np.testing.assert_array_equal(sel[:, :26].numpy(), want)


def _wrap_spy(monkeypatch):
  """Record every ``wrap_for_training`` call's randomiser and result."""
  calls = []
  real = pwrappers.wrap_for_training

  def spy(env, **kw):
    out = real(env, **kw)
    calls.append((kw.get('randomization_fn'), out))
    return out
  monkeypatch.setattr(pwrappers, 'wrap_for_training', spy)
  return calls


def _assert_dr_only_in_training(calls, num_envs):
  (rfn, train_env), (efn, eval_env) = calls
  assert rfn is not None and efn is None
  assert train_env.unwrapped.model.batch_size == num_envs
  assert eval_env.unwrapped.model.batched == frozenset()


def test_sac_train_with_domain_randomization(monkeypatch):
  calls = _wrap_spy(monkeypatch)
  rollout_models = []
  real_step = acting.actor_step

  def actor_step(env, env_state, *a, **k):
    rollout_models.append((env_state.reward.shape[0],
                           env.unwrapped.model.batch_size))
    return real_step(env, env_state, *a, **k)
  monkeypatch.setattr(acting, 'actor_step', actor_step)
  base = penvs.load(CUBE, device='cpu')
  _, _, metrics = psac.train(
      base, num_timesteps=4 * 4, episode_length=3, num_envs=4, batch_size=4,
      min_replay_size=8, max_replay_size=32, num_evals=2, num_eval_envs=2,
      network_factory=functools.partial(psn.make_sac_networks,
                                        hidden_layer_sizes=(8, 8)),
      randomization_fn=penvs.get_domain_randomizer(CUBE), device='cpu')
  assert np.isfinite(metrics['eval/episode_reward'])
  _assert_dr_only_in_training(calls, 4)
  # training steps (4 envs) on 4 models, evaluation (2 envs) on the nominal
  assert set(rollout_models) == {(4, 4), (2, None)}
  assert base.model.batched == frozenset()


def test_ppo_cli_with_domain_randomization(tmp_path, monkeypatch):
  calls = _wrap_spy(monkeypatch)
  with pytest.raises(ValueError, match='no domain randomiser'):
    pcli.main(['--env', 'AirbotTPush', '--domain_randomization',
               '--device', 'cpu', '--logdir', str(tmp_path / 'x')])
  assert not calls
  logdir = tmp_path / 'run'
  _, (norm, _), metrics = pcli.main([
      '--env', CUBE, '--domain_randomization', '--device', 'cpu',
      '--logdir', str(logdir), '--num_timesteps', '8', '--num_envs', '4',
      '--batch_size', '2', '--num_minibatches', '2', '--unroll_length', '2',
      '--num_updates_per_batch', '1', '--episode_length', '3',
      '--num_evals', '1'])
  assert np.isfinite(metrics['eval/episode_reward'])
  assert os.path.exists(logdir / 'final_params.pkl')
  _assert_dr_only_in_training(calls, 4)
  assert calls[0][1].unwrapped.model.batched == frozenset(AIRBOT_FIELDS)
