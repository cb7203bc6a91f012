"""The frozen reference held to what the JAX package computed
(``benchmark/reference/jax_fixtures/``, made on the CPU by the script
stored in each file), so that the reference does not rest on the port it
was copied from:

- each configuration's env from a JAX reset, then three control steps,
  each from the JAX state before it with the JAX policy's action (the
  Go2 joystick without observation noise and with no command drawn: the
  two random streams differ by nature), held as the cells hold the
  program: every env within ``common.SPLIT`` of an entry where the frozen
  stack in float64 and float32 agree, or where the float64 stack from the
  state with its qpos moved by a millionth reaches JAX's outputs
  (``follow.reached``: the env sits within rounding of a branch, as the
  Go2's thirteenth env at the third step does, 3.4e-2 from JAX
  unmoved); dones equal; the reset's
  observation within 1e-4 (the Go2 reset's accelerometer and forces come
  out of its constraint solve: 1.8e-4 of 55 apart);
- the numpy policy's mode at JAX's observations against JAX's actions;
- the joystick's normaliser update, and three SGD steps (the frozen loss,
  the clip, Adam: ``train.sgd_reference``) at the train cell's minibatch
  shape, held by the train cell's own numbers to its own limits, with the
  JAX package in the program's place.  optax works Adam's bias
  correction 1 − β₂ᵗ out in float32 (1 − 0.999f = 0.00099998713), against
  the 0.001 of its moment's update, so its updates come out 6.4e-6
  smaller than Adam's: for the parameters' change the test gives the
  reference's SGD an Adam with optax's arithmetic (``OptaxAdam``).
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.reference import follow
from benchmark.reference import policy as ref_policy
from benchmark.reference.jax_fixtures import inputs

GO2_INIT = ('command', 'steps_until_next_cmd', 'steps_until_next_pert',
            'pert_duration_seconds', 'pert_duration', 'pert_mag')


def fixture(config):
  return dict(np.load(inputs.path(config)))


def frozen_stack(config, dtype, fx):
  """The frozen env of ``config`` wrapped for training, its reset bound to
  the fixture's JAX reset."""
  from benchmark.reference.frozen import envs
  from benchmark.reference.frozen.envs import wrappers

  cfg = common.load_json('configs', config)
  kw = dict(cfg['env_kwargs'])
  t = lambda k: torch.from_numpy(fx[k])
  if config == 'go2_joystick':
    kw['config_overrides'] = {'noise_config.level': 0.0}
    init = dict(qpos=t('env_init_qpos').to(dtype),
                qvel=t('env_init_qvel').to(dtype),
                **{k: t(f'env_init_{k}') for k in GO2_INIT})
    init = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in init.items()}
  else:
    init = tuple(t(k).to(dtype) for k in ('init_qpos', 'init_qvel',
                                           'init_ctrl'))
  env0 = envs.load(cfg['env'], device='cpu', dtype=dtype, **kw)
  env0.sample_init = lambda generator, batch: init
  B = fx['env_obs' if config == 'go2_joystick' else 'obs'].shape[1]
  return cfg, wrappers.wrap_for_training(
      env0, episode_length=cfg['episode_length'], num_envs=B)


# the physics state a step starts from, as the fixture holds it
DATA_FIELDS = ('qpos', 'qvel', 'qacc', 'ctrl', 'act', 'time', 'xfrc_applied')


def from_jax(state, fx, pre, k):
  """The frozen ``state`` with its physics state and its info set to the
  JAX state before step ``k``."""
  data, info = state.data, dict(state.info)
  rep = {}
  for f in DATA_FIELDS:
    old = getattr(data, f)
    rep[f] = torch.from_numpy(fx[f'{pre}pre_data_{f}'][k]).to(
        old.dtype).reshape(old.shape)
  head = f'{pre}pre_info_'
  for key in fx:
    if key.startswith(head):
      old = info[key[len(head):]]
      info[key[len(head):]] = torch.from_numpy(fx[key][k]).to(
          old.dtype).reshape(old.shape)
  return state.replace(data=dataclasses.replace(data, **rep), info=info)


def outputs(state):
  return np.concatenate([follow.flat_obs(state.obs).double().numpy(),
                         state.reward.double().numpy()[:, None]], axis=1)


@pytest.mark.parametrize('config', ['cube_push', 'go2_joystick'])
def test_env_steps_agree_with_jax(config):
  """Each control step from the JAX state before it, with the JAX action:
  the frozen stack held to JAX's observation and reward by the cells' own
  rule (``common.off_envs``: no env more than ``common.SPLIT`` of an
  entry away where the frozen stack in float64 and float32 agree within
  it), dones equal; the reset's observation within 1e-4."""
  fx = fixture(config)
  pre = 'env_' if config == 'go2_joystick' else ''
  stacks = {dt: frozen_stack(config, dt, fx)[1]
            for dt in (torch.float64, torch.float32)}
  states = {dt: env.reset(torch.Generator().manual_seed(0))
            for dt, env in stacks.items()}
  for s in states.values():
    np.testing.assert_allclose(follow.flat_obs(s.obs).double().numpy(),
                               fx[pre + 'obs'][0], rtol=1e-4, atol=1e-4)
  f64 = torch.float64
  for k in range(fx[pre + 'actions'].shape[0]):
    out, done, start = {}, {}, {}
    for dt, env in stacks.items():
      start[dt] = from_jax(states[dt], fx, pre, k)
      with torch.no_grad():
        n = env.step(start[dt], torch.from_numpy(fx[pre + 'actions'][k]).to(
            dt))
      out[dt], done[dt] = outputs(n), n.done.numpy() > 0.5
      states[dt] = n
    jax_out = np.concatenate([fx[pre + 'obs'][k + 1],
                              fx[pre + 'reward'][k][:, None]], axis=1)
    off = common.off_envs(jax_out, out[f64], out[torch.float32])
    witnessed = follow.reached(
        lambda seed: outputs(follow.step(
            stacks[f64], start[f64],
            torch.from_numpy(fx[pre + 'actions'][k]), f64, moved=seed)),
        jax_out, off, common.SPLIT)
    assert not (off & ~witnessed).any(), (k, np.nonzero(off)[0])
    # the one env at a branch (the Go2's thirteenth at the third step)
    assert witnessed.sum() <= 1
    for d in done.values():
      np.testing.assert_array_equal(d, fx[pre + 'done'][k] > 0.5)


@pytest.mark.parametrize('config', ['cube_push', 'go2_joystick'])
def test_policy_agrees_with_jax(config):
  fx = fixture(config)
  pre = 'env_' if config == 'go2_joystick' else ''
  cfg = common.load_json('configs', config)
  pkey = cfg['ppo']['network_factory']['policy_obs_key']
  norm, params = ref_policy.load(os.path.join(common.ROOT, cfg['weights']))
  for obs, want in zip(fx[pre + 'policy_obs'], fx[pre + 'actions']):
    got = ref_policy.mode(norm, params, obs, pkey, 'float64')
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _state_dict(weights):
  sd = {}
  for name, layers in weights.items():
    for i, (w, b) in enumerate(layers):
      sd[f'{name}.layers.{i}.weight'] = torch.from_numpy(w.T.copy())
      sd[f'{name}.layers.{i}.bias'] = torch.from_numpy(b.copy())
  return sd


class OptaxAdam(torch.optim.Optimizer):
  """Adam as optax computes it on float32 parameters: the moments' decay
  in the parameters' precision, the bias corrections 1 − βᵗ in float32."""

  def __init__(self, params, lr, betas, eps):
    super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

  @torch.no_grad()
  def step(self):
    for group in self.param_groups:
      b1, b2 = group['betas']
      for p in group['params']:
        st = self.state[p]
        if not st:
          st.update(t=0, m=torch.zeros_like(p), v=torch.zeros_like(p))
        st['t'] += 1
        t = st['t']
        st['m'].mul_(b1).add_(p.grad, alpha=1 - b1)
        st['v'].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        p.sub_(group['lr'] * (st['m'] / c1)
               / ((st['v'] / c2).sqrt() + group['eps']))


def test_sgd_agrees_with_jax(monkeypatch):
  from benchmark.generators import train
  from benchmark.reference.frozen.train import running_statistics as rs

  fx = fixture('go2_joystick')
  inp = inputs.sgd_inputs()
  cfg = common.load_json('configs', 'go2_joystick')
  t = dict(cfg['ppo'])
  assert t['learning_rate'] == inputs.LEARNING_RATE
  assert t['max_grad_norm'] == inputs.MAX_GRAD_NORM
  limits = common.load_json('limits', 'go2_joystick.train')
  f64 = torch.float64
  # the normaliser's first update
  batch = {k: torch.from_numpy(v).to(f64)
           for k, v in inp['normalizer_batch'].items()}
  norm = rs.update(rs.to(rs.init_state(cfg['obs_sizes'], 'cpu'), 'cpu', f64),
                   batch)
  jax_norm = types.SimpleNamespace(
      mean={k: torch.from_numpy(fx[f'norm_mean_{k}']) for k in inputs.OBS},
      std={k: torch.from_numpy(fx[f'norm_std_{k}']) for k in inputs.OBS})
  assert float(norm.count) == float(fx['norm_count'])
  assert train.normalizer_gap(jax_norm, norm) <= limits['normalizer_gap']

  # three SGD steps of the reference on the fixture's minibatches
  sgd = []
  for k, mb in enumerate(inp['minibatches']):
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    data = (
        {kk: tt(v) for kk, v in mb['observation'].items()},
        tt(np.tanh(mb['raw_action'])), tt(mb['reward']), tt(mb['discount']),
        {kk: tt(v) for kk, v in mb['next_observation'].items()},
        {'policy_extras': {'log_prob': tt(fx[f'mb{k}_log_prob']),
                           'raw_action': tt(mb['raw_action'])},
         'state_extras': {'truncation': tt(mb['truncation'])}})
    sgd.append({'data': data, 'noise': tt(fx[f'mb{k}_noise']),
                'loss_kwargs': inputs.LOSS_KWARGS,
                'max_grad_norm': inputs.MAX_GRAD_NORM})
  ctx = types.SimpleNamespace(cfg=cfg)
  sd = _state_dict(inp['weights'])
  monkeypatch.setattr(torch.optim, 'Adam', OptaxAdam)
  losses_r, grads_r, after_r = train.sgd_reference(
      ctx, t, sd, types.SimpleNamespace(sgd=sgd), norm, f64)

  # the JAX package in the program's place, by the train cell's numbers
  layer = lambda key: (key.split('.')[0], int(key.split('.')[2]),
                       'w' if key.endswith('weight') else 'b')
  norm_of = lambda prefix, key: float(fx['{}_{}_{}_{}_norm'.format(
      prefix, *layer(key))])
  # leaf_gaps reads norms: each JAX leaf stands in as a vector of its norm
  as_leaf = lambda n: torch.tensor([n], dtype=f64)
  grads_p = {k: as_leaf(norm_of('grad', k)) for k in grads_r}
  start = {k: v.double() for k, v in sd.items()}
  after_p = {k: start[k] + as_leaf(norm_of('change', k)).expand_as(start[k])
             / np.sqrt(start[k].numel()) for k in after_r}
  numbers = train.sgd_numbers(None, sd, losses_r, grads_r, after_r,
                              losses_p=[float(x) for x in fx['losses']],
                              grads_p=grads_p, after_p=after_p)
  for k, v in numbers.items():
    assert v <= limits[k], (k, v, limits[k])
  # every step's loss and every leaf's first gradient, not only the
  # numbers the cell compares
  for (r, scale, _), j in zip(losses_r, fx['losses']):
    assert abs(r - float(j)) <= 1e-5 * scale
  for k, g in grads_r.items():
    n = float(np.linalg.norm(g.numpy()))
    assert abs(n - norm_of('grad', k)) <= 1e-4 * max(n, 1e-3), k
  # the last layers whole
  for name in ('policy', 'value'):
    for w, key in (('w', 'weight'), ('b', 'bias')):
      ref = grads_r[f'{name}.layers.3.{key}'].numpy()
      ref = ref.T if w == 'w' else ref
      jax = fx[f'grad_{name}_3_{w}']
      np.testing.assert_allclose(ref, jax, rtol=0,
                                 atol=1e-5 * np.abs(ref).max())
