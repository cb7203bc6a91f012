"""Env-parameter tuning through the port's differentiable step, on the CPU.

1. One substep's gradient of Σqvel² + Σqpos² with respect to friction
   column 0 at 0.8 against ``jax.grad`` (tests/test_fwd_fused.py:110-129),
   on AirbotCubePush at max_contacts=8 in both packages; the JAX Pallas
   kernels in interpret mode.  The start (qpos, qvel, ctrl and the warm
   start qacc, in float32 for both) is the port's float64 reset of seed 1
   (B 2) after two control steps of substeps at that friction, where the
   warm-started solve converges: the float64 gradient lies within 1 % of
   a central difference (step 1e-4; measured 0.39 %).  The fp32 value and
   gradient of each package must lie within 1e-4 of the port's float64
   ones (fp32 rounding; measured at most 6.4e-6, JAX's moves with XLA's
   compile).  Not
   test_fwd_fused's cold start: there K3's fp32 line search sits on a
   knife edge, where a rounding-level change of its inputs moves qacc by
   5.6e-4 of its scale in either package (tests/torch_cold_start_k3.py).
2. Where the solve converges the gradient is the loss's derivative: the
   float64 gradient of the tuning loss on demo transitions 43-46 against a
   central difference of the float64 loss (step 1e-4, relative 1e-2), at
   0.8 and at the tie with the table's friction 0.4, where torch.maximum
   gives half the gradient to each side as jnp.maximum does (both within
   1 %).
3. ``_make_tuning_loss`` against JAX's on the synthetic linear dynamics of
   tests/test_rsr_pipeline.py: k 1 and 3, per-dim on and off, valid masks,
   and the reference's behaviours (the silent empty set at k = 1, the
   errors at k > 1); ``tuning_update`` zeroes a non-finite gradient
   silently, and the forward-difference start velocity reads the next row.
4. ``env_params_tuning`` end to end: 2 Adam steps on 4 demo transitions in
   fp32 against the port's float64 (the JAX side's compile of the same run
   in interpret mode takes over six minutes on a CPU, so the JAX parity
   rests on 1).
5. The tuning CLI on ``--device cpu``: the JAX script's JSON keys and log
   line.
6. A step whose inputs need no gradient saves no tensor and launches what
   it did; with a friction that needs one, the forward values are the same.
"""

import collections
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu import physics as jphysics
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.rsr import pipeline as jpipeline
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch import physics as pphysics
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.rsr import datasets as pdatasets
from rsr_mjx_tpu_torch.rsr import pipeline as ppipeline
from rsr_mjx_tpu_torch.rsr import tuning_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'data_rsr_demo')
# four demo transitions in which the cube slides against the table, so
# that the friction has a gradient (at max_contacts=8 and the port's own
# template; most windows of four have none)
START, N = 43, 4


def _friction(m, x):
  """geom_friction with column 0 set to the scalar tensor x."""
  return torch.cat([x.expand(m.ngeom)[:, None], m.geom_friction[:, 1:]], 1)


def test_substep_gradient_matches_jax(monkeypatch):
  # the start: the port's float64 reset (seed 1, B 2) after two control
  # steps of substeps at friction 0.8, rounded to float32 for both packages
  env64 = penvs.load('AirbotCubePush', device='cpu', dtype=torch.float64,
                     max_contacts=8)
  m64 = env64.model
  m08 = m64.replace(
      geom_friction=_friction(m64, torch.tensor(0.8, dtype=torch.float64)))
  with torch.no_grad():
    d = env64.reset(torch.Generator().manual_seed(1), 2).data
    for _ in range(8):
      d = pphysics.step(m08, d)
  start = {f: getattr(d, f).numpy().astype(np.float32)
           for f in ('qpos', 'qvel', 'ctrl', 'qacc')}

  jm = jenvs.load('AirbotCubePush', max_contacts=8).model
  d0 = importlib.import_module('rsr_mjx_tpu.physics.forward').make_data(jm)
  dB = jax.vmap(lambda *a: d0.replace(**dict(zip(start, a))))(
      *(jnp.asarray(a) for a in start.values()))

  def jloss(fric):
    m2 = jm.replace(geom_friction=jm.geom_friction.at[:, 0].set(fric))
    dn = jax.vmap(lambda d: jphysics.step(m2, d))(dB)
    return jnp.sum(dn.qvel**2) + jnp.sum(dn.qpos**2)

  monkeypatch.setattr(jlk, '_INTERPRET', True)
  jFF._CACHE.clear()
  try:
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.float32(0.8))
  finally:
    jFF._CACHE.clear()
  jl, jg = float(jl), float(jg)

  def port(dtype):
    m = m64 if dtype == torch.float64 else penvs.load(
        'AirbotCubePush', device='cpu', dtype=dtype, max_contacts=8).model
    d = pphysics.make_data(m, 2)
    d = d.replace(**{f: torch.from_numpy(a).to(dtype)
                     for f, a in start.items()})
    loss = lambda x: _substep_loss(m, d, x)
    x = torch.tensor(0.8, dtype=torch.float32).to(dtype).requires_grad_(True)
    value = loss(x)
    (g,) = torch.autograd.grad(value, x)
    return value.item(), g.item(), loss

  (pl, pg, _), (rl, rg, loss64) = port(torch.float32), port(torch.float64)
  assert np.isfinite([jl, jg, pl, pg]).all() and rg != 0
  for p, j, r in ((pl, jl, rl), (pg, jg, rg)):
    assert abs(p - r) <= 1e-4 * abs(r), (p, r)
    assert abs(j - r) <= 1e-4 * abs(r), (j, r)
  # the solve has converged here: the gradient is the loss's derivative
  x = torch.tensor(0.8, dtype=torch.float32).to(torch.float64)
  with torch.no_grad():
    fd = (loss64(x + 1e-4) - loss64(x - 1e-4)).item() / 2e-4
  assert abs(rg - fd) <= 1e-2 * abs(fd), (rg, fd)


def _substep_loss(m, d, x):
  """Σqvel² + Σqpos² after one substep with friction column 0 at x."""
  dn = pphysics.step(m.replace(geom_friction=_friction(m, x)), d)
  return torch.sum(dn.qvel**2) + torch.sum(dn.qpos**2)


def _demo(start=START, n=N):
  obs = pdatasets.txt_to_2d_array(os.path.join(DATA, 'real_obs.txt'))
  act = pdatasets.txt_to_2d_array(os.path.join(DATA, 'real_action.txt'))
  return (obs[start:start + n], act[start:start + n],
          obs[start + 1:start + n + 1])


def _tuning_loss(env, **kw):
  """The loss ``env_params_tuning`` descends on the demo rows."""
  return ppipeline.make_env_tuning_loss(env, *_demo(), device='cpu', **kw)


@pytest.mark.parametrize('value', [0.8, 0.4])
def test_tuning_gradient_matches_central_difference(value):
  env = penvs.load('AirbotCubePush', device='cpu', dtype=torch.float64,
                   max_contacts=8)
  fn = _tuning_loss(env)
  x = torch.tensor(value, dtype=torch.float32).to(torch.float64)
  if value == 0.4:  # the table's slide friction, also float32(0.4)
    assert x.item() == env.model.geom_friction[:, 0].min().item()
  x.requires_grad_(True)
  (g,) = torch.autograd.grad(fn(x), x)
  with torch.no_grad():
    fd = (fn(x + 1e-4) - fn(x - 1e-4)) / 2e-4
  assert g.item() != 0
  assert abs(g.item() - fd.item()) <= 1e-2 * abs(fd.item()), (g, fd)


class _S(collections.namedtuple('_S', 'obs')):
  pass


def _linear_case():
  rng = np.random.default_rng(4)
  obs = rng.normal(size=(5, 2)).astype(np.float32)
  act = rng.normal(size=(5, 2)).astype(np.float32)
  nxt = (obs + 0.7 * act + 0.05 * rng.normal(size=(5, 2))).astype(np.float32)
  w = np.asarray([1.0, 10.0], np.float32)
  return obs, act, nxt, w


@pytest.mark.parametrize('k', [1, 3])
@pytest.mark.parametrize('per_dim', [False, True])
@pytest.mark.parametrize('valid', [None, (True, False, True, True, True)])
def test_tuning_loss_matches_jax(k, per_dim, valid):
  obs, act, nxt, w = _linear_case()
  vmask = None if valid is None else np.asarray(valid)
  jfn = jpipeline._make_tuning_loss(
      lambda p, s, a: _S(obs=s.obs + p * a), _S(obs=jnp.asarray(obs)),
      jnp.asarray(act), jnp.asarray(nxt), jnp.asarray(w), k, per_dim,
      valid=vmask)
  pfn = ppipeline._make_tuning_loss(
      lambda p, s, a: _S(obs=s.obs + p * a), _S(obs=torch.from_numpy(obs)),
      torch.from_numpy(act), torch.from_numpy(nxt), torch.from_numpy(w), k,
      per_dim, valid=vmask)
  for p in (0.3, 0.7, 1.2):
    jl, jg = jax.value_and_grad(jfn)(jnp.float32(p))
    x = torch.tensor(p, requires_grad=True)
    pl = pfn(x)
    (pg,) = torch.autograd.grad(pl, x)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pg.item(), float(jg), rtol=1e-6, atol=1e-6)


def test_tuning_loss_reference_behaviours():
  obs, act, nxt, w = _linear_case()
  args = (lambda p, s, a: _S(obs=s.obs + p * a), _S(obs=torch.from_numpy(obs)),
          torch.from_numpy(act), torch.from_numpy(nxt), torch.from_numpy(w))
  x = torch.tensor(0.5)
  # k = 1 with no valid transition: a zero loss, silently (ADVICE.md)
  assert ppipeline._make_tuning_loss(*args, 1, False,
                                     valid=np.zeros(5, bool))(x).item() == 0
  with pytest.raises(ValueError, match='no k-step window'):
    ppipeline._make_tuning_loss(*args, 3, False,
                                valid=np.asarray([1, 1, 0, 1, 1], bool))
  with pytest.raises(ValueError, match='needs at least 6'):
    ppipeline._make_tuning_loss(*args, 6, False)
  # a non-finite gradient is zeroed without a word: Adam leaves p in place
  p = torch.tensor(0.5, requires_grad=True)
  opt = torch.optim.Adam([p], lr=0.1)
  loss = ppipeline.tuning_update(lambda q: q * torch.tensor(float('nan')), p,
                                 opt, 0.1, 1.0)
  assert torch.isnan(loss) and p.item() == 0.5
  # the clip to the bounds after the update: one Adam step of lr 0.1 down
  # from 0.5, clipped at 0.47
  p = torch.tensor(0.5, requires_grad=True)
  opt = torch.optim.Adam([p], lr=0.1)
  ppipeline.tuning_update(lambda q: 3 * q, p, opt, 0.47, 0.55)
  assert p.item() == pytest.approx(0.47, abs=1e-7)


def test_estimated_start_velocity_reads_the_next_row():
  env = penvs.load('AirbotCubePush', device='cpu', max_contacts=8)
  obs, _, nxt = _demo()
  t = lambda a: torch.from_numpy(a.astype(np.float32))
  states, valid = ppipeline.tuning_states(env, t(obs), t(nxt),
                                          estimate_init_qvel=True,
                                          device='cpu')
  qvel = states.data.qvel
  v = np.clip((nxt.astype(np.float32) - obs.astype(np.float32))
              / env.ctrl_dt, -10, 10)
  np.testing.assert_allclose(qvel[:, :6].numpy(), v[:, :6], rtol=1e-5,
                             atol=1e-5)
  assert valid is not None  # only this option marks invalid rows
  assert ppipeline.tuning_states(env, t(obs), t(nxt), device='cpu')[1] is None


def _state_to(state, dtype):
  mv = lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() \
      else x
  return state.replace(
      data=state.data.map(mv), obs=mv(state.obs), reward=mv(state.reward),
      done=mv(state.done), metrics={k: mv(v) for k, v in state.metrics.items()},
      info={k: mv(v) for k, v in state.info.items()})


def test_env_params_tuning_fp32_matches_float64():
  """The float64 run gets the fp32 run's template: the template's zero
  step from the reset is chaotic in fp32 (its qvel parts from float64 by
  8.5 in one control step, the known cube-push reset behaviour), while the
  loss on a given template is not (1.8e-6 apart at the first step)."""
  env32 = penvs.load('AirbotCubePush', device='cpu', max_contacts=8)
  template = ppipeline.tuning_template(env32, 'cpu')
  out = {}
  for dtype in (torch.float32, torch.float64):
    env = env32 if dtype == torch.float32 else penvs.load(
        'AirbotCubePush', device='cpu', dtype=dtype, max_contacts=8)
    params, log = ppipeline.env_params_tuning(
        env, 2, 0.4, 0.08, 4.0, *_demo(), device='cpu',
        template=tuple(_state_to(st, dtype) for st in template))
    assert params.dtype == dtype
    out[dtype] = (np.asarray(log['loss']), np.asarray(log['params'],
                                                       np.float64))
  (l32, p32), (l64, p64) = out[torch.float32], out[torch.float64]
  assert np.isfinite(l32).all() and len(l32) == 2
  assert abs(p32[-1] - 0.4) > 1e-3  # Adam moved the friction
  # fp32 sums through four substeps of contact: rtol 1e-4, the repo's
  # tolerance for smooth-dynamics quantities (measured 1.2e-5)
  np.testing.assert_allclose(l32, l64, rtol=1e-4)
  np.testing.assert_allclose(p32, p64, rtol=1e-6)


def test_tuning_cli_on_the_cpu(tmp_path):
  out, log = tmp_path / 'tuned_params.json', tmp_path / 'log.txt'
  result = tuning_cli.main([
      '--obs', os.path.join(DATA, 'real_obs.txt'), '--actions',
      os.path.join(DATA, 'real_action.txt'), '--num_transitions', '2',
      '--start', str(START), '--num_steps', '1', '--device', 'cpu',
      '--out', str(out), '--log_path', str(log)])
  saved = json.loads(out.read_text())
  assert saved == result
  assert list(saved) == ['tuned_friction', 'final_loss', 'num_steps',
                         'rollout_horizon', 'per_dim_error',
                         'estimate_init_qvel']
  assert saved['num_steps'] == 1 and np.isfinite(saved['final_loss'])
  line = log.read_text().splitlines()
  assert len(line) == 1 and line[0].startswith('step 0: ')
  assert ' params = ' in line[0] and line[0].endswith('.')
  assert tuning_cli.parse_args([]).device == 'cuda'


def test_step_without_gradient_is_unchanged(monkeypatch):
  env = penvs.load('AirbotCubePush', device='cpu', max_contacts=8)
  m = env.model
  d = env.reset(torch.Generator().manual_seed(1), 2).data
  calls = collections.Counter()
  for name in ('spd_solve_plain', 'contact_select_plain', 'newton_pyr_plain',
               'newton_generic_plain'):
    real = getattr(plk, name)
    monkeypatch.setattr(plk, name, lambda *a, _r=real, _n=name: (
        calls.update([_n]), _r(*a))[1])
  packed = []
  with torch.autograd.graph.saved_tensors_hooks(
      lambda t: packed.append(t.shape) or t, lambda t: t):
    plain = pphysics.step(m, d)
  assert not packed  # grad mode on, no input needs a gradient
  assert calls == {'spd_solve_plain': 2, 'contact_select_plain': 1,
                   'newton_pyr_plain': 1}
  x = torch.tensor(0.4, requires_grad=True)
  m2 = ppipeline.default_param_setter(m, x)
  # a copy that changes numeric leaves keeps the device tables
  assert m2.__dict__['_device_tables'] is m.__dict__['_device_tables']
  with torch.no_grad():
    plain = pphysics.step(m2, d)
  calls.clear()
  graded = pphysics.step(m2, d)
  assert calls == {'spd_solve_plain': 2, 'contact_select_plain': 1,
                   'newton_pyr_plain': 1}  # the forward alone
  assert graded.qacc.grad_fn is not None
  for f in ('qpos', 'qvel', 'qacc', 'qfrc_constraint', 'efc_force', 'xpos',
            'sensordata'):
    assert torch.equal(getattr(graded, f).detach(), getattr(plain, f)), f


def test_param_setters_write_the_reference_leaves():
  """The three setters of rsr_mjx_tpu/rsr/pipeline.py:39-58: the last
  geom's whole friction row, the last gravity component, the last body's
  mass; each keeps the parameter's gradient."""
  m = penvs.load('AirbotCubePush', device='cpu', max_contacts=8).model
  p = torch.tensor(0.7, requires_grad=True)
  f = ppipeline.default_param_setter(m, p).geom_friction
  assert torch.equal(f[-1].detach(), torch.full((3,), 0.7))
  assert torch.equal(f[:-1], m.geom_friction[:-1])
  g = ppipeline.gravity_param_setter(m, p).opt.gravity
  assert g[-1].item() == pytest.approx(0.7) and torch.equal(
      g[:-1], m.opt.gravity[:-1])
  bm = ppipeline.body_mass_param_setter(m, p).body_mass
  assert bm[-1].item() == pytest.approx(0.7) and torch.equal(
      bm[:-1], m.body_mass[:-1])
  (grad,) = torch.autograd.grad(f.sum() + g.sum() + bm.sum(), p)
  assert grad.item() == 5.0
