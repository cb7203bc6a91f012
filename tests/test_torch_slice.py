"""The port's serving slice against the JAX package's.

1. The trained cube-push PPO policy (logs/cube_ppo_15M_r4/final_params.pkl),
   carried into the port by ``networks.make_policy`` (``PPONetworks`` on
   ``ppo_params_from_numpy``, its policy's mode), against the JAX
   ``make_policy(..., deterministic=True)`` on the same observations.
2. The whole slice: a JAX reset of the wrapped AirbotCubePushTrain env is
   handed to the port's wrapped env, then both run 3 control steps of the
   deterministic policy (the JAX Pallas kernels in interpret mode, the
   port's kernels as their plain versions) and their obs, reward and done
   are compared.  Tolerances: the policy rtol 1e-5 (same fp32 MLP, other
   summation order); the reset obs 1e-5 (kinematics only); after steps, the
   repo's post-solve tolerance 1e-2 (tests/test_fwd_fused.py).

   The reset batch is one in the mild regime.  Some resets are not: there a
   change of qpos at the level of fp32 rounding already moves the obs past
   the 1e-2 tolerance within 3 control steps (the fixed 6-step Newton solve
   accepts or rejects steps on Δφ ≈ 0), so any two fp32 summation orders
   part by as much.  chip_smoke.py's reference phase measures this against
   a float64 run of the same start states.
"""

import os

import jax
import numpy as np
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import ppo, running_statistics, sac
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.train import networks as pnets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(ROOT, 'logs', 'cube_ppo_15M_r4', 'final_params.pkl')
ENV = 'AirbotCubePushTrain'
B = 3


def _jax_policy():
  params = sac.load_params(PARAMS)
  net = jnets.make_ppo_networks(
      23, 5, policy_hidden_layer_sizes=(32, 32, 32, 32),
      value_hidden_layer_sizes=(256, 256, 256, 256, 256))
  make = ppo._make_policy_factory(net, running_statistics.normalize)
  policy = make(params, deterministic=True)
  return lambda obs: policy(obs, jax.random.PRNGKey(0))[0]


def _port_policy():
  normalizer, params = pnets.load_ppo_params(PARAMS)
  return pnets.make_policy(normalizer, params, device='cpu')


def test_policy_matches_jax():
  normalizer, _ = pnets.load_ppo_params(PARAMS)
  rng = np.random.default_rng(0)
  obs = (normalizer.mean + normalizer.std
         * rng.normal(size=(64, 23))).astype(np.float32)
  aj = np.asarray(jax.jit(_jax_policy())(obs))
  with torch.no_grad():
    ap = _port_policy()(torch.from_numpy(obs)).numpy()
  assert ap.shape == (64, 5)
  assert np.abs(ap).max() <= 1.0
  np.testing.assert_allclose(ap, aj, rtol=1e-5, atol=1e-6)


def test_params_loader_refuses_other_globals(tmp_path):
  import pickle

  path = tmp_path / 'evil.pkl'
  path.write_bytes(pickle.dumps((os.getcwd, {})))
  try:
    pnets.load_ppo_params(str(path))
  except pickle.UnpicklingError as e:
    assert 'posix.getcwd' in str(e) or 'getcwd' in str(e)
  else:
    raise AssertionError('loaded a pickle naming os.getcwd')


def test_slice_matches_jax(monkeypatch):
  jenv = jwrappers.wrap_for_training(jenvs.load(ENV), episode_length=1200)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(2), B))
  jpolicy = jax.jit(_jax_policy())

  base = penvs.load(ENV, device='cpu')
  d = jstate.data
  init = tuple(torch.from_numpy(np.array(x)) for x in (d.qpos, d.qvel, d.ctrl))
  monkeypatch.setattr(base, 'sample_init', lambda generator, batch: init)
  penv = pwrappers.wrap_for_training(base, episode_length=1200, num_envs=B)
  pstate = penv.reset(torch.Generator().manual_seed(0))
  ppolicy = _port_policy()
  np.testing.assert_allclose(pstate.obs.numpy(), np.asarray(jstate.obs),
                             rtol=1e-5, atol=1e-5)

  monkeypatch.setattr(jlk, '_INTERPRET', True)
  jFF._CACHE.clear()
  try:
    jstep = jax.jit(jenv.step)
    for _ in range(3):
      jstate = jstep(jstate, jpolicy(jstate.obs))
      with torch.no_grad():
        pstate = penv.step(pstate, ppolicy(pstate.obs))
      np.testing.assert_allclose(pstate.obs.numpy(), np.asarray(jstate.obs),
                                 rtol=1e-2, atol=1e-2)
      np.testing.assert_allclose(pstate.reward.numpy(),
                                 np.asarray(jstate.reward), rtol=1e-2)
      np.testing.assert_array_equal(pstate.done.numpy(),
                                    np.asarray(jstate.done))
  finally:
    jFF._CACHE.clear()
  assert np.isfinite(pstate.obs.numpy()).all()
  assert pstate.info['steps'].tolist() == [3.0] * B
