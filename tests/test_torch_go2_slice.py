"""The port's Go2 joystick serving slice against the JAX package's.

1. The trained joystick policy (logs/go2_joystick_50M_r5/final_params.pkl,
   48→512→256→128→24, normalizer over a dict observation), its weights
   carried into the port by ``networks.make_policy(obs_key='state')``, against
   the JAX ``make_policy(deterministic=True)``; rtol 1e-5 (same fp32 MLP,
   other summation order).
2. The whole slice: a JAX reset of the wrapped env with the observation
   noise switched off is handed to the port (start state and every ``info``
   leaf), then both run 3 control steps of 5 substeps with the
   deterministic policy (the JAX Pallas kernels in interpret mode, the
   port's kernels as their plain versions).  ``state``, ``privileged_state``,
   reward, done and each ``reward/*`` metric are compared: 1e-5 at reset
   (kinematics and sensors only), the repo's post-solve tolerance 1e-2
   after steps (tests/test_fwd_fused.py).  ``steps_until_next_cmd`` is held
   above 3 on both sides so that no command is drawn (the two random
   streams differ by nature).
3. The port's random draws: noise stays inside ``level * scale`` of the
   noise-free observation block by block and is not zero; reset draws and
   resampled commands stay inside the reference's ranges.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.train import configs
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import ppo, running_statistics, sac
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.envs.config import Config
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.train import networks as pnets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(ROOT, 'logs', 'go2_joystick_50M_r5', 'final_params.pkl')
ENV = 'Go2JoystickFlatTerrain'
B = 3
NO_NOISE = {'noise_config.level': 0.0}
INIT_KEYS = ('command', 'steps_until_next_cmd', 'steps_until_next_pert',
             'pert_duration_seconds', 'pert_duration', 'pert_mag')


def _jax_policy():
  params = sac.load_params(PARAMS)
  nf = configs.ppo_config(ENV).network_factory
  net = jnets.make_ppo_networks(
      {'state': (48,), 'privileged_state': (123,)}, 12,
      policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes),
      policy_obs_key=nf.policy_obs_key, value_obs_key=nf.value_obs_key)
  make = ppo._make_policy_factory(net, running_statistics.normalize)
  policy = make(params, deterministic=True)
  return lambda obs: policy(obs, jax.random.PRNGKey(0))[0]


def _port_policy():
  normalizer, params = pnets.load_ppo_params(PARAMS)
  return pnets.make_policy(normalizer, params, device='cpu',
                           obs_key='state', value_obs_key='privileged_state')


def test_go2_policy_matches_jax():
  normalizer, params = pnets.load_ppo_params(PARAMS)
  assert [l['w'].shape for l in params['policy']] == [
      (48, 512), (512, 256), (256, 128), (128, 24)]
  rng = np.random.default_rng(0)
  obs = {k: (normalizer.mean[k] + normalizer.std[k]
             * rng.normal(size=(64,) + normalizer.mean[k].shape)
             ).astype(np.float32) for k in ('state', 'privileged_state')}
  aj = np.asarray(jax.jit(_jax_policy())(obs))
  policy = _port_policy()
  with torch.no_grad():
    ap = policy({k: torch.from_numpy(v) for k, v in obs.items()}).numpy()
    ap_sel = policy(torch.from_numpy(obs['state'])).numpy()
  assert ap.shape == (64, 12) and np.abs(ap).max() <= 1.0
  np.testing.assert_array_equal(ap, ap_sel)  # the dict or the selected entry
  np.testing.assert_allclose(ap, aj, rtol=1e-5, atol=1e-6)


def _obs_close(p, j, tol):
  for k in ('state', 'privileged_state'):
    np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]), rtol=tol,
                               atol=tol, err_msg=k)


def test_go2_slice_matches_jax(monkeypatch):
  jenv = jwrappers.wrap_for_training(
      jenvs.load(ENV, config_overrides=NO_NOISE), episode_length=1000)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), B))
  far = jnp.full((B,), 50, jnp.int32)  # no command change within 3 steps
  jstate.info['steps_until_next_cmd'] = far
  jstate.info['first_info']['steps_until_next_cmd'] = far
  jpolicy = jax.jit(_jax_policy())

  base = penvs.load(ENV, device='cpu', config_overrides=NO_NOISE)
  t = lambda x: torch.from_numpy(np.array(x))
  init = dict(qpos=t(jstate.data.qpos), qvel=t(jstate.data.qvel),
              **{k: t(jstate.info[k]) for k in INIT_KEYS})
  monkeypatch.setattr(base, 'sample_init', lambda generator, batch: init)
  penv = pwrappers.wrap_for_training(base, episode_length=1000, num_envs=B)
  pstate = penv.reset(torch.Generator().manual_seed(0))
  ppolicy = _port_policy()

  # every info leaf of the JAX reset has its counterpart, equal at reset
  for k, v in jstate.info.items():
    if k in ('rng', 'first_info', 'first_data', 'first_obs'):
      continue
    pv = pstate.info[k]
    assert tuple(pv.shape) == tuple(v.shape), k
    assert str(pv.dtype).split('.')[-1] == str(v.dtype), k
    np.testing.assert_allclose(pv.numpy(), np.asarray(v), atol=1e-6,
                               err_msg=k)
  assert isinstance(pstate.info['rng'], torch.Generator)
  assert set(pstate.metrics) == set(jstate.metrics)
  _obs_close(pstate.obs, jstate.obs, 1e-5)
  _obs_close(pstate.info['first_obs'], jstate.info['first_obs'], 1e-5)

  monkeypatch.setattr(jlk, '_INTERPRET', True)
  jFF._CACHE.clear()
  plk.LAUNCHES.update(dict.fromkeys(plk.LAUNCHES, 0))
  try:
    jstep = jax.jit(jenv.step)
    for _ in range(3):
      jstate = jstep(jstate, jpolicy(jstate.obs))
      with torch.no_grad():
        pstate = penv.step(pstate, ppolicy(pstate.obs))
      _obs_close(pstate.obs, jstate.obs, 1e-2)
      np.testing.assert_allclose(pstate.reward.numpy(),
                                 np.asarray(jstate.reward), rtol=1e-2,
                                 atol=1e-4)
      np.testing.assert_array_equal(pstate.done.numpy(),
                                    np.asarray(jstate.done))
      for k, v in jstate.metrics.items():
        np.testing.assert_allclose(pstate.metrics[k].numpy(), np.asarray(v),
                                   rtol=1e-2, atol=1e-3, err_msg=k)
      np.testing.assert_array_equal(pstate.info['last_contact'].numpy(),
                                    np.asarray(jstate.info['last_contact']))
  finally:
    jFF._CACHE.clear()
  assert np.isfinite(pstate.obs['privileged_state'].numpy()).all()
  assert pstate.info['steps'].tolist() == [3.0] * B
  assert pstate.info['steps_until_next_cmd'].tolist() == [47] * B
  np.testing.assert_allclose(pstate.info['action_buffer'].numpy(),
                             np.asarray(jstate.info['action_buffer']),
                             rtol=1e-2, atol=1e-2)
  # CPU tensors take the plain versions: nothing was launched
  assert not any(plk.LAUNCHES.values())


def test_go2_noise_stays_in_its_blocks():
  """With noise level 1 the 48-dim state differs from the noise-free one,
  block by block within level * scale; the other blocks and the privileged
  tail are untouched."""
  quiet = penvs.load(ENV, device='cpu', config_overrides=NO_NOISE)
  noisy = penvs.load(ENV, device='cpu')
  init = quiet.sample_init(torch.Generator().manual_seed(3), 4)
  s0 = quiet.reset_to(init, torch.Generator().manual_seed(4))
  s1 = noisy.reset_to(init, torch.Generator().manual_seed(4))
  a = torch.zeros(4, 12)
  for _ in range(5):  # fill the imu delay buffers
    s0, s1 = quiet.step(s0, a), noisy.step(s1, a)
  sc = noisy._config.noise_config.scales
  diff = (s1.obs['state'] - s0.obs['state']).abs()
  blocks = (('linvel', 0, 3), ('gyro', 3, 6), ('gravity', 6, 9),
            ('joint_pos', 9, 21), ('joint_vel', 21, 33))
  for name, lo, hi in blocks:
    d = diff[:, lo:hi]
    assert (d <= sc[name] * (1 + 1e-5)).all(), name
    assert d.max() > 0.1 * sc[name], name
  assert (diff[:, 33:] == 0).all()  # last action and command
  np.testing.assert_array_equal(s1.obs['privileged_state'][:, 48:].numpy(),
                                s0.obs['privileged_state'][:, 48:].numpy())
  np.testing.assert_array_equal(s1.data.qpos.numpy(), s0.data.qpos.numpy())


def test_go2_random_draws_stay_in_range():
  env = penvs.load(ENV, device='cpu')
  n = 4096
  gen = torch.Generator().manual_seed(5)
  init = env.sample_init(gen, n)
  home = env.keyframe_qpos('home')
  assert ((init['qpos'][:, :2] - torch.tensor(home[:2])).abs() <= 0.5).all()
  np.testing.assert_allclose(init['qpos'][:, 3:7].norm(dim=1).numpy(), 1.0,
                             atol=1e-6)
  assert (init['qpos'][:, 4:6] == 0).all()  # a yaw rotation only
  yaw = 2 * torch.atan2(init['qpos'][:, 6], init['qpos'][:, 3])
  assert yaw.abs().max() <= 3.14 + 1e-5 and yaw.abs().max() > 3.0
  np.testing.assert_array_equal(init['qpos'][:, 7:].numpy(),
                                np.broadcast_to(home[7:], (n, 12)))
  assert (init['qvel'][:, :6].abs() <= 0.5).all()
  assert (init['qvel'][:, 6:] == 0).all()
  a = torch.tensor([0.8, 0.0, 2.0])
  assert (init['command'].abs() <= a).all()
  assert init['command'][:, 0].abs().max() > 0.7
  for key, (lo, hi) in (('steps_until_next_pert', (50, 150)),
                        ('pert_duration', (2, 10))):
    assert init[key].dtype == torch.int32
    assert lo <= init[key].min() and init[key].max() <= hi, key
  assert (0.05 <= init['pert_duration_seconds']).all()
  assert (init['pert_duration_seconds'] <= 0.2).all()
  assert (0 <= init['pert_mag']).all() and (init['pert_mag'] <= 3).all()
  # exponential interval, mean 12 s = 600 control steps
  steps = init['steps_until_next_cmd'].float()
  assert steps.min() >= 0 and abs(steps.mean().item() - 600) < 40
  # the Bernoulli-masked random walk keeps |command| within a, leaves the
  # lateral command at 0, and moves about half of the others
  x = init['command']
  y = env.sample_command(gen, x)
  assert (y.abs() <= a).all() and (y[:, 1] == 0).all()
  moved = (y[:, 0] != x[:, 0]).float().mean().item()
  assert 0.4 < moved < 0.6
  zeroed = (y[:, 0] == 0).float().mean().item()  # w = 1 and z = 0: 0.5 * 0.2
  assert 0.05 < zeroed < 0.15


def test_go2_perturbation_kicks():
  """With kicks enabled each env waits, is pushed along a unit direction in
  the plane for its kick duration, and waits again."""
  env = penvs.load(ENV, device='cpu',
                   config_overrides={'pert_config.enable': True})
  gen = torch.Generator().manual_seed(6)
  init = env.sample_init(gen, 3)
  init['steps_until_next_pert'] = torch.tensor([1, 2, 60], dtype=torch.int32)
  init['pert_duration'] = torch.tensor([2, 3, 5], dtype=torch.int32)
  s = env.reset_to(init, gen)
  torso = env._torso_body_id
  pushed = []
  for _ in range(7):
    s = env.step(s, torch.zeros(3, 12))
    pushed.append(s.data.xfrc_applied[:, torso, :3].norm(dim=1) > 0)
    assert (s.data.xfrc_applied[:, torso, 2] == 0).all()
  pushed = torch.stack(pushed).t().tolist()
  # the first kick step has u_t = sin(0) = 0: force from the second on
  assert pushed[0] == [False, False, True, True, False, False, True]
  assert pushed[1] == [False, False, False, True, True, True, False]
  assert pushed[2] == [False] * 7
  norms = s.info['pert_dir'].norm(dim=1)
  np.testing.assert_allclose(norms[:2].numpy(), 1.0, atol=1e-6)
  assert norms[2] == 0 and s.info['steps_since_last_pert'][2] == 7
  assert s.obs['privileged_state'].shape == (3, 123)


def test_go2_config_and_registry():
  cfg = penvs.get_default_config(ENV)
  jcfg = jenvs.get_default_config(ENV)
  assert isinstance(cfg, Config) and cfg == jcfg.to_dict()
  assert len(cfg.reward_config.scales) == 21
  with pytest.raises(KeyError):
    cfg.update_from_flattened_dict({'noise_config.levle': 0.0})
  # an override of sim_dt reaches the model and the step count; as in the
  # JAX env, Kp and Kd come from the config handed in, before the
  # overrides, so their overrides do not reach the model in either package
  over = {'sim_dt': 0.005, 'Kp': 40.0, 'Kd': 2.0}
  env = penvs.load(ENV, device='cpu', config_overrides=over)
  m = env.model
  jm = jenvs.load(ENV, config_overrides=over).model
  assert env.n_substeps == 4 and float(m.opt.timestep) == np.float32(0.005)
  assert float(jm.opt.timestep) == np.float32(0.005)
  for name in ('actuator_gainprm', 'actuator_biasprm', 'dof_damping'):
    np.testing.assert_array_equal(getattr(m, name).numpy(),
                                  np.asarray(getattr(jm, name)), err_msg=name)
  assert float(m.actuator_gainprm[3, 0]) == 60.0
  assert float(m.actuator_biasprm[3, 1]) == -60.0
  assert float(m.dof_damping[7]) == cfg.Kd and float(m.dof_damping[5]) == 0.0
  assert cfg.Kp == 60.0  # the defaults are not touched
  # every Go2 task is registered and loads on the CPU with its scene
  sizes = {'Go2JoystickFlatTerrain': 4, 'Go2JoystickRoughTerrain': 4,
           'Go2Getup': 156, 'Go2Handstand': 156, 'Go2Footstand': 156}
  for name, ncon in sizes.items():
    assert name in penvs.registered_envs()
    mo = penvs.load(name, device='cpu').model
    assert (mo.nq, mo.nv, mo.ncon) == (19, 18, ncon), name
  with pytest.raises(ValueError, match='unknown env'):
    penvs.load('Go2Backflip', device='cpu')


def test_go2_float64_reference_path():
  """The CPU path also runs in float64 and stays close to fp32."""
  gen = torch.Generator().manual_seed(7)
  e32 = penvs.load(ENV, device='cpu', config_overrides=NO_NOISE)
  e64 = penvs.load(ENV, device='cpu', dtype=torch.float64,
                   config_overrides=NO_NOISE)
  init = e32.sample_init(gen, 2)
  s32, s64 = e32.reset_to(init, gen), e64.reset_to(init, gen)
  a = torch.full((2, 12), 0.1)
  s32, s64 = e32.step(s32, a), e64.step(s64, a.double())
  assert s64.obs['state'].dtype == torch.float64
  assert s64.data.sensordata.dtype == torch.float64
  np.testing.assert_allclose(s32.obs['privileged_state'].numpy(),
                             s64.obs['privileged_state'].numpy(),
                             rtol=1e-2, atol=1e-2)


def test_go2_env_needs_neither_mujoco_nor_jax():
  """Loading and stepping the Go2 env imports no mujoco, jax or
  ml_collections (the card machine has no mujoco)."""
  code = (
      'import sys, torch\n'
      'from rsr_mjx_tpu_torch import envs\n'
      "env = envs.load('Go2JoystickFlatTerrain', device='cpu')\n"
      's = env.reset(torch.Generator().manual_seed(0), 1)\n'
      's = env.step(s, torch.zeros(1, 12))\n'
      "bad = [m for m in ('mujoco', 'jax', 'ml_collections', 'rsr_mjx_tpu')"
      ' if m in sys.modules]\n'
      'assert not bad, bad\n'
      "print('ok', tuple(s.obs['state'].shape))\n"
  )
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
  assert out.stdout.strip().endswith('ok (1, 48)')
