"""How far the two packages' T-push rollouts part, reset by reset.

    JAX_PLATFORMS=cpu python tests/torch_tpush_parting.py [KEY ...]

From the JAX reset of ``jax.random.split(PRNGKey(KEY), 3)`` (keys 0 and 4
by default; 4 is tests/test_torch_tpush.py's) of the wrapped
``AirbotTPush`` env, the seeded policy of that test (``_policy_params``:
a PPO network at the Airbot widths, deterministic) drives 3 control steps
in three runs: the JAX package in fp32 (the Pallas kernels in interpret
mode), the port on the CPU in fp32 and the port on the CPU in float64
(policy in fp32 on fp32 observations).  It prints, after each control
step and for each env, the largest observation gap of JAX fp32 and of the
port's fp32 to the port's float64, and between the two fp32 runs.  About
a minute per key on 8 CPU cores.
"""

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def main(keys) -> None:
  os.environ['JAX_PLATFORMS'] = 'cpu'
  sys.path.insert(0, ROOT)
  sys.path.insert(0, os.path.join(ROOT, 'tests'))
  import jax
  import torch

  from rsr_mjx_tpu import envs as jenvs
  from rsr_mjx_tpu.envs import wrappers as jwrappers
  from rsr_mjx_tpu.physics import fwd_fused as jFF
  from rsr_mjx_tpu.physics import linalg_kernels as jlk
  from rsr_mjx_tpu.train import configs as jconfigs
  from rsr_mjx_tpu.train import networks as jnets
  from rsr_mjx_tpu.train import ppo as jppo
  from rsr_mjx_tpu.train import running_statistics as jrs
  from rsr_mjx_tpu.train import sac as jsac
  from rsr_mjx_tpu_torch import envs as penvs
  from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
  from rsr_mjx_tpu_torch.train import networks as pnets
  from test_torch_tpush import B, ENV, _policy_params

  path = _policy_params(os.path.join(tempfile.mkdtemp(), 'p.pkl'))
  nf = jconfigs.ppo_config(ENV)['network_factory']
  jnet = jnets.make_ppo_networks(
      16, 5, policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes))
  jpol = jppo._make_policy_factory(jnet, jrs.normalize)(
      jsac.load_params(path), deterministic=True)
  jpolicy = jax.jit(lambda obs: jpol(obs, jax.random.PRNGKey(0))[0])
  ppolicy = pnets.make_policy(*pnets.load_ppo_params(path), device='cpu')
  jenv = jwrappers.wrap_for_training(jenvs.load(ENV), episode_length=1200)
  jreset = jax.jit(jenv.reset)
  jlk._INTERPRET = True
  jFF._CACHE.clear()
  jstep = jax.jit(jenv.step)
  torch.set_grad_enabled(False)
  for key in keys:
    jstate = jreset(jax.random.split(jax.random.PRNGKey(key), B))
    d = jstate.data
    init = tuple(torch.from_numpy(np.array(x)) for x in (d.qpos, d.qvel,
                                                        d.ctrl))
    runs = {}
    for dtype in (torch.float32, torch.float64):
      base = penvs.load(ENV, device='cpu', dtype=dtype)
      base.sample_init = lambda g, b, dtype=dtype: tuple(
          x.to(dtype) for x in init)
      env = pwrappers.wrap_for_training(base, episode_length=1200,
                                        num_envs=B)
      runs[dtype] = (env, env.reset(torch.Generator().manual_seed(0)))
    for step in range(1, STEPS + 1):
      jstate = jstep(jstate, jpolicy(jstate.obs))
      obs = {}
      for dtype, (env, state) in runs.items():
        state = env.step(state, ppolicy(state.obs.float()).to(dtype))
        runs[dtype] = (env, state)
        obs[dtype] = state.obs.double().numpy()
      j32 = np.asarray(jstate.obs, np.float64)
      gap = lambda a, b: np.abs(a - b).max(axis=1)
      p32, p64 = obs[torch.float32], obs[torch.float64]
      print(f'key {key} step {step}: per env, jax32 - port64 '
            f'{gap(j32, p64)}, port32 - port64 {gap(p32, p64)}, '
            f'jax32 - port32 {gap(j32, p32)}', flush=True)
  jFF._CACHE.clear()


if __name__ == '__main__':
  main([int(k) for k in sys.argv[1:]] or [0, 4])
