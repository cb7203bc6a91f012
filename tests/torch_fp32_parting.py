"""Which cube-push envs part from float64 in fp32, in each package.

    JAX_PLATFORMS=cpu python tests/torch_fp32_parting.py [KEY ...]

From the JAX reset of ``jax.random.split(PRNGKey(KEY), 3)`` (keys 2 and 3
by default, the start states of tests/test_torch_slice.py) of the wrapped
``AirbotCubePushTrain`` env, the trained PPO policy
(logs/cube_ppo_15M_r4/final_params.pkl, deterministic, in fp32 on fp32
observations) drives 3 control steps in four runs, each in a process of its
own:

  jax32   the JAX package in fp32, the Pallas kernels in interpret mode;
  jax64   the JAX package under ``jax_enable_x64`` with the model and the
          state cast to float64, the same kernels asked for;
  port32  the port on the CPU in fp32 (the kernels' plain versions);
  port64  the port on the CPU in float64.

It prints, after each control step and for each env, the largest
observation gap between runs.  The JAX package takes its lanes route (the
kernels) only in fp32 (``physics/fwd_fused.py:224``): under x64 it takes
the per-env chain with the adaptive solver, another algorithm, so jax64
is printed beside the others but the float64 reference of the lanes route
is port64.  Takes about a minute on 8 CPU cores.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(ROOT, 'logs', 'cube_ppo_15M_r4', 'final_params.pkl')
ENV = 'AirbotCubePushTrain'
B, STEPS = 3, 3
MODES = ('jax32', 'jax64', 'port32', 'port64')


def rollout(mode: str, key: int, out: str) -> None:
  """Run one of MODES from the reset of ``key``; save the observations
  (STEPS + 1, B, 23) as float64 to ``out``."""
  os.environ['JAX_PLATFORMS'] = 'cpu'
  sys.path.insert(0, ROOT)
  import jax
  import jax.numpy as jnp

  if mode == 'jax64':
    jax.config.update('jax_enable_x64', True)
  from rsr_mjx_tpu import envs as jenvs
  from rsr_mjx_tpu.envs import wrappers as jwrappers
  from rsr_mjx_tpu.physics import fwd_fused as jFF
  from rsr_mjx_tpu.physics import linalg_kernels as jlk
  from rsr_mjx_tpu.train import networks as jnets
  from rsr_mjx_tpu.train import ppo, running_statistics, sac

  net = jnets.make_ppo_networks(23, 5, policy_hidden_layer_sizes=(32,) * 4,
                                value_hidden_layer_sizes=(256,) * 5)
  policy = jax.jit(ppo._make_policy_factory(net, running_statistics.normalize)(
      sac.load_params(PARAMS), deterministic=True))
  base = jenvs.load(ENV)
  state = jax.jit(jwrappers.wrap_for_training(base, episode_length=1200).reset)(
      jax.random.split(jax.random.PRNGKey(key), B))
  obs = [np.asarray(state.obs, np.float64)]
  act = lambda o: policy(jnp.asarray(o, jnp.float32), jax.random.PRNGKey(0))[0]

  if mode.startswith('jax'):
    if mode == 'jax64':
      cast = lambda tree: jax.tree.map(
          lambda x: x.astype(jnp.float64)
          if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)
      base._model = cast(base._model)
      state = cast(state)
    step = jax.jit(jwrappers.wrap_for_training(base, episode_length=1200).step)
    jlk._INTERPRET = True
    jFF._CACHE.clear()
    for _ in range(STEPS):
      state = step(state, act(state.obs).astype(state.obs.dtype))
      obs.append(np.asarray(state.obs, np.float64))
  else:
    import torch

    from rsr_mjx_tpu_torch import envs as penvs
    from rsr_mjx_tpu_torch.envs import wrappers as pwrappers

    dtype = torch.float64 if mode == 'port64' else torch.float32
    pbase = penvs.load(ENV, device='cpu', dtype=dtype)
    init = tuple(torch.from_numpy(np.array(x)).to(dtype)
                 for x in (state.data.qpos, state.data.qvel, state.data.ctrl))
    pbase.sample_init = lambda generator, batch: init
    penv = pwrappers.wrap_for_training(pbase, episode_length=1200,
                                       num_envs=B)
    ps = penv.reset(torch.Generator().manual_seed(0))
    with torch.no_grad():
      for _ in range(STEPS):
        a = torch.from_numpy(np.array(act(ps.obs.float().numpy())))
        ps = penv.step(ps, a.to(dtype))
        obs.append(ps.obs.double().numpy())
  np.save(out, np.stack(obs))


def main(keys) -> None:
  with tempfile.TemporaryDirectory() as tmp:
    for key in keys:
      runs = {m: os.path.join(tmp, f'{m}_{key}.npy') for m in MODES}
      procs = [subprocess.Popen([sys.executable, __file__, '--run', m,
                                 str(key), path])
               for m, path in runs.items()]
      if any(p.wait() for p in procs):
        raise SystemExit(f'a rollout from key {key} failed')
      obs = {m: np.load(path) for m, path in runs.items()}
      print(f'reset key {key}, {B} envs: max |obs gap| after control step '
            '1, 2, 3 (rows), env by env (columns)')
      for a, b in (('port32', 'port64'), ('jax32', 'port64'),
                   ('jax32', 'port32'), ('jax32', 'jax64'),
                   ('jax64', 'port64')):
        gap = np.abs(obs[a] - obs[b]).max(-1)[1:]
        rows = '; '.join(' '.join(f'{g:.3g}' for g in row) for row in gap)
        print(f'  {a} - {b}: {rows}')


if __name__ == '__main__':
  if sys.argv[1:2] == ['--run']:
    rollout(sys.argv[2], int(sys.argv[3]), sys.argv[4])
  else:
    main([int(k) for k in sys.argv[1:]] or [2, 3])
