"""The Go2 joystick's tracking errors in both packages from the same resets.

    JAX_PLATFORMS=cpu python tests/torch_joystick_tracking.py [ENVS] [STEPS]

From the JAX reset of ``jax.random.split(PRNGKey(7), ENVS)`` (16 by
default) of the wrapped ``Go2JoystickFlatTerrain`` env with the
observation noise off and the command held (no resampling within the
run), the trained policy of ``logs/go2_joystick_50M_r5`` runs
deterministically for STEPS control steps (300) in the JAX package (its
jitted step on its per-env route) and in the port on the CPU
(``train.eval_go2.rollout`` from JAX's reset, handed over as
``tests/test_torch_eval.py`` does).  It prints the mean linear and
angular tracking errors of ``scripts/eval_go2.py`` over the first 100,
200 and STEPS steps in both, and each env's angular error over the last
50 steps: the errors of a sample of episodes depend on which commands it
draws, so this holds the packages to each other on the same commands.
About 3 minutes on 8 CPU cores.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

import test_torch_eval as te  # noqa: E402
from rsr_mjx_tpu import envs as jenvs  # noqa: E402
from rsr_mjx_tpu.envs import wrappers as jwrappers  # noqa: E402
from rsr_mjx_tpu_torch import envs as penvs  # noqa: E402
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers  # noqa: E402
from rsr_mjx_tpu_torch.train import eval_go2, eval_policy  # noqa: E402


def main(n: int, steps: int) -> None:
  name, path = te.JOYSTICK
  jbase = jenvs.load(name, config_overrides=te.NO_NOISE)
  jenv = jwrappers.wrap_for_training(jbase, episode_length=1000)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(7), n))
  held = jnp.full((n,), 100000, jnp.int32)
  jstate.info['steps_until_next_cmd'] = held
  jstate.info['first_info']['steps_until_next_cmd'] = held
  t = lambda x: torch.from_numpy(np.array(x))
  init = dict(qpos=t(jstate.data.qpos), qvel=t(jstate.data.qvel),
              **{k: t(jstate.info[k]) for k in te.JOYSTICK_INIT})
  base = penvs.load(name, device='cpu', config_overrides=te.NO_NOISE)
  base.sample_init = lambda generator, batch: init
  penv = pwrappers.wrap_for_training(base, episode_length=1000, num_envs=n)
  policy = eval_policy.load_policy(path, name, device='cpu')
  port = eval_go2.rollout(penv, policy,
                          penv.reset(torch.Generator().manual_seed(0)),
                          steps, joystick=True)

  jpolicy = te._jax_policy(name, path, jbase)
  jstep = jax.jit(jenv.step)
  rows, s = [], jstate
  for _ in range(steps):
    s = jstep(s, jpolicy(s.obs))
    cmd = s.info['command']
    linvel = jax.vmap(jbase.get_local_linvel)(s.data)
    gyro = jax.vmap(jbase.get_gyro)(s.data)
    rows.append([np.asarray(x) for x in (
        jnp.linalg.norm(cmd[:, :2] - linvel[:, :2], axis=-1),
        jnp.abs(cmd[:, 2] - gyro[:, 2]), s.done)])
  lin, ang, done = (np.stack(x) for x in zip(*rows))
  print(f'{name}, {n} envs from the JAX reset of key 7, command held, '
        f'noise off, {steps} control steps')
  for w in sorted({min(100, steps), min(200, steps), steps}):
    print(f'  first {w} steps: ang err port {port[3][:w].mean():.4f} jax '
          f'{ang[:w].mean():.4f}; lin err port {port[2][:w].mean():.4f} '
          f'jax {lin[:w].mean():.4f}; dones port {int(port[1][:w].sum())} '
          f'jax {int(done[:w].sum())}')
  fmt = lambda x: ' '.join(f'{v:.3f}' for v in x)
  print(f'  ang err of each env over the last 50 steps, port: '
        f'{fmt(port[3][-50:].mean(0))}')
  print(f'  ang err of each env over the last 50 steps, jax:  '
        f'{fmt(ang[-50:].mean(0))}')


if __name__ == '__main__':
  args = [int(a) for a in sys.argv[1:]]
  main(*(args + [16, 300][len(args):]))
