"""The trained getup policy's outcome over a full episode, in both packages.

    JAX_PLATFORMS=cpu python tests/torch_getup_outcome.py [--envs 8] \\
        [--episode_length 500] [--key 0]

From the JAX resets of ``jax.random.split(PRNGKey(KEY), ENVS)`` of the
wrapped ``Go2Getup`` env (the default config: observation noise on, a drop
from height with probability 0.6), the trained policy of
``logs/go2_getup_5M_r5/final_params.pkl`` runs deterministically for one
episode of ``scripts/eval_go2.py``'s default length in two processes:

  jax   the JAX package: its reset (draws and 125-substep settle), its
        jitted ``step``, the policy of ``ppo._make_policy_factory``;
  port  the port on the CPU in fp32: JAX's pre-settle draws handed to
        ``Getup.reset_to`` (which settles as JAX's reset does), then
        ``train.eval_go2.rollout``.

The episodes cannot be compared step by step: a getup starts in deep
contact, where fp32 trajectories part in any summation order, and the
observation noise comes from each package's own stream.  So it prints the
statistics of ``train.eval_go2.summarize`` for both: the mean
uprightness −g_z/|g| over alive steps, the share of envs upright at their
last alive step by the env's own criterion (gravity within 0.01 of
straight down, squared), and the reward per alive step, with each env's
uprightness at the end.  The port's full scene takes about 1 s a control
step at 8 envs on 8 CPU cores, JAX's per-env route about 0.2 s.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(ROOT, 'logs', 'go2_getup_5M_r5', 'final_params.pkl')
ENV = 'Go2Getup'


def jax_draws(key: int, n: int):
  """JAX's reset draws of the n envs of ``key``, before the settle
  (getup.py:115-130), and the wrapped JAX env's reset."""
  import jax
  import jax.numpy as jnp

  from rsr_mjx_tpu import envs as jenvs

  env = jenvs.load(ENV)
  keys = jax.random.split(jax.random.PRNGKey(key), n)

  def draws(k):
    rng, key1, key2 = jax.random.split(k, 3)
    qpos = jnp.where(
        jax.random.bernoulli(key1, env._config.drop_from_height_prob),
        env._get_random_qpos(key2), env._init_q)
    rng, k3 = jax.random.split(rng)
    qvel = jnp.zeros(env.model.nv).at[0:6].set(
        jax.random.uniform(k3, (6,), minval=-0.5, maxval=0.5))
    return qpos, qvel

  qpos, qvel = jax.vmap(draws)(keys)
  return env, keys, np.asarray(qpos), np.asarray(qvel)


def run(mode: str, key: int, n: int, length: int, out: str) -> None:
  """One package's episode; saves rewards, dones, uprightness and the
  upright flag, each (length, n), to ``out``."""
  os.environ['JAX_PLATFORMS'] = 'cpu'
  sys.path.insert(0, ROOT)
  env_j, keys, qpos, qvel = jax_draws(key, n)
  if mode == 'jax':
    import jax
    import jax.numpy as jnp

    from rsr_mjx_tpu.envs import wrappers as jwrappers
    from rsr_mjx_tpu.train import configs, ppo, running_statistics, sac
    from rsr_mjx_tpu.train import networks as jnets

    nf = configs.ppo_config(ENV).network_factory
    net = jnets.make_ppo_networks(
        {'state': (42,), 'privileged_state': (91,)}, 12,
        policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
        value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes),
        policy_obs_key=nf.policy_obs_key, value_obs_key=nf.value_obs_key)
    policy = ppo._make_policy_factory(net, running_statistics.normalize)(
        sac.load_params(PARAMS), deterministic=True)
    env = jwrappers.wrap_for_training(env_j, episode_length=length)
    state = jax.jit(env.reset)(keys)

    @jax.jit
    def step(s):
      ns = env.step(s, policy(s.obs, jax.random.PRNGKey(0))[0])
      grav = jax.vmap(env_j.get_gravity)(ns.data)
      up = -grav[:, 2] / (jnp.linalg.norm(grav, axis=-1) + 1e-9)
      flag = jax.vmap(env_j._is_upright)(grav).astype(jnp.float32)
      return ns, (ns.reward, ns.done, up, flag)

    rows = []
    for _ in range(length):
      state, row = step(state)
      rows.append([np.asarray(x) for x in row])
    arrays = [np.stack(x) for x in zip(*rows)]
  else:
    import torch

    from rsr_mjx_tpu_torch import envs as penvs
    from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
    from rsr_mjx_tpu_torch.train import eval_go2, eval_policy

    base = penvs.load(ENV, device='cpu')
    init = dict(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    base.sample_init = lambda generator, batch: init
    env = pwrappers.wrap_for_training(base, episode_length=length,
                                      num_envs=n)
    gen = torch.Generator().manual_seed(key)
    policy = eval_policy.load_policy(PARAMS, ENV, device='cpu')
    rews, dones, up, _, flag = eval_go2.rollout(env, policy, env.reset(gen),
                                                length, joystick=False)
    arrays = [rews, dones, up, flag]
  np.savez(out, **dict(zip(('rews', 'dones', 'up', 'flag'), arrays)))


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--envs', type=int, default=8)
  p.add_argument('--episode_length', type=int, default=500)
  p.add_argument('--key', type=int, default=0)
  args = p.parse_args()
  sys.path.insert(0, ROOT)
  from rsr_mjx_tpu_torch.train import eval_go2

  with tempfile.TemporaryDirectory() as tmp:
    paths = {m: os.path.join(tmp, f'{m}.npz') for m in ('jax', 'port')}
    procs = [subprocess.Popen([sys.executable, __file__, '--run', m,
                               str(args.key), str(args.envs),
                               str(args.episode_length), path])
             for m, path in paths.items()]
    if any(p.wait() for p in procs):
      raise SystemExit('a rollout failed')
    runs = {m: dict(np.load(path)) for m, path in paths.items()}
  print(f'{ENV}, {args.envs} envs from the JAX resets of key {args.key}, '
        f'{args.episode_length} control steps, deterministic policy')
  for m, r in runs.items():
    s = eval_go2.summarize(r['rews'], r['dones'], r['up'],
                           np.zeros_like(r['up']), args.episode_length,
                           r['flag'])
    alive = s['ep_len'].sum()
    end = r['up'][s['ep_len'] - 1, np.arange(args.envs)]
    print(f'  {m:4s}: mean uprightness over alive steps {s["m_lin"]:.5f}; '
          f'upright at the end {s["upright_end"]:.5f}; reward per alive '
          f'step {s["ep_rew"].sum() / alive:.5f}; episode length mean '
          f'{s["ep_len"].mean():.1f}; finite {s["finite"]}')
    print(f'        -g_z/|g| at each env\'s end: '
          + ' '.join(f'{x:.3f}' for x in end))


if __name__ == '__main__':
  if sys.argv[1:2] == ['--run']:
    run(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
        sys.argv[6])
  else:
    main()
