"""Deterministic task-level evaluation of a trained cube-push policy.

Counterpart of ``scripts/eval_policy.py``: the training-time evaluation (a
stochastic policy, the shaping reward) hides whether the arm pushes the
cube to the target; this runs ``--episodes`` episodes of the policy's mode
(``--stochastic``: its samples) and reports the episode length and reward,
the closest cube-to-target distance of each episode and the shares under
5 cm, 2 cm and 8 mm (the real robot's success threshold).  The flags and
defaults are the JAX script's, plus ``--device``; the parameters are a
PPO or SAC ``final_params.pkl`` of either package.

    python -m rsr_mjx_tpu_torch.train.eval_policy \\
        logs/cube_ppo_15M_r4/final_params.pkl [--stochastic] \\
        [--algo ppo|sac] [--device cuda]

The pieces: ``load_policy``, ``rollout`` (the episodes, on the device),
``summarize`` (the JAX script's numpy post-processing) and ``print_summary``
(its lines).
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('params_path')
  p.add_argument('--env', default='AirbotCubePushTrain')
  p.add_argument('--episodes', type=int, default=128)
  p.add_argument('--episode_length', type=int, default=1200)
  p.add_argument('--stochastic', action='store_true')
  p.add_argument('--algo', default='ppo', choices=['ppo', 'sac'])
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--device', default='cuda',
                 help="device of the envs and the policy ('cpu' for a run "
                      "with the kernels' plain versions)")
  return p.parse_args(argv)


def load_policy(params_path: str, env_name: str, algo: str = 'ppo',
                stochastic: bool = False, device='cuda',
                generator: torch.Generator = None) -> Callable:
  """obs → action of the pickled parameters: PPO with the observation keys
  of the env's tuned config, or the SAC policy; the mode, or with
  ``stochastic`` a sample drawn from ``generator``."""
  from rsr_mjx_tpu_torch.train import configs
  from rsr_mjx_tpu_torch.train import networks as ppo_networks
  from rsr_mjx_tpu_torch.train import running_statistics, sac, sac_networks

  normalizer, params = sac.load_params(params_path)
  if algo == 'sac':
    act = sac_networks.make_policy(normalizer, params, device=device,
                                   deterministic=not stochastic)
    return lambda obs: act(obs, generator)
  nf = configs.ppo_config(env_name).network_factory
  weights = ppo_networks.networks_from_numpy(
      normalizer, params, device, nf.get('policy_obs_key', 'state'),
      nf.get('value_obs_key', 'state'))
  policy = ppo_networks.make_inference_fn(
      weights[1], running_statistics.normalize)(
          weights, deterministic=not stochastic)
  return lambda obs: policy(obs, generator)[0]


@torch.no_grad()
def rollout(env, policy: Callable, state,
            episode_length: int) -> Tuple[np.ndarray, ...]:
  """``episode_length`` control steps of ``policy`` from ``state`` in the
  wrapped env; returns (rewards, dones, cube-to-target distance), each
  (T, B) numpy.  The distance is ‖obs[:, −6:−3]‖, the target-to-cube
  vector of the observation's tail."""
  rews, dones, dists = [], [], []
  for _ in range(episode_length):
    state = env.step(state, policy(state.obs))
    rews.append(state.reward)
    dones.append(state.done)
    dists.append(torch.linalg.vector_norm(state.obs[:, -6:-3], dim=-1))
  return tuple(torch.stack(x).cpu().numpy() for x in (rews, dones, dists))


def summarize(rews: np.ndarray, dones: np.ndarray, dists: np.ndarray,
              episode_length: int) -> Dict[str, np.ndarray]:
  """Each episode's end (its first done, else the last step), reward up to
  it and closest distance up to it, as ``scripts/eval_policy.py``."""
  first_done = np.argmax(dones > 0, axis=0)
  first_done[~(dones > 0).any(axis=0)] = episode_length - 1
  idx = np.arange(dones.shape[1])
  min_dist = np.array([dists[: first_done[e] + 1, e].min() for e in idx])
  ep_rew = np.array([rews[: first_done[e] + 1, e].sum() for e in idx])
  return dict(first_done=first_done, min_dist=min_dist, ep_rew=ep_rew)


def print_summary(env_name: str, stochastic: bool, s) -> None:
  """The JAX script's lines."""
  first_done, min_dist, ep_rew = s['first_done'], s['min_dist'], s['ep_rew']
  mode = 'stochastic' if stochastic else 'deterministic'
  print(f'{env_name} {mode} eval over {len(ep_rew)} episodes:')
  print(f'  episode length:  mean {first_done.mean():.0f}')
  print(f'  episode reward:  mean {ep_rew.mean():.0f}  '
        f'median {np.median(ep_rew):.0f}')
  print(f'  min cube-target dist: mean {min_dist.mean():.4f}  '
        f'median {np.median(min_dist):.4f}')
  print(f'  success fraction:  <5cm {np.mean(min_dist < 0.05):.2f}   '
        f'<2cm {np.mean(min_dist < 0.02):.2f}   '
        f'<8mm {np.mean(min_dist < 0.008):.2f}')


def main(argv=None) -> Dict[str, np.ndarray]:
  """Evaluate as the flags say; returns the summary."""
  args = parse_args(argv)
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers

  gen = torch.Generator(device=args.device).manual_seed(args.seed)
  env0 = envs.load(args.env, device=args.device)
  policy = load_policy(args.params_path, args.env, args.algo,
                       args.stochastic, args.device, gen)
  env = wrappers.wrap_for_training(env0, episode_length=args.episode_length,
                                   num_envs=args.episodes)
  out = rollout(env, policy, env.reset(gen), args.episode_length)
  summary = summarize(*out, args.episode_length)
  print_summary(args.env, args.stochastic, summary)
  return summary


if __name__ == '__main__':
  main()
