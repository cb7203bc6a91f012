"""Benchmark: control env-steps/s of a wrapped env under random actions.

Counterpart of ``bench.py`` (the JAX package's) with its accounting: the
env of ``envs.load(--env, max_contacts=--max_contacts)`` (``max_contacts``
for the Airbot envs only) under ``wrappers.wrap_for_training(
episode_length=1200, num_envs=--num_envs)``, reset from seed 0; actions
uniform in [-1, 1] from seed 1, of shape (steps, B, action_size); one
warm-up rollout of ``--steps`` control steps, then ``--reps`` timed
rollouts from where it ended.  A control step is the env's substeps (4 on
Airbot, 5 on Go2).  Each rollout is timed on its own, between two
``torch.cuda.synchronize``; its rate is steps·B / seconds.

    python -m rsr_mjx_tpu_torch.bench [--env AirbotCubePush] \\
        [--num_envs 2048] [--max_contacts 24] [--steps 50] [--reps 3]
    python -m rsr_mjx_tpu_torch.bench --env Go2JoystickFlatTerrain \\
        --num_envs 8192

Prints the rate of each rollout on a line, then, as the last line, ONE
JSON object {"metric", "value", "unit", "device"}: ``value`` the median of
the rates (the card machine's host varies), ``device`` the card's name and
power limit as ``nvidia-smi`` gives them.  ``bench.py``'s ``vs_baseline``
is left out: it divides by a figure of another accelerator.  It runs on
the card and raises where there is none; ``--device cpu`` exists for the
tests.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time
from typing import List

import torch

# the metric names of the JAX package's benchmarks (bench.py:68)
METRICS = {'AirbotCubePush': 'airbot_cube_push',
           'Go2JoystickFlatTerrain': 'go2_joystick_flat'}


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--env', default='AirbotCubePush', help='registered env')
  p.add_argument('--num_envs', type=int, default=2048, help='batch size')
  p.add_argument('--max_contacts', type=int, default=24,
                 help='contacts the Newton solve sees (Airbot envs)')
  p.add_argument('--steps', type=int, default=50,
                 help='control steps per rollout')
  p.add_argument('--reps', type=int, default=3, help='timed rollouts')
  p.add_argument('--device', default='cuda',
                 help="'cpu' runs the kernels' plain versions (tests)")
  return p.parse_args(argv)


def metric_name(env_name: str) -> str:
  """``<env in snake case>_env_steps_per_s``, the JAX names where they
  exist."""
  stem = METRICS.get(env_name) or re.sub(
      r'(?<=[a-z0-9])(?=[A-Z])', '_', env_name).lower()
  return f'{stem}_env_steps_per_s'


def device_line(device: str) -> str:
  """The card's name and power limit from ``nvidia-smi`` (the device name
  where it cannot be asked); 'cpu' on the CPU."""
  if torch.device(device).type != 'cuda':
    return 'cpu'
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    return out[index].strip()
  except (OSError, subprocess.SubprocessError, IndexError):
    return torch.cuda.get_device_name(device)


def _sync(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


@torch.no_grad()
def run(env_name: str = 'AirbotCubePush', num_envs: int = 2048,
        max_contacts: int = 24, steps: int = 50, reps: int = 3,
        device: str = 'cuda') -> List[float]:
  """The rates (control env-steps/s) of ``reps`` timed rollouts after one
  warm-up."""
  if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device: the benchmark runs on the card '
                       '(--device cpu for a test of the script)')
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers

  kwargs = ({'max_contacts': max_contacts} if env_name.startswith('Airbot')
            else {})
  env0 = envs.load(env_name, device=device, **kwargs)
  env = wrappers.wrap_for_training(env0, episode_length=1200,
                                   num_envs=num_envs)
  state = env.reset(torch.Generator(device=device).manual_seed(0))
  gen = torch.Generator(device=device).manual_seed(1)
  actions = torch.rand((steps, num_envs, env0.action_size), generator=gen,
                       device=device) * 2 - 1

  def rollout(state):
    for t in range(steps):
      state = env.step(state, actions[t])
    return state

  state = rollout(state)  # warm-up
  rates = []
  for _ in range(reps):
    _sync(device)
    t = time.perf_counter()
    state = rollout(state)
    _sync(device)
    rates.append(steps * num_envs / (time.perf_counter() - t))
  return rates


def main(argv=None) -> dict:
  """Run as the flags say; print the rates and the JSON line, return
  the line's object."""
  args = parse_args(argv)
  rates = run(args.env, args.num_envs, args.max_contacts, args.steps,
              args.reps, args.device)
  print(f'{args.env} B={args.num_envs} {args.steps} control steps x '
        f'{args.reps}: env-steps/s per rollout '
        + ' '.join(f'{r:.1f}' for r in rates), flush=True)
  line = {'metric': metric_name(args.env),
          'value': round(statistics.median(rates), 1),
          'unit': 'env-steps/s', 'device': device_line(args.device)}
  print(json.dumps(line), flush=True)
  return line


if __name__ == '__main__':
  main()
