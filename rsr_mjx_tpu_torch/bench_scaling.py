"""Scaling benchmark: env-steps/s over 1 to N devices, one process each.

Counterpart of ``scripts/bench_scaling.py``: the rollout hot loop (zero
actions through ``wrap_for_training(episode_length=1200)``, each rollout a
reset and ``--steps`` control steps) at ``--envs_per_device`` envs on each
device, for each count of ``--device_counts`` (default 1 and all).  One
warm-up rollout, then ``--reps`` timed ones; the rate is steps · envs ·
reps over their wall time, between a synchronise and a barrier of the
processes that take part.  Where JAX shards a mesh, this runs one process
per device (``train/distributed.py``): at a count n the first n processes
step their rows of the n · envs_per_device envs (``core.RowStream``, so
env i draws what it would draw alone) and the others wait.

    python -m rsr_mjx_tpu_torch.bench_scaling [--env AirbotCubePush] \\
        [--envs_per_device 1024] [--steps 50] [--reps 3] [--device_counts 1]
    torchrun --nproc_per_node N -m rsr_mjx_tpu_torch.bench_scaling \\
        --multihost [--device_counts 1,N]
    python -m rsr_mjx_tpu_torch.bench_scaling --coordinator HOST:PORT \\
        --num_processes N --process_id I
    python -m rsr_mjx_tpu_torch.bench_scaling --spawn_two_process

``--spawn_two_process`` starts two gloo processes on the CPU and sweeps
both (the check of the several-process path without cards).  Process 0
prints the device line (the card's name and power limit, as
``nvidia-smi`` gives them), then one JSON line per count with the JAX
script's keys: metric, devices, processes, num_envs, value, unit.  It
runs on the card and raises where there is none; ``--device cpu`` exists
for the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import List

import torch


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--env', default='AirbotCubePush', help='registered env')
  p.add_argument('--envs_per_device', type=int, default=1024)
  p.add_argument('--steps', type=int, default=50,
                 help='control steps per rollout')
  p.add_argument('--reps', type=int, default=3, help='timed rollouts')
  p.add_argument('--device_counts', default=None,
                 help='comma-separated device counts (default: 1 and all)')
  p.add_argument('--multihost', action='store_true',
                 help='start the process group from the environment '
                      'torchrun sets')
  p.add_argument('--coordinator', default=None,
                 help='host:port of the process group (with '
                      '--num_processes and --process_id)')
  p.add_argument('--num_processes', type=int, default=None)
  p.add_argument('--process_id', type=int, default=None)
  p.add_argument('--spawn_two_process', action='store_true',
                 help='run the sweep in two gloo processes on the CPU')
  p.add_argument('--device', default='cuda',
                 help="'cpu' runs the kernels' plain versions (tests)")
  return p.parse_args(argv)


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


def _spawn_two_process(args) -> None:
  """Start this module twice as a two-process gloo group on the CPU and
  print process 0's lines."""
  with socket.socket() as s:
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
  base = [sys.executable, '-m', 'rsr_mjx_tpu_torch.bench_scaling',
          f'--env={args.env}', f'--envs_per_device={args.envs_per_device}',
          f'--steps={args.steps}', f'--reps={args.reps}',
          '--device_counts=2', '--device=cpu',
          f'--coordinator=localhost:{port}', '--num_processes=2']
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ,
             PYTHONPATH=os.pathsep.join(
                 [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
  procs = [subprocess.Popen(base + [f'--process_id={pid}'],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env)
           for pid in (0, 1)]
  outs = [p.communicate()[0].decode(errors='replace') for p in procs]
  for pid, (p, out) in enumerate(zip(procs, outs)):
    if p.returncode != 0:
      raise RuntimeError(f'rank {pid} failed:\n{out[-3000:]}')
  for line in outs[0].splitlines():
    print(line, flush=True)


@torch.no_grad()
def sweep(env_name: str, envs_per_device: int, steps: int, reps: int,
          counts: List[int], device: str) -> List[dict]:
  """The rate at each device count; every process of the group calls it,
  process 0 gets the lines."""
  from torch import distributed as dist

  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import core, wrappers
  from rsr_mjx_tpu_torch.train import distributed

  rank, world = distributed.world()
  if max(counts) > world or min(counts) < 1:
    raise ValueError(f'device counts {counts} outside 1..{world} processes')
  env0 = envs.load(env_name, device=device)
  env = wrappers.wrap_for_training(env0, episode_length=1200,
                                   num_envs=envs_per_device)
  action = torch.zeros((envs_per_device, env0.action_size), device=device)
  lines = []
  for n in counts:
    group = (dist.new_group(list(range(n))) if distributed.active()
             else None)

    def sync():
      if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)
      if group is not None and rank < n:
        dist.barrier(group=group)

    def rollout():
      gen = torch.Generator(device=device).manual_seed(0)
      rows = (core.RowStream(gen, rank * envs_per_device, envs_per_device,
                             n * envs_per_device) if n > 1 else gen)
      state = env.reset(rows)
      for _ in range(steps):
        state = env.step(state, action)
      return state.reward

    if rank < n:
      rollout()  # warm-up
      sync()
      t = time.perf_counter()
      for _ in range(reps):
        rollout()
      sync()
      seconds = time.perf_counter() - t
      num_envs = envs_per_device * n
      lines.append({'metric': f'{env_name}_env_steps_per_s', 'devices': n,
                    'processes': world, 'num_envs': num_envs,
                    'value': round(steps * num_envs * reps / seconds, 1),
                    'unit': 'env-steps/s'})
    if group is not None:
      dist.barrier()
  return lines if rank == 0 else []


def main(argv=None) -> List[dict]:
  """Run as the flags say; process 0 prints the device line and the JSON
  lines and returns their objects."""
  args = parse_args(argv)
  if args.spawn_two_process:
    _spawn_two_process(args)
    return []
  from rsr_mjx_tpu_torch.train import distributed

  device = args.device
  if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device: the benchmark runs on the card '
                       '(--device cpu for a test of the script)')
  if args.coordinator is not None:
    if torch.device(device).type == 'cuda':
      os.environ.setdefault('LOCAL_RANK', str(args.process_id))
    device = distributed.init(device, f'tcp://{args.coordinator}',
                              rank=args.process_id,
                              world_size=args.num_processes)
  elif args.multihost:
    device = distributed.init(device)
  rank, world = distributed.world()
  counts = ([int(c) for c in args.device_counts.split(',')]
            if args.device_counts else sorted({1, world}))
  try:
    lines = sweep(args.env, args.envs_per_device, args.steps, args.reps,
                  counts, device)
  finally:
    distributed.finish()
  if rank == 0:
    print(device_line(device), flush=True)
    for line in lines:
      print(json.dumps(line), flush=True)
  return lines


if __name__ == '__main__':
  main()
