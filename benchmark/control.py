"""The readings the limits are set from: for each seed, the numbers
compared of the program, of the precision control (the reference in the
program's place, one precision below the configuration's) and of the
faults planted in the recorded steps, from one short window of the cell.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 \\
        [--seconds 5]

Prints one JSON line per seed, then the largest program reading and the
smallest control, bfloat16-physics and fault readings of each number.  It runs on the card
(the tests run it on the CPU at a small size); the benchmark's own runs
do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import common, run


def readings(workload, seeds, seconds, device='cuda', sizes=None) -> dict:
  """{'program': {number: largest}, 'control': {number: smallest},
  'physics_bf16': {number: smallest}, 'faults': {fault: {number:
  smallest}}, 'runs': [each seed's]}."""
  runs = []
  for seed in seeds:
    ctx = run.context(workload, seed, seconds, False, device, sizes)
    r = common.generator(ctx.traffic['generator']).readings(ctx)
    r['seed'] = seed
    runs.append(r)
    print(json.dumps(r), flush=True)
  out = {'program': {}, 'control': {}, 'physics_bf16': {}, 'faults': {},
         'runs': runs}
  for r in runs:
    for k, v in r['program'].items():
      out['program'][k] = max(out['program'].get(k, v), v)
    for part in ('control', 'physics_bf16'):
      for k, v in r.get(part, {}).items():
        out[part][k] = min(out[part].get(k, v), v)
    for f, nums in r.get('faults', {}).items():
      for k, v in nums.items():
        slot = out['faults'].setdefault(f, {})
        slot[k] = min(slot.get(k, v), v)
  return out


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seeds', type=int, nargs='+', required=True)
  p.add_argument('--seconds', type=float, default=5.0)
  args = p.parse_args(argv)
  common.set_environment()
  import torch

  torch.set_num_threads(1)

  if not torch.cuda.is_available():
    print('control: needs a CUDA device', file=sys.stderr)
    return 2
  out = readings(args.workload, args.seeds, args.seconds)
  del out['runs']
  print(json.dumps(out), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
