"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<name>.json``) and a traffic mix
(``benchmark/traffic/<name>.json``, whose ``generator`` is a module of
``benchmark/generators/``); its limits are ``benchmark/limits/<cell>.json``
and each per-layer metric is read by ``benchmark/metrics/<metric>.py``.
The run sets up and warms up the port on the cell's shapes (``setup_s``:
from the start of this process until the window opens, less the seconds
it spends making its inputs with the reference's env), measures for
``--seconds``, checks what the window produced against the reference in
``benchmark/reference/`` and prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit, also printed as the last lines of
standard error.

It runs on the card only: without CUDA, or with fewer cards than the
cell asks for, it exits with 2 and prints no result; so it does when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

from benchmark import common  # noqa: E402


def parse_args(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--workload', required=True)
  p.add_argument('--seed', type=int, required=True)
  p.add_argument('--seconds', type=float, required=True)
  p.add_argument('--trace', type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def context(workload: str, seed: int, seconds: float, trace: bool,
            device: str = 'cuda', sizes=None, spec=None):
  """What a generator is handed: the cell's configuration, traffic and
  limits, the run's seed, window and trace flag, the device, and
  ``sizes`` that replace the configuration's (tests only)."""
  spec = spec or common.manifest()
  w = common.cell(spec, workload)
  traffic = common.load_json('traffic', w['traffic'])
  traffic.update({k: v for k, v in (sizes or {}).items() if k in traffic})
  return types.SimpleNamespace(
      spec=spec, workload=w, cfg=common.load_json('configs', w['config']),
      traffic=traffic, limits=common.load_json('limits', workload),
      seed=seed, seconds=seconds, trace=bool(trace), device=device,
      sizes=dict(sizes or {}), opened=None, reference_s=0.0)


def execute(ctx, t_start: float = None) -> dict:
  """Run the cell; the result line's object."""
  t_start = T0 if t_start is None else t_start
  out = common.generator(ctx.traffic['generator']).run(ctx)
  metrics = {}
  if ctx.trace:
    for m in common.metrics_of(ctx.spec, 'per_layer', ctx.workload['name']):
      value = common.load_file('metrics', m['name']).read(ctx, out)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
  else:
    values = dict(out.end_to_end,
                  setup_s=ctx.opened - t_start - ctx.reference_s)
    for m in common.metrics_of(ctx.spec, 'end_to_end', ctx.workload['name']):
      if m['name'] in values:
        metrics[m['name']] = {'value': values[m['name']], 'unit': m['unit']}
  device = {'platform': 'gpu', 'kind': 'cpu', 'count': ctx.workload['chips'],
            'memory_peak_bytes': out.memory_peak_bytes}
  if ctx.device != 'cpu':
    info = common.card()
    device.update(kind=info['kind'], power_limit=info['power_limit'])
  line = {'correct': all(c.ok for c in out.checks), 'attempted': out.attempted,
          'failed': out.failed, 'metrics': metrics, 'device': device}
  trace = out.context.get('trace')
  if ctx.trace and trace:
    device.update(busy_s=trace['busy_s'], window_s=trace['wall_s'])
    line['breakdown'] = {'device_ops': trace['device_ops'],
                         'idle_gaps': trace['idle_gaps']}
  line['checks'] = {c.name: {'value': c.value, 'limit': c.limit}
                    for c in out.checks}
  return line


def main(argv=None) -> int:
  args = parse_args(argv)
  common.set_environment()
  spec = common.manifest()
  chips = common.cell(spec, args.workload)['chips']
  import torch

  torch.set_num_threads(1)

  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f'benchmark: needs {chips} CUDA device(s), found '
          f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
          '; no result', file=sys.stderr)
    return 2
  ctx = context(args.workload, args.seed, args.seconds, args.trace,
                spec=spec)
  line = execute(ctx)
  bad = common.forbidden_modules()
  if bad:
    print('benchmark: modules of JAX or the JAX package are loaded: '
          + ', '.join(bad) + '; no result', file=sys.stderr)
    return 2
  for name, c in line['checks'].items():
    print(f'check {name}: {c["value"]!r} limit {c["limit"]!r} '
          f'{"ok" if c["value"] <= c["limit"] else "FAIL"}', file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main())
