"""What the per-layer metrics share: each reads the profiled sub-window
(``context['trace']``) or the window's counts that a generator hands over,
and gives None where it finds nothing to read."""

from benchmark import common
from benchmark.roofline import networks, peaks


def _device_trace(out):
  """The profiled sub-window, where an operation ran on the device."""
  t = out.context.get('trace')
  return t if t and t['busy_s'] > 0 else None


def launches_per_substep(out):
  t = _device_trace(out)
  if not t or not t.get('substeps'):
    return None
  return t['launches'] / t['substeps']


def idle_share(out):
  """1 − the traced work's device-busy seconds over the seconds the same
  work takes in the unprofiled window (the profiler slows the host, not
  the device), in %."""
  t = _device_trace(out)
  secs = out.context.get('unprofiled_s')
  if not t or not secs:
    return None
  return 100.0 * (1.0 - t['busy_s'] / secs)


def kernel_roofline(ctx, out):
  """Σ least time ÷ Σ device time over the hand-written kernels found in
  the trace, in %: each found kernel's least time from its shapes, times
  its calls a substep and the substeps traced."""
  t = _device_trace(out)
  if not t or not t.get('substeps'):
    return None
  cfg, B = ctx.cfg, out.context['envs']
  least = spent = 0.0
  for name, mod in common.roofline_files().items():
    shape = cfg['kernels'].get(name)
    if shape is None:
      continue
    secs = sum(s for n, (c, s) in t['kernels'].items()
               if any(p in n for p in mod.NAMES))
    if secs <= 0:
      continue
    least += (peaks.bound_s(*mod.work(shape, B)) * shape['calls_per_substep']
              * t['substeps'])
    spent += secs
  return 100.0 * least / spent if spent else None


def physics_flops(cfg, B: int) -> float:
  """The hand-written kernels' least FLOPs of one control step of B envs."""
  total = 0.0
  for name, mod in common.roofline_files().items():
    shape = cfg['kernels'].get(name)
    if shape is not None:
      total += mod.work(shape, B)[1] * shape['calls_per_substep']
  return total * cfg['substeps']


def step_mfu(ctx, out):
  """Counted FLOPs of the window over (window seconds × the float32
  peak), in %: the kernels' work of every substep and the networks'
  matmuls (``context['network_flops']``)."""
  c = out.context
  if not c.get('window_s') or _device_trace(out) is None:
    return None
  cfg = ctx.cfg
  flops = c['control_steps'] * physics_flops(cfg, c['envs'])
  flops += c.get('network_flops', 0.0)
  return 100.0 * flops / (c['window_s'] * peaks.FP32_FLOP_S)


def policy_rows_flops(cfg, rows: int) -> float:
  policy, _ = networks.widths(cfg, cfg['obs_sizes'], cfg['action_size'])
  return rows * networks.forward(policy)
