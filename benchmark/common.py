"""What every traffic generator of the benchmark shares: the cache directories, the
manifest and the files a cell is made of, the card's description, the
import guard, the trace reduction and the gap arithmetic of the checks.

Nothing here imports the port; a generator imports it inside its functions.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names that no run may load (the JAX stack and the JAX
# package the port was made from), compared whole: ``rsr_mjx_tpu_torch``
# begins with ``rsr_mjx_tpu`` and is allowed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'rsr_mjx_tpu')


def set_environment() -> None:
  """Before torch is imported: fixed cache folders inside the checkout for
  any Triton or extension kernel the port may build, so that only a
  cell's first run compiles (the port's nvcc libraries go to
  ``rsr_mjx_tpu_torch/build/``); one host thread for CPU operators, so
  that the process's operators load one core."""
  os.environ['OMP_NUM_THREADS'] = '1'
  cache = os.path.join(HERE, '.cache')
  os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
  os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache, 'torch_extensions')
  os.environ['USE_FLAX'] = '0'


def forbidden_modules(modules=None) -> List[str]:
  """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
  names = sys.modules if modules is None else modules
  return sorted(m for m in names if m.split('.')[0] in FORBIDDEN)


def manifest(root: str = ROOT) -> dict:
  with open(os.path.join(root, 'BENCHMARK.json')) as f:
    return json.load(f)


def cell(spec: dict, name: str) -> dict:
  for w in spec['workloads']:
    if w['name'] == name:
      return w
  raise SystemExit(f'no workload {name!r} in BENCHMARK.json')


def metrics_of(spec: dict, kind: str, workload: str) -> List[dict]:
  """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
  that list it, and those that list no cells at all."""
  return [m for m in spec[kind]
          if workload in m.get('workloads', [workload])]


def load_json(kind: str, name: str) -> dict:
  """``benchmark/<kind>/<name>.json`` (a configuration, a traffic mix or
  a cell's limits)."""
  path = os.path.join(HERE, kind, f'{name}.json')
  with open(path) as f:
    return json.load(f)


def load_file(kind: str, name: str):
  """The module ``benchmark/<kind>/<name>.py`` (a metric's reader, a
  kernel's count), loaded by path: names may hold dots."""
  path = os.path.join(HERE, kind, f'{name}.py')
  spec = importlib.util.spec_from_file_location(
      f'benchmark.{kind}.{name.replace(".", "_")}', path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def roofline_files() -> Dict[str, Any]:
  """Every kernel count under ``benchmark/roofline/`` (files K*.py), by
  the kernel's short name."""
  folder = os.path.join(HERE, 'roofline')
  return {f[:-3]: load_file('roofline', f[:-3])
          for f in sorted(os.listdir(folder))
          if f.endswith('.py') and f[0] == 'K'}


def generator(name: str):
  return importlib.import_module(f'benchmark.generators.{name}')


def card() -> dict:
  """The card's name (torch's) and power limit (nvidia-smi's)."""
  import torch

  out = {'kind': torch.cuda.get_device_name(0), 'power_limit': 'not read'}
  try:
    lines = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()
    out['power_limit'] = lines[0].split(',')[-1].strip()
  except (OSError, subprocess.SubprocessError, IndexError):
    pass
  return out


# -- checks ----------------------------------------------------------------


@dataclasses.dataclass
class Check:
  """One number compared with the reference, and its limit: the run is
  correct when every ``value <= limit``."""

  name: str
  value: float
  limit: float

  @property
  def ok(self) -> bool:
    return bool(np.isfinite(self.value)) and self.value <= self.limit


def checks_from(values: Dict[str, float], limits: Dict[str, float]
                ) -> List[Check]:
  """A Check for each limit; a number the run did not produce reads inf."""
  return [Check(k, float(values.get(k, float('inf'))), float(v))
          for k, v in limits.items()]


def per_env_gap(a, b) -> np.ndarray:
  """max |a − b| over each env's entries (rows), as float64 numpy; a
  non-finite entry reads inf."""
  a = np.asarray(a, np.float64).reshape(len(a), -1)
  b = np.asarray(b, np.float64).reshape(len(b), -1)
  gap = np.abs(a - b).max(axis=1) if a.shape[1] else np.zeros(len(a))
  return np.where(np.isfinite(gap), gap, np.inf)


def nearer_gap(prog, ref64, ref32) -> np.ndarray:
  """Each env's widest gap of the program to the reference: to the
  float64 reference, or to the same reference in float32 where that is
  nearer.  Where an env sits within rounding of a branch (a constraint
  row's activation at the start of a Newton solve that stops after one
  iteration, a contact at its margin), float32 and float64 take
  different branches and both are right; a program at fault departs from
  both."""
  return np.minimum(per_env_gap(prog, ref64), per_env_gap(prog, ref32))


# the part of an entry by which the float32 and float64 references part
# before an env counts as within rounding of a branch (``envs_off``)
SPLIT = 1e-3


def rel_gap(a, b) -> np.ndarray:
  """Each env's widest |a − b| / max(1, |b|) over its entries (rows)."""
  a = np.asarray(a, np.float64).reshape(len(a), -1)
  b = np.asarray(b, np.float64).reshape(len(b), -1)
  gap = (np.abs(a - b) / np.maximum(1.0, np.abs(b))).max(axis=1) if (
      a.shape[1]) else np.zeros(len(a))
  return np.where(np.isfinite(gap), gap, np.inf)


def off_envs(prog, ref64, ref32, tol: float = SPLIT) -> np.ndarray:
  """The envs the program leaves by more than ``tol`` of an entry while
  the two references agree within it there: a departure that rounding
  does not explain."""
  near = np.minimum(rel_gap(prog, ref64), rel_gap(prog, ref32))
  return (near > tol) & (rel_gap(ref32, ref64) <= tol)


def split_look(prog, ref64, ref32) -> dict:
  """What the look at the envs prints: the widest gap to the float64
  reference alone, the widest gap between the two references, how many
  envs the references part by more than ``SPLIT`` of an entry, and how
  many envs the program leaves unexplained at a tenth, one and ten times
  ``SPLIT``."""
  apart = rel_gap(ref32, ref64)
  out = {'widest_to_f64': float(per_env_gap(prog, ref64).max()),
         'widest_f32_to_f64': float(per_env_gap(ref32, ref64).max()),
         'envs_split': int((apart > SPLIT).sum()),
         'envs': int(len(apart))}
  for f in (0.1, 1, 10):
    out[f'envs_off_{f * SPLIT:g}'] = int(
        off_envs(prog, ref64, ref32, f * SPLIT).sum())
  return out


def merge_looks(looks: List[dict]) -> dict:
  out: Dict[str, float] = {}
  for look in looks:
    for k, v in look.items():
      out[k] = (max(out.get(k, v), v) if k.startswith('widest')
                else out.get(k, 0) + v)
  return out


def tf32(x):
  """x (numpy float32 / float64) rounded to TF32's 10-bit mantissa, to
  nearest even: what the tensor cores read of a float32 matmul input."""
  x = np.asarray(x, np.float32)
  bits = x.view(np.uint32).astype(np.uint64)
  lsb = (bits >> 13) & 1
  bits = ((bits + 0xFFF + lsb) >> 13) << 13
  return (bits & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


# -- the trace -------------------------------------------------------------


def _merge(intervals):
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out


# spans that the profiler also draws on the device's timeline
ANNOTATIONS = ('bench.', 'Optimizer.', 'ProfilerStep')


def reduce_trace(prof, wall_s: float) -> dict:
  """The device side of a ``torch.profiler`` trace over a sub-window of
  ``wall_s`` seconds: kernels launched, time by kernel name, the union of
  busy intervals, and the longest idle gaps named by what the host was
  doing (the innermost host event open when each gap began)."""
  import torch

  cuda = torch.autograd.DeviceType.CUDA
  dev, host = [], []
  for e in prof.events():
    tr = e.time_range
    if e.device_type == cuda and (getattr(e, 'is_user_annotation', False)
                                  or e.name.startswith(ANNOTATIONS)):
      continue  # a span drawn on the device's timeline, no work of its own
    if e.device_type == cuda:
      dev.append((tr.start, tr.end, e.name))
    else:
      host.append((tr.start, tr.end, e.name))
  kernels = [d for d in dev if not d[2].startswith(('Memcpy', 'Memset'))]
  by_name: Dict[str, List[float]] = {}
  for s, e, n in dev:
    t = by_name.setdefault(n, [0, 0.0])
    t[0] += 1
    t[1] += (e - s) * 1e-6
  merged = _merge([(s, e) for s, e, _ in dev])
  busy = sum(e - s for s, e in merged) * 1e-6
  gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                 for i in range(len(merged) - 1)), reverse=True)[:10]
  host.sort()
  idle = []
  for length, start in gaps:
    name = 'host'
    best = None
    for s, e, n in host:
      if s > start:
        break
      if e >= start and (best is None or s >= best):
        best, name = s, n
    idle.append([name, length * 1e-6])
  top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
  return {'launches': len(kernels), 'busy_s': busy, 'wall_s': wall_s,
          'kernels': {n: (c, t) for n, (c, t) in by_name.items()},
          'device_ops': [[n, t] for n, (_, t) in top], 'idle_gaps': idle}


def combine_traces(parts: List[tuple]) -> dict:
  """One trace of a mix of sub-windows: ``parts`` holds (trace, weight),
  each trace's counts and times scaled by its weight (how many times the
  mix holds that sub-window)."""
  out = {'launches': 0.0, 'busy_s': 0.0, 'wall_s': 0.0, 'kernels': {},
         'device_ops': [], 'idle_gaps': []}
  for t, w in parts:
    out['launches'] += t['launches'] * w
    out['busy_s'] += t['busy_s'] * w
    out['wall_s'] += t['wall_s'] * w
    for n, (c, s) in t['kernels'].items():
      c0, s0 = out['kernels'].get(n, (0.0, 0.0))
      out['kernels'][n] = (c0 + c * w, s0 + s * w)
    out['idle_gaps'] += t['idle_gaps']
  top = sorted(out['kernels'].items(), key=lambda kv: -kv[1][1])[:10]
  out['device_ops'] = [[n, s] for n, (_, s) in top]
  out['idle_gaps'] = sorted(out['idle_gaps'], key=lambda g: -g[1])[:10]
  return out


class Profiled:
  """A ``torch.profiler`` window over CPU and CUDA activity, its wall time
  between two synchronisations; ``trace`` is its reduction."""

  def __init__(self, device):
    self.device = device
    self.trace: Optional[dict] = None

  def __enter__(self):
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if self.device != 'cpu':
      torch.cuda.synchronize(self.device)
      acts.append(ProfilerActivity.CUDA)
    self._prof = profile(activities=acts)
    self._prof.__enter__()
    self._t = time.perf_counter()
    return self

  def __exit__(self, *exc):
    import time

    import torch

    if self.device != 'cpu':
      torch.cuda.synchronize(self.device)
    wall = time.perf_counter() - self._t
    self._prof.__exit__(*exc)
    if exc[0] is None:
      self.trace = reduce_trace(self._prof, wall)
    self._prof = None
    return False


@dataclasses.dataclass
class Outcome:
  """What a generator's run gives the harness."""

  end_to_end: Dict[str, float]
  checks: List[Check]
  attempted: int
  failed: int
  memory_peak_bytes: int
  # for the per-layer readers (``--trace 1``): the configuration, the
  # window's counts, the profiled sub-window and the generator's own spans
  context: Dict[str, Any] = dataclasses.field(default_factory=dict)


def settle() -> None:
  """Before a window: collect the set-up's garbage and move what is left
  out of the collector's reach, so that its full passes in the window
  walk only the window's own objects."""
  import gc

  gc.collect()
  gc.freeze()


def stream_seed(seed: int, stream: int) -> int:
  """A seed for stream ``stream`` of a run, drawn from ``seed``: any whole
  number, however large, gives 63-bit seeds."""
  return int(np.random.default_rng([seed, stream]).integers(0, 2**63 - 1))
