"""Served rollouts of Go2 getup on the full-collision scene: ``rollout``'s
``run`` and ``readings``, with the frozen copy of the getup env in the
place of the frozen registry (which holds the envs of the first two
configurations) where the reset draws are made and where the two
reference stacks are built.  What is timed, what is checked and how are
``rollout``'s; the reset the reference follows is getup's, with its 125
settle substeps, in float64 and in float32.

On a card the reference's physics steps replay CUDA graphs
(``FrozenGraphs``): a reset settles 125 substeps at the cell's batch in
float64 and in float32, which the eager plain path takes ~17 s to issue.

With ``--trace 1`` it also gives the device time of the physics stages.
After the profiled control steps, ``probe_substeps`` substeps of the
eager ``forward._step`` (the function that ``graphed`` captures and
replays, so the same kernels) run under the profiler from the state the
profiled steps ended in, outside the timed window; each device
operation's time goes to every span of the port open on the host at its
launch (under a profiler a span opens a ``record_function``):
``context['trace']['stages']``, ms per substep by span name, and
``'substep'``, all of it.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import time

from benchmark import common
from benchmark.generators import rollout

# the spans whose device time the probe gives, by their names' prefix
SPAN_PREFIX = 'physics.'


def frozen_env(ctx, dtype):
  """The frozen getup env on the cell's device, its physics in
  ``dtype``."""
  from benchmark.reference.frozen.envs.go2 import getup

  return getup.Getup(device=ctx.device, dtype=dtype, **ctx.cfg['env_kwargs'])


def draw_init(ctx, B):
  """``rollout.draw_init`` with the frozen getup env: the reset draws of
  ``B`` envs from the seed, before the settle, in float32."""
  import torch

  t0 = time.perf_counter()
  g = torch.Generator(device=ctx.device).manual_seed(
      common.stream_seed(ctx.seed, 0))
  init = frozen_env(ctx, torch.float32).sample_init(g, B)
  rollout._sync(ctx.device)
  ctx.reference_s += time.perf_counter() - t0
  return init


def stacks(ctx, B):
  """``rollout.stacks`` with the frozen getup env: the frozen training
  stack in float64 and in float32 (TF32 off), {dtype: (env, wrapped
  env)}."""
  import torch
  from benchmark.reference.frozen.envs import wrappers

  out = {}
  for dt in (torch.float64, torch.float32):
    env0 = frozen_env(ctx, dt)
    out[dt] = (env0, wrappers.wrap_for_training(
        env0, episode_length=ctx.cfg['episode_length'], num_envs=B))
  return out


def profile(ctx, env, policy):
  """``rollout.profile``, then the probe of the stages' device time from
  the state its last control step returned."""
  last = {}

  def step(state, action):
    last['state'] = type(env).step(env, state, action)
    return last['state']

  env.step = step
  try:
    trace = _ROLLOUT['profile'](ctx, env, policy)
  finally:
    del env.step
  trace['stages'] = probe(ctx, env.model, last['state'].data)
  return trace


def probe(ctx, m, d):
  """{span: device ms per substep} of ``probe_substeps`` eager substeps
  from ``d`` (no sensors), and ``'substep'``: all their device work
  (``stage_ms``); None off a card."""
  if ctx.device == 'cpu':
    return None
  import torch
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as torch_profile

  forward = importlib.import_module('rsr_mjx_tpu_torch.physics.forward')
  n = ctx.traffic['probe_substeps']
  with torch.no_grad():
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
      for _ in range(n):
        d = forward._step(m, d, False)
      torch.cuda.synchronize()
  return stage_ms(prof.events(), n)


# host events of the CUDA runtime that launch device work (kernels,
# copies, fills): a device operation carries its launch's correlation id
LAUNCHES = ('Launch', 'Memcpy', 'Memset')


def stage_ms(events, n: int):
  """Each device operation's time given to every span of the port (a
  host event whose name starts with ``SPAN_PREFIX``) open when it was
  launched, each name once, in ms per substep over ``n`` substeps;
  ``'substep'``: every device operation.  The launch is the runtime's
  host event with the operation's correlation id (``id``), which a
  kernel of the port's own libraries has as an ATen op's does; a span is
  open at the launch when its host time holds the launch's start.  None
  where no device operation ran."""
  import torch

  cuda = torch.autograd.DeviceType.CUDA
  spans, launch, device = [], {}, []
  for e in events:
    if e.device_type == cuda:
      if not (getattr(e, 'is_user_annotation', False)
              or e.name.startswith(common.ANNOTATIONS + (SPAN_PREFIX,))):
        device.append(e)
    elif e.name.startswith(SPAN_PREFIX):
      spans.append((e.time_range.start, e.time_range.end, e.name))
    elif any(w in e.name for w in LAUNCHES):
      launch[e.id] = e.time_range.start
  totals, whole = {}, 0.0
  for e in device:
    us = e.time_range.end - e.time_range.start
    whole += us
    t = launch.get(e.id)
    if t is None:
      continue
    for name in {name for s0, s1, name in spans if s0 <= t <= s1}:
      totals[name] = totals.get(name, 0.0) + us
  if whole <= 0:
    return None
  out = {k: v * 1e-3 / n for k, v in totals.items()}
  out['substep'] = whole * 1e-3 / n
  return out


class FrozenGraphs:
  """The frozen physics step ``step(m, d, sensors)`` replayed from CUDA
  graphs.  Per (model, dtype, ``sensors``, the TF32 setting of the
  precision control, the state's shapes and strides) the first call runs
  the step as it is (its answer, and the warm-up of its lazy tables), then
  captures it on copies of the state's tensors; later calls copy the state
  in, replay and copy every output out.  A replay runs the captured
  kernels on the same bytes, so it gives the eager step's numbers.  Off a
  card the step runs as it is.

  A graph reads the copies of the state (kept with it), the model's
  tensors (the model is kept with it) and the frozen ``linalg_kernels``'
  tables made once per layout (``_row_masks``, ``_slot_pair``), which
  ``getup_reference`` holds in unbounded caches while graphs live.  The
  graphs share one memory pool: they never run at once, and their outputs
  are copied out before another runs."""

  def __init__(self, step):
    self.eager, self.graphs, self.pool = step, {}, None

  def __call__(self, m, d, sensors=True):
    import torch

    if not d.qpos.is_cuda:
      return self.eager(m, d, sensors)
    ref_forward = importlib.import_module(
        'benchmark.reference.frozen.physics.forward')
    leaves = _leaves(d)
    key = (id(m), bool(sensors), ref_forward.ALLOW_TF32) + tuple(
        (t.shape, t.stride(), t.dtype) for t in leaves)
    hit = self.graphs.get(key)
    if hit is None:
      out = self.eager(m, d, sensors)
      static = d.map(torch.clone)
      if self.pool is None:
        self.pool = torch.cuda.graph_pool_handle()
      graph = torch.cuda.CUDAGraph()
      with torch.cuda.graph(graph, pool=self.pool):
        res = self.eager(m, static, sensors)
      # the model is kept with its graph: the graph reads its tensors
      self.graphs[key] = (m, graph, _leaves(static), res)
      return out
    _, graph, static, res = hit
    torch._foreach_copy_(static, leaves)
    graph.replay()
    return res.map(torch.clone)


def _leaves(d):
  from benchmark.reference.frozen.physics.types import DATA_FIELDS

  return [getattr(d, f) for f in DATA_FIELDS] + [d.contact.dist]


_ROLLOUT = {'draw_init': rollout.draw_init, 'stacks': rollout.stacks,
            'profile': rollout.profile}
_GETUP = {'draw_init': draw_init, 'stacks': stacks, 'profile': profile}


# the frozen ``linalg_kernels``' device tables, each made once per layout
# in a bounded cache that could free one under a live graph
TABLES = ('_row_masks', '_slot_pair')


@contextlib.contextmanager
def getup_reference():
  """``rollout``'s reference makers bound to the frozen getup env (and
  its profile to this module's), the frozen physics step to
  ``FrozenGraphs``, and the frozen ``TABLES`` to unbounded caches, for the
  block's length."""
  from benchmark.reference.frozen import physics as ref_physics
  from benchmark.reference.frozen.physics import linalg_kernels as ref_lk

  eager = ref_physics.step
  bounded = {k: getattr(ref_lk, k) for k in TABLES}
  for k, fn in _GETUP.items():
    setattr(rollout, k, fn)
  for k, fn in bounded.items():
    setattr(ref_lk, k, functools.cache(fn.__wrapped__))
  ref_physics.step = FrozenGraphs(eager)
  try:
    yield
  finally:
    ref_physics.step = eager
    for k, fn in bounded.items():
      setattr(ref_lk, k, fn)
    for k, fn in _ROLLOUT.items():
      setattr(rollout, k, fn)


def run(ctx) -> common.Outcome:
  with getup_reference():
    out = rollout.run(ctx)
  stages = out.context.get('trace', {}).get('stages')
  if stages:
    print('rollout_getup: device ms a substep by span '
          + ', '.join(f'{k} {v:.6g}' for k, v in sorted(stages.items())),
          file=sys.stderr)
  return out


def readings(ctx) -> dict:
  with getup_reference():
    return rollout.readings(ctx)


# the numbers compared: ``rollout``'s, from the references it is handed
# (``stacks``)
compare = rollout.compare
