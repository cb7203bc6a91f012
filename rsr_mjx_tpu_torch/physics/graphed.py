"""One physics substep replayed from a CUDA graph.

Launched op by op, a substep is ~6,500-8,500 small kernels, and the host
takes far longer to launch them than the card takes to run them.
``run(m, d, sensors, eager)`` captures the eager substep ``eager(m, d,
sensors)`` once into a CUDA graph and afterwards replays it: the incoming
fields are copied into the graph's static inputs (one ``_foreach_copy_``),
the graph is launched, and the outputs are copied out (one more).  The
replay runs the very kernels of the eager substep, in its order, on the
same bytes, so its outputs equal the eager ones bit for bit.

When it replays.  ``eager_reason`` says why a substep runs eagerly, or
None: the state is not on a card (``'device'``); grad mode is on and a
state tensor or model leaf requires grad, where the chain runs as
``fwd_fused.FusedRegion`` (``'grad'``); the fused chain does not cover
the model, which raises there (``'uncovered'``).  Nothing else is tested:
no flag, no model name.

Cache.  Graphs are grouped by (model, its leaves' addresses and the
option's static fields, batch size, dtype, device); the model is held
weakly, and a group dies with it.  In a group one graph is kept per
(``sensors``, the strides and dtypes of the inputs): a control step uses
two, the substeps without sensors and its last one with them.  The graphs
of a group share one memory pool: they never run at once, and their
outputs are copied out before another runs.  At most ``MAX_GROUPS`` groups
are kept, and at most ``MAX_GRAPHS`` graphs a group, least recently used
first out; a group evicted frees its pool.  Every other device tensor a
graph reads outlives it: the model's own (its group dies with the model),
its ``statics`` tables (held by the model) and the kernels' row masks and
slot maps (``linalg_kernels``, never evicted).

Capture (``utils/cuda_graphs``' side stream, pools, capture and cache).
The first call of a key runs the eager substep on a side stream:
that is the call's answer, and it fills every lazy device table (the
``statics`` tables, the kernels' row masks and slot maps, the kernel
libraries), so nothing is copied from the host or built inside the capture.
The same substep is then captured, on that stream and under
``torch.no_grad()``, with the fields of ``INPUTS`` replaced by static
buffers of their strides; the model's tensors are read at their addresses,
which is why they are part of the key.  A returned field is either the
caller's own tensor, where the eager step passes its input through, or a
copy of the graph's output: no returned tensor aliases graph memory, so a
state held across steps stays as it was.

Counters of ``utils.tracing``: ``physics.graph_captures`` and
``physics.graph_replays`` (each replayed substep).  The K1-K4 wrappers do
not run in a replay, so their counter group ``launches`` is inferred: the
launches the wrappers counted while a graph was captured are taken back,
and added again at each replay.  Only a device trace sees what a replay
ran.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import torch

from rsr_mjx_tpu_torch.physics import fwd_fused as _ff
from rsr_mjx_tpu_torch.physics.types import (DATA_FIELDS, OPT_STATIC_FIELDS,
                                             Data, Model)
from rsr_mjx_tpu_torch.utils import cuda_graphs
from rsr_mjx_tpu_torch.utils import tracing

# the Data fields a substep reads: the graph's static inputs
INPUTS = ('qpos', 'qvel', 'ctrl', 'act', 'qacc', 'qfrc_applied',
          'xfrc_applied', 'time')
# groups of graphs kept, one per (model, batch size, dtype, device)
MAX_GROUPS = 4
# graphs kept in one group
MAX_GRAPHS = 4

_COUNTERS = tracing.group('physics')
for _k in ('graph_captures', 'graph_replays'):
  _COUNTERS.setdefault(_k, 0)
# the K1-K4 wrappers' launch counts (``linalg_kernels.LAUNCHES``)
_LAUNCHES = tracing.group('launches')

_CACHE = cuda_graphs.Cache()  # {group key: _Group}


def _on_card(d: Data) -> bool:
  return d.qpos.is_cuda


def _device_index(d: Data) -> int:
  """The card of d, for ``torch.cuda.device``: -1 (no change) off a
  card."""
  return d.qpos.device.index if d.qpos.is_cuda else -1


def _model_tensors(m: Model):
  return [t for t in m.numeric.values() if t is not None] + [
      m.opt.timestep, m.opt.gravity]


def _needs_grad(m: Model, d: Data) -> bool:
  return (any(getattr(d, f).requires_grad for f in DATA_FIELDS)
          or d.contact.dist.requires_grad
          or any(t.requires_grad for t in _model_tensors(m)))


def _eager_state(m: Model, d: Data) -> Optional[str]:
  """``eager_reason``'s tests of the state: cheap enough for every call."""
  if not _on_card(d):
    return 'device'
  if torch.is_grad_enabled() and _needs_grad(m, d):
    return 'grad'
  return None


def eager_reason(m: Model, d: Data) -> Optional[str]:
  """Why substep (m, d) runs eagerly ('device', 'grad', 'uncovered'), or
  None where it replays a graph."""
  reason = _eager_state(m, d)
  if reason is None and not _ff.supported(m):
    return 'uncovered'
  return reason


def group_key(m: Model, d: Data) -> tuple:
  """(model, its tensors' addresses, its option's static fields, batch
  size, dtype, device): a graph reads the model at those addresses."""
  return (id(m), tuple(t.data_ptr() for t in _model_tensors(m)),
          tuple(getattr(m.opt, f) for f in OPT_STATIC_FIELDS),
          d.qpos.shape[0], d.qpos.dtype, d.qpos.device)


def graph_key(d: Data, sensors: bool) -> tuple:
  """(sensors, each input's strides and dtype) within a group."""
  return (bool(sensors),) + tuple(
      (getattr(d, f).stride(), getattr(d, f).dtype) for f in INPUTS)


class _Group:
  """A model's graphs at one batch size: its weak reference, the pool
  they share and {graph key: _Graph}, least recently used first."""

  def __init__(self):
    self.model = None  # the model's weak reference (``Cache.add``)
    self.pool = cuda_graphs.new_pool()
    self.graphs: 'collections.OrderedDict[tuple, _Graph]' = (
        collections.OrderedDict())


def _leaves(d: Data):
  """Every tensor a substep returns: Data's fields, then the contact
  dists."""
  return [getattr(d, f) for f in DATA_FIELDS] + [d.contact.dist]


class _Graph:
  """One captured substep: the graph, its static inputs (in ``INPUTS``
  order) and outputs, the plan that makes a Data of them, and the kernel
  launches it replays."""

  __slots__ = ('graph', 'device', 'inputs', 'outputs', 'plan', 'launches')

  def __init__(self, graph, device, inputs, outputs, plan, launches):
    self.graph, self.device = graph, device
    self.inputs, self.outputs = inputs, outputs
    self.plan, self.launches = plan, launches

  def run(self, d: Data) -> Data:
    torch._foreach_copy_(self.inputs, [getattr(d, f) for f in INPUTS])
    with torch.cuda.device(self.device):
      self.graph.replay()
    outs = [torch.empty_like(o) for o in self.outputs]
    torch._foreach_copy_(outs, self.outputs)
    tracing.count('physics.graph_replays')
    for k, n in self.launches:
      _LAUNCHES[k] += n
    return _assemble(d, self.plan, outs)


def _assemble(d: Data, plan, outs) -> Data:
  """A Data of the copies ``outs`` and of d's own tensors: plan[i] is an
  index into outs, or None where the substep passes d's leaf i through."""
  vals = [getattr(d, f) if p is None else outs[p]
          for f, p in zip(DATA_FIELDS, plan)]
  p = plan[-1]
  dist = d.contact.dist if p is None else outs[p]
  return Data(**dict(zip(DATA_FIELDS, vals)),
              contact=dataclasses.replace(d.contact, dist=dist))


def _capture_graph(m: Model, d: Data, sensors: bool, eager, group: _Group):
  """The eager substep on a side stream (the call's answer, and the
  warm-up), then its capture on static inputs; (answer, _Graph)."""
  dev = _device_index(d)
  side = cuda_graphs.side_stream(d.qpos.device)
  with torch.cuda.device(dev):
    answer = cuda_graphs.on_stream(side, lambda: eager(m, d, sensors))
    with torch.no_grad():
      inputs = {f: torch.empty_like(getattr(d, f)) for f in INPUTS}
      static = d.replace(**inputs)
      before = dict(_LAUNCHES)
      graph, out = cuda_graphs.capture(lambda: eager(m, static, sensors),
                                       group.pool, side)
  launches = tuple((k, n - before.get(k, 0)) for k, n in _LAUNCHES.items()
                   if n != before.get(k, 0))
  _LAUNCHES.update(before)  # the capture launched nothing
  plan, outputs, seen = [], [], {}
  for t_out, t_in in zip(_leaves(out), _leaves(static)):
    if t_out is t_in:
      plan.append(None)
    else:
      if id(t_out) not in seen:
        seen[id(t_out)] = len(outputs)
        outputs.append(t_out)
      plan.append(seen[id(t_out)])
  tracing.count('physics.graph_captures')
  return answer, _Graph(graph, dev, [inputs[f] for f in INPUTS], outputs,
                        plan, launches)


def run(m: Model, d: Data, sensors: bool,
        eager: Callable[[Model, Data, bool], Data]) -> Data:
  """``eager(m, d, sensors)``, replayed from a CUDA graph where
  ``eager_reason`` allows it."""
  if _eager_state(m, d):
    return eager(m, d, sensors)
  gk = group_key(m, d)
  group = _CACHE.get(gk)
  if group is None or group.model() is not m:
    if not _ff.supported(m):  # the eager step raises
      return eager(m, d, sensors)
    with torch.cuda.device(_device_index(d)):
      group = _Group()
    (group.model,) = _CACHE.add(gk, group, (m,), MAX_GROUPS)
  else:
    _CACHE.move_to_end(gk)
  key = graph_key(d, sensors)
  g = group.graphs.get(key)
  if g is not None:
    group.graphs.move_to_end(key)
    return g.run(d)
  while len(group.graphs) >= MAX_GRAPHS:
    group.graphs.popitem(last=False)
  answer, group.graphs[key] = _capture_graph(m, d, sensors, eager, group)
  return answer


def clear() -> None:
  """Drops every graph and its pool."""
  _CACHE.clear()
