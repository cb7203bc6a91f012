"""Host-side spans and counters of the port, in one registry per process.

``span(name)`` times the host work of a block or a function (a context
manager and a decorator) with ``time.perf_counter_ns``; it never
synchronises the device, so on the card it measures what the host spends
issuing the work, not the device's time.  Per name it keeps the calls, the
total seconds, the self seconds (less the spans nested in it, one stack per
thread) and a ring of the newest ``RING`` (total, self) durations.

While a ``torch.profiler`` is recording, a span also enters
``torch.profiler.record_function(name)``, so it lands on the profiler's
clock beside the device's kernels.  Such calls are flagged in the ring and
left out of its medians: the profiler slows the host.  With no profiler a
span costs one check, two clock reads and a ring append.

``count(name, n)`` adds to counter ``name``; a name's last dot parts the
counter's group from its key.  ``group(name)`` is a group's dict itself:
``linalg_kernels.LAUNCHES`` is group ``launches``, counted as
``LAUNCHES[<wrapper>] += 1`` and zeroed with
``LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))``.

``snapshot()`` gives every span and counter; ``reset()`` zeroes them in
place.  ``report()`` is the snapshot as text, one line a span or counter.

Spans: ``env.step``, ``env.reset`` (``envs/wrappers.AutoResetWrapper``);
``physics.step`` and its stages ``physics.kinematics``, ``.smooth``,
``.assembly``, ``.solve``, ``.implicit`` (``physics/fwd_fused._chain``),
``.collision`` (the narrow phase, inside ``.assembly``:
``physics/lanes_assembly``), ``.sensors``, ``.integrate``
(``physics/forward.step``), the stages on a card only while a substep is
captured (``physics/graphed``); ``policy.act``
(``train/networks.make_policy``); ``ppo.setup``, ``ppo.unroll``,
``ppo.minibatch_step``, ``ppo.normalizer_update`` (``train/ppo.py``,
``train/acting.py``); ``deploy.get_action``; ``kernels.build``.
Counters: ``physics.substeps``, ``physics.graph_captures``,
``physics.graph_replays`` (``physics/graphed``), ``kernels.builds``,
``launches.*``.
"""

from __future__ import annotations

import collections
import functools
import statistics
import threading
import time
from typing import Dict, Optional

import torch

# durations a span keeps for its medians
RING = 256


class _Stat:
  """One span's calls, total and self nanoseconds and its ring of
  (total ns, self ns, under a profiler)."""

  __slots__ = ('calls', 'total_ns', 'self_ns', 'ring')

  def __init__(self):
    self.calls = self.total_ns = self.self_ns = 0
    self.ring = collections.deque(maxlen=RING)

  def clear(self):
    self.calls = self.total_ns = self.self_ns = 0
    self.ring.clear()


_SPANS: Dict[str, _Stat] = {}
_COUNTERS: Dict[str, Dict[str, int]] = {}
_LOCAL = threading.local()


def _stat(name: str) -> _Stat:
  s = _SPANS.get(name)
  if s is None:
    s = _SPANS.setdefault(name, _Stat())
  return s


def _stack() -> list:
  """This thread's open spans: the nanoseconds their children took."""
  st = getattr(_LOCAL, 'stack', None)
  if st is None:
    st = _LOCAL.stack = []
  return st


class span:
  """Times the host work of a ``with`` block, or of each call of the
  function it decorates, under ``name``."""

  __slots__ = ('name', '_stat', '_t0', '_rf')

  def __init__(self, name: str):
    self.name = name
    self._stat = _stat(name)
    self._rf = None

  def __enter__(self):
    if torch.autograd._profiler_enabled():
      self._rf = torch.profiler.record_function(self.name)
      self._rf.__enter__()
    _stack().append(0)
    self._t0 = time.perf_counter_ns()
    return self

  def __exit__(self, *exc):
    total = time.perf_counter_ns() - self._t0
    st = _LOCAL.stack
    own = total - st.pop()
    if st:
      st[-1] += total
    s = self._stat
    s.calls += 1
    s.total_ns += total
    s.self_ns += own
    s.ring.append((total, own, self._rf is not None))
    if self._rf is not None:
      rf, self._rf = self._rf, None
      rf.__exit__(*exc)
    return False

  def __call__(self, fn):
    name = self.name

    @functools.wraps(fn)
    def traced(*args, **kwargs):
      with span(name):
        return fn(*args, **kwargs)

    return traced


def group(name: str) -> Dict[str, int]:
  """The dict of counter group ``name``, made empty at first use."""
  return _COUNTERS.setdefault(name, {})


def count(name: str, n: int = 1) -> None:
  """Adds ``n`` to counter ``name`` (group and key parted at its last
  dot)."""
  g, _, key = name.rpartition('.')
  d = group(g)
  d[key] = d.get(key, 0) + n


def _median_ms(values) -> Optional[float]:
  return statistics.median(values) * 1e-6 if values else None


def snapshot() -> dict:
  """{'spans': {name: calls, total_s, self_s, profiled (the ring's calls
  under a profiler), median_ms and median_self_ms over the ring's other
  calls (None where it has none)}, 'counters': {name: count}}, of the
  spans called since the last ``reset``."""
  spans = {}
  for name, s in list(_SPANS.items()):
    if not s.calls:
      continue
    ring = list(s.ring)
    free = [r for r in ring if not r[2]]
    spans[name] = {
        'calls': s.calls, 'total_s': s.total_ns * 1e-9,
        'self_s': s.self_ns * 1e-9, 'profiled': len(ring) - len(free),
        'median_ms': _median_ms([r[0] for r in free]),
        'median_self_ms': _median_ms([r[1] for r in free])}
  counters = {f'{g}.{k}' if g else k: v
              for g, d in list(_COUNTERS.items()) for k, v in d.items()}
  return {'spans': spans, 'counters': counters}


def reset() -> None:
  """Zeroes every span and counter in place (a counter group keeps its
  dict and its keys)."""
  for s in _SPANS.values():
    s.clear()
  for d in _COUNTERS.values():
    d.update(dict.fromkeys(d, 0))


def report(prefix: str = '') -> str:
  """The snapshot's spans and counters whose names start with ``prefix``,
  one line each: calls, total and self seconds, median and median self
  ms."""
  snap = snapshot()
  fmt = lambda v: 'n/a' if v is None else f'{v:.3f}'
  lines = [f'{n}: calls {s["calls"]} total {s["total_s"]:.3f} s self '
           f'{s["self_s"]:.3f} s median {fmt(s["median_ms"])} ms self '
           f'{fmt(s["median_self_ms"])} ms'
           for n, s in sorted(snap['spans'].items()) if n.startswith(prefix)]
  lines += [f'{n}: {v}' for n, v in sorted(snap['counters'].items())
            if n.startswith(prefix)]
  return '\n'.join(lines)
