"""Host ms of one physics substep: the median total of the port's span
``physics.step`` over its newest calls outside the profiler, unsynchronised
(the host's time to issue a substep)."""

from benchmark.metrics import _spans


def read(ctx, out):
  return _spans.read(ctx, 'physics.step', 'median_ms')
