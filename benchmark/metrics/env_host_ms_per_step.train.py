"""Host ms of the env layer in one control step: the median self time of
the port's span ``env.step`` (the training wrappers and the env's own
step, its physics substeps out) over its newest calls outside the
profiler, unsynchronised."""

from benchmark.metrics import _spans


def read(ctx, out):
  return _spans.read(ctx, 'env.step', 'median_self_ms')
