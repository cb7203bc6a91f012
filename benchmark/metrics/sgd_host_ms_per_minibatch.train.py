"""Host ms of one SGD minibatch: the median total of the port's span
``ppo.minibatch_step`` over its newest calls outside the profiler,
unsynchronised; beside ``sgd_ms_per_minibatch.train`` (synchronised) it
says how much of a minibatch the host sets."""

from benchmark.metrics import _spans


def read(ctx, out):
  return _spans.read(ctx, 'ppo.minibatch_step', 'median_ms')
