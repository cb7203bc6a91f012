"""The hand-written kernels' least time over their device time in the
profiled sub-window, in % of the roofline."""

from benchmark.metrics import _readers


def read(ctx, out):
  return _readers.kernel_roofline(ctx, out)
