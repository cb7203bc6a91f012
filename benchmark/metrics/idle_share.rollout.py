"""Share of the profiled sub-window's wall time in which no operation ran
on the device, in %."""

from benchmark.metrics import _readers


def read(ctx, out):
  return _readers.idle_share(out)
