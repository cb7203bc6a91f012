"""Device kernels launched in the profiled sub-window per physics substep
(the train cell counts its SGD launches in, scaled to a training step's
mix)."""

from benchmark.metrics import _readers


def read(ctx, out):
  return _readers.launches_per_substep(out)
