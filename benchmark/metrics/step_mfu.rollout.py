"""The window's counted FLOPs (the kernels' least work every substep and
the networks' matmuls) over the window's seconds times the float32 peak,
in %: a lower bound, the stages' elementwise work is not counted."""

from benchmark.metrics import _readers


def read(ctx, out):
  return _readers.step_mfu(ctx, out)
