"""Device ms of the constraint assembly in one physics substep, the
narrow phase within it: the kernels launched under the port's span
``physics.assembly`` in the eager probe of the full-collision scene, per
substep."""

from benchmark.metrics import _stages


def read(ctx, out):
  return _stages.read(out, 'physics.assembly')
