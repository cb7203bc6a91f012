"""Device ms of the narrow phase in one physics substep: the kernels
launched under the port's span ``physics.collision`` in the eager probe
of the full-collision scene, per substep."""

from benchmark.metrics import _stages


def read(ctx, out):
  return _stages.read(out, 'physics.collision')
