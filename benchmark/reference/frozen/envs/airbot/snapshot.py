"""The committed model snapshot of the cube-push training scene.

The port's builder of the file (the MJCF of its ``scene.py`` compiled with
``mujoco``) is left out of this copy: the machine that runs the benchmark
has no ``mujoco``, and the env reads the compiled model with numpy alone.
"""

from __future__ import annotations

import os

from benchmark.reference.frozen.physics import io


def path(variant: str) -> str:
  """The snapshot of cube-push ``variant`` ('train')."""
  return os.path.join(io.ASSETS, f'airbot_cube_push_{variant}.npz')
