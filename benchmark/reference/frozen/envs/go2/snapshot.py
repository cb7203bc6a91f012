"""The committed model snapshot of the Go2 flat scene.

The port's builder of the file (the MJCF of its ``scene.py`` compiled with
``mujoco``) is left out of this copy.  The snapshot holds its scene as
compiled (timestep 0.004, kp 35, damping 0.5); the env applies its config
(``sim_dt``, ``Kp``, ``Kd``) to the loaded model.
"""

from __future__ import annotations

import os

from benchmark.reference.frozen.physics import io

TASKS = {'flat_terrain': 'go2_joystick_flat.npz'}


def path(task: str) -> str:
  return os.path.join(io.ASSETS, TASKS[task])
