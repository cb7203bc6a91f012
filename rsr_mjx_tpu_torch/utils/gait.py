"""Quadruped gait utilities.

Counterpart of ``rsr_mjx_tpu/utils/gait.py``: the cubic-bezier swing-height
profile (``get_rz``, in torch), the canonical gait phase offsets, and the
joystick-command arrow for rendered frames (numpy and ``mujoco``, imported
where it is drawn).
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch


def get_rz(
    phi: Union[torch.Tensor, float],
    swing_height: Union[torch.Tensor, float] = 0.08,
) -> torch.Tensor:
  """Desired foot height at gait phase ``phi``."""

  def cubic_bezier_interpolation(y_start, y_end, x):
    y_diff = y_end - y_start
    bezier = x**3 + 3 * (x**2 * (1 - x))
    return y_start + y_diff * bezier

  phi = torch.as_tensor(phi)
  if not phi.is_floating_point():
    phi = phi.to(torch.float32)
  x = (phi + math.pi) / (2 * math.pi)
  stance = cubic_bezier_interpolation(0, swing_height, 2 * x)
  swing = cubic_bezier_interpolation(swing_height, 0, 2 * x - 1)
  return torch.where(x <= 0.5, stance, swing)


# foot phase offsets (FR, FL, RR, RL): trot, walk, pace, bound, pronk
GAIT_PHASES = {
    0: np.array([0, np.pi, np.pi, 0]),
    1: np.array([0, 0.5 * np.pi, np.pi, 1.5 * np.pi]),
    2: np.array([0, np.pi, 0, np.pi]),
    3: np.array([0, 0, np.pi, np.pi]),
    4: np.array([0, 0, 0, 0]),
}


def draw_joystick_command(
    scn,
    cmd,
    xyz,
    theta: float,
    rgba=(0.2, 0.2, 0.6, 0.3),
    radius: float = 0.02,
    scl: float = 1.0,
) -> None:
  """Add a decoration arrow for a joystick command to an mjvScene.

  The arrow starts at ``xyz`` and points along the commanded planar
  velocity ``cmd = (vx, vy, vyaw)`` rotated into the world frame by the
  robot's heading ``theta`` plus the yaw command.  Pass as a per-frame
  scene hook to ``utils.rendering.render_array(modify_scene=...)``.
  """
  import mujoco

  vx, vy, vyaw = np.asarray(cmd, dtype=np.float64)[:3]
  heading = float(theta) + vyaw
  # planar command rotated into the world frame, unit-normalized
  wx = np.cos(heading) * vx - np.sin(heading) * vy
  wy = np.sin(heading) * vx + np.cos(heading) * vy
  direction = np.array([wx, wy, 0.0])
  direction /= np.linalg.norm(direction) + 1e-6

  geom = scn.geoms[scn.ngeom]
  scn.ngeom += 1
  geom.category = mujoco.mjtCatBit.mjCAT_DECOR
  mujoco.mjv_initGeom(
      geom=geom,
      type=mujoco.mjtGeom.mjGEOM_ARROW.value,
      size=np.zeros(3),
      pos=np.zeros(3),
      mat=np.zeros(9),
      rgba=np.asarray(rgba, dtype=np.float32),
  )
  start = np.asarray(xyz, dtype=np.float64)
  mujoco.mjv_connector(
      geom=geom,
      type=mujoco.mjtGeom.mjGEOM_ARROW.value,
      width=radius,
      from_=start,
      to=start + scl * direction,
  )
