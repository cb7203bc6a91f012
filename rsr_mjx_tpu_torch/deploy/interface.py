"""Hardware interface abstraction + observation reconstruction.

Copy of ``rsr_mjx_tpu/deploy/interface.py`` (numpy only).

``build_cube_observation`` reconstructs the exact 23-dim sim observation
layout from hardware readings (reference:
airbot_sim2real_sl/src/.../real_robot_interface.py:49-85) — this is the
real-data collection path that feeds the RSR pipeline, so rows are
appended to an obs log file in the same comma-separated format.

``RobotInterface`` is the transport-agnostic contract the control loop
drives; the ROS1 implementation lives in ``ros_adapter`` and is optional
(hardware-bound code cannot run in CI).
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence

import numpy as np

DEFAULT_TARGET_POS = (0.455355, 0.082943, 0.82)


def build_cube_observation(
    joint_positions: Sequence[float],
    end_pos: Sequence[float],
    marker_pos_xy: Sequence[float],
    target_pos: Sequence[float] = DEFAULT_TARGET_POS,
    end_z_offset: float = 0.78 - 0.025,
    obs_log_path: Optional[str] = None,
) -> np.ndarray:
  """23-dim observation from hardware readings.

  Layout (matches AirbotCubePush._get_obs / real_robot_interface.py:49-85):
    6 joint angles, endpoint xyz (z shifted into the sim's table frame),
    target xyz, cube xyz (marker at table height), 2-dim approach point one
    cube-length behind the cube on the target bearing, target−cube,
    cube−endpoint.
  """
  joints = list(joint_positions)[:6]
  end_pos = [end_pos[0], end_pos[1], end_pos[2] + end_z_offset]
  marker_pos = [marker_pos_xy[0], marker_pos_xy[1], 0.82]
  target_pos = list(target_pos)

  direction = np.asarray(marker_pos[:2]) - np.asarray(target_pos[:2])
  direction = direction / np.linalg.norm(direction)
  new_cube_pos = np.asarray(marker_pos[:2]) + direction * 0.04

  obs = np.concatenate([
      joints,
      end_pos,
      target_pos,
      marker_pos,
      new_cube_pos,
      np.asarray(target_pos) - np.asarray(marker_pos),
      np.asarray(marker_pos) - np.asarray(end_pos),
  ]).astype(np.float64)
  if obs_log_path:
    with open(obs_log_path, 'a') as f:
      np.savetxt(f, obs.reshape(1, -1), fmt='%.6f', delimiter=',')
  return obs


class RobotInterface(abc.ABC):
  """Transport-agnostic hardware contract for the control loops."""

  @abc.abstractmethod
  def get_joint_positions(self) -> np.ndarray:
    """Current 6 arm joint angles (rad)."""

  @abc.abstractmethod
  def get_end_pose(self) -> np.ndarray:
    """End-effector xyz in the robot base frame."""

  @abc.abstractmethod
  def get_marker_position(self) -> Optional[np.ndarray]:
    """Latest marker (cube) xy, or None if no fresh detection."""

  @abc.abstractmethod
  def send_joint_position_cmd(self, joint_positions: np.ndarray) -> None:
    """Command target joint angles."""

  def publish_step_complete(self, step: int) -> None:
    """Synchronization hook for the perception pipeline (optional)."""

  def sleep(self, seconds: float) -> None:
    import time

    time.sleep(seconds)
