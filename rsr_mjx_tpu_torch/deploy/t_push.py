"""T-shape push deployment: obs reconstruction + control loop.

Copy of ``rsr_mjx_tpu/deploy/t_push.py`` (numpy only).

Native equivalent of the airbot_t package (sim2real_t_node.py:20-106,
airbot_t real_robot_interface.py:63-98): two AprilTags give the T base
(point1) and vertical (point0) positions plus an offset approach point;
the 16-dim sim observation is rebuilt from them, success is the
orientation error ``xita = |cos∠(box, target) − 1| < 0.006``.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from rsr_mjx_tpu_torch.deploy.control_loop import (
    JOINT_LOWER,
    JOINT_UPPER,
    log_policy_time,
)
from rsr_mjx_tpu_torch.deploy.interface import RobotInterface

# reference target geometry (sim2real_t_node.py:63-69)
T_TARGET_BASE = np.array([0.29, 0.12, 0.805])
T_TARGET_VERT = np.array([0.343033, 0.066967, 0.805])


def t_orientation_error(point0_xy, point1_xy) -> float:
  """xita = |cosine(box, target) − 1| (sim2real_t_node.py:70-76)."""
  target_array = T_TARGET_VERT - T_TARGET_BASE
  box_array = np.array(
      [point0_xy[0] - point1_xy[0], point0_xy[1] - point1_xy[1], 0.0]
  )
  c = np.dot(box_array, target_array) / (
      np.linalg.norm(box_array) * np.linalg.norm(target_array)
  )
  return float(np.abs(c - 1.0))


def build_t_observation(
    joint_positions: Sequence[float],
    end_pose: Sequence[float],
    point0_xy: Sequence[float],
    point1_xy: Sequence[float],
    new_point_xy: Sequence[float],
    obs_log_path: Optional[str] = None,
) -> np.ndarray:
  """16-dim T-shape observation (airbot_t real_robot_interface.py:63-98)."""
  obs = np.concatenate([
      list(joint_positions)[:6],
      [end_pose[2] + 0.78 - 0.023],
      [
          T_TARGET_BASE[0] - point1_xy[0],
          T_TARGET_BASE[1] - point1_xy[1],
          0.0,
      ],
      [
          T_TARGET_VERT[0] - point0_xy[0],
          T_TARGET_VERT[1] - point0_xy[1],
          0.0,
      ],
      [t_orientation_error(point0_xy, point1_xy)],
      [
          new_point_xy[0] - end_pose[0],
          new_point_xy[1] - end_pose[1],
      ],
  ]).astype(np.float64)
  if obs_log_path:
    with open(obs_log_path, 'a') as f:
      np.savetxt(f, obs.reshape(1, -1), fmt='%.6f', delimiter=',')
  return obs


class TRobotInterface(RobotInterface):
  """Extends the base contract with the two-tag T perception."""

  def get_t_points(self):
    """(point0_xy, point1_xy, new_point_xy) or None when not fresh."""
    raise NotImplementedError


def run_t_push_control_loop(
    robot: TRobotInterface,
    policy,
    rate_hz: float = 10.0,
    max_steps: int = 10_000,
    joint_tolerance: float = 0.01,
    joint_timeout: float = 5.0,
    success_xita: float = 0.006,
    obs_log_path: Optional[str] = 'real_obs.txt',
    logger=print,
) -> int:
  """10 Hz T-push loop (sim2real_t_node.py:40-106); logs the policy's
  host time as the cube-push loop does."""
  period = 1.0 / rate_hz
  step_count = 0
  # endpoint bearing target (sim2real_t_node.py:50-55)
  bearing_target = np.array([0.36071068, 0.04928932])

  while step_count < max_steps:
    pts = robot.get_t_points()
    while pts is None:
      robot.sleep(0.01)
      pts = robot.get_t_points()
    point0, point1, new_point = pts

    joints = np.asarray(robot.get_joint_positions())
    end = np.asarray(robot.get_end_pose())
    obs = build_t_observation(
        joints, end, point0, point1, new_point, obs_log_path=obs_log_path
    )
    ctrl = np.asarray(policy.get_action(obs, deterministic=True))
    ctrl = np.insert(ctrl, 3, 0.0)[:6]
    new_joints = joints + ctrl
    new_joints[3] = 1.57
    delta = bearing_target - end[:2]
    angle = np.arctan2(delta[1], delta[0] + 0.00001)
    new_joints[5] = -angle + ctrl[0] + 1.5708
    new_joints[4] = -(1.57 + new_joints[1] + new_joints[2])
    new_joints = np.clip(new_joints, JOINT_LOWER, JOINT_UPPER)

    if t_orientation_error(point0, point1) < success_xita:
      logger('T reached target position.')
      step_count += 1
      robot.sleep(period)
      continue

    robot.send_joint_position_cmd(new_joints)
    start = time.time()
    reached = False
    while time.time() - start < joint_timeout:
      errors = np.abs(np.asarray(robot.get_joint_positions()) - new_joints)
      if np.all(errors < joint_tolerance):
        reached = True
        break
      robot.sleep(period)
    if not reached:
      logger(f'Joint movement timeout after {joint_timeout}s; continuing.')
    step_count += 1
  log_policy_time(logger)
  return step_count
