"""Hardware control loop for the cube-push task.

Copy of ``rsr_mjx_tpu/deploy/control_loop.py`` (numpy only); at the end
it also logs the host time of the policy's calls (``utils.tracing``).

Transport-agnostic re-implementation of the reference control node
(airbot_sim2real_sl/scripts/sim2real_sl_control_node.py:23-126): a 10 Hz
loop that waits for a fresh marker pose, rebuilds the sim observation,
runs the policy, re-applies the sim's analytic joint couplings on hardware
(joint5 = −(1.57+q2+q3); joint6 tracks the cube→target bearing with
hysteresis near the target), clips to joint limits, declares success at
dist < 0.008, and blocks until joints reach the target or time out.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from rsr_mjx_tpu_torch.deploy.interface import (
    DEFAULT_TARGET_POS,
    RobotInterface,
    build_cube_observation,
)
from rsr_mjx_tpu_torch.utils import tracing

JOINT_LOWER = np.array([-3.14, -2.96, -0.087, -2.96, -1.74, -3.14])
JOINT_UPPER = np.array([2.09, 0.17, 3.14, 2.96, 1.74, 3.14])


def run_cube_push_control_loop(
    robot: RobotInterface,
    policy,
    target_pos: Sequence[float] = DEFAULT_TARGET_POS,
    rate_hz: float = 10.0,
    max_steps: int = 10_000,
    joint_tolerance: float = 0.01,
    joint_timeout: float = 5.0,
    success_dist: float = 0.008,
    obs_log_path: Optional[str] = 'real_obs.txt',
    logger=print,
) -> int:
  """Run until ``max_steps``; returns the number of executed steps and
  logs the host time of the policy's calls (span ``deploy.get_action``).

  ``policy`` is anything with ``get_action(obs, deterministic=True)``
  (e.g. deploy.PolicyInference).
  """
  period = 1.0 / rate_hz
  last_action5 = 0.0
  step_count = 0

  while step_count < max_steps:
    marker = robot.get_marker_position()
    while marker is None:
      robot.sleep(0.01)
      marker = robot.get_marker_position()

    joints = np.asarray(robot.get_joint_positions())
    obs = build_cube_observation(
        joints,
        robot.get_end_pose(),
        marker,
        target_pos,
        obs_log_path=obs_log_path,
    )
    marker_pos = [marker[0], marker[1], 0.82]
    init_dis = np.linalg.norm(np.asarray(target_pos) - marker_pos)

    ctrl = np.asarray(policy.get_action(obs, deterministic=True))
    # delta command on joints 1-3; joint4 held, 5/6 slaved analytically
    ctrl = np.insert(ctrl, 3, 0.0)[:6]
    new_joints = joints + ctrl
    new_joints[3] = 1.57

    delta_x = target_pos[0] - marker_pos[0]
    delta_y = target_pos[1] - marker_pos[1]
    angle_to_box = np.arctan2(delta_y, delta_x + 0.00001)
    bearing = -angle_to_box + new_joints[0] + 1.5708
    new_joints[5] = last_action5 if init_dis < 0.01 else bearing
    last_action5 = new_joints[5]
    new_joints[4] = -(1.57 + new_joints[1] + new_joints[2])
    new_joints = np.clip(new_joints, JOINT_LOWER, JOINT_UPPER)

    dis_to_target = np.linalg.norm(
        np.asarray(target_pos[:2]) - np.asarray(marker_pos[:2])
    )
    if dis_to_target < success_dist:
      logger('Cube reached target position.')
      step_count += 1
      robot.sleep(period)
      continue

    robot.send_joint_position_cmd(new_joints)
    start = time.time()
    reached = False
    while time.time() - start < joint_timeout:
      errors = np.abs(
          np.asarray(robot.get_joint_positions()) - new_joints
      )
      if np.all(errors < joint_tolerance):
        reached = True
        break
      robot.sleep(period)
    if reached:
      robot.publish_step_complete(step_count)
    else:
      logger(f'Joint movement timeout after {joint_timeout}s; continuing.')
    step_count += 1
  log_policy_time(logger)
  return step_count


def log_policy_time(logger) -> None:
  """Logs the ``deploy.get_action`` span's calls and host time, where the
  policy had any (``utils.tracing``)."""
  text = tracing.report('deploy.')
  if text:
    logger(text)
