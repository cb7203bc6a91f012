"""Optional ROS1 adapter implementing RobotInterface.

Copy of ``rsr_mjx_tpu/deploy/ros_adapter.py`` (numpy; ``rospy`` where it is
installed).

Thin transport shim over the reference's ROS topics
(real_robot_interface.py:12-32): subscribes to
/airbot_play/{joint_states,end_pose}, /qr_coordinates; publishes
/airbot_play/set_target_joint_q and /airbot_play/step_complete.
Importable only where rospy exists — everything task-relevant lives in the
transport-agnostic control loop and observation builder.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from rsr_mjx_tpu_torch.deploy.interface import RobotInterface

try:
  import rospy
  from geometry_msgs.msg import Point, Pose
  from sensor_msgs.msg import JointState
  from std_msgs.msg import Float64, Header

  _HAS_ROS = True
except ImportError:  # pragma: no cover - hardware-only dependency
  _HAS_ROS = False


class RosRobotInterface(RobotInterface):  # pragma: no cover - hardware-only
  """ROS1 Airbot Play interface."""

  def __init__(self):
    if not _HAS_ROS:
      raise ImportError('rospy is required for RosRobotInterface')
    self._marker = None
    self._marker_fresh = False
    self._joint_state = JointState()
    self._end_pose = Pose()
    self._pub_joint_q = rospy.Publisher(
        '/airbot_play/set_target_joint_q', JointState, queue_size=10
    )
    self._pub_gripper = rospy.Publisher(
        '/airbot_play/gripper/set_position', Float64, queue_size=10
    )
    self._pub_step = rospy.Publisher(
        '/airbot_play/step_complete', Header, queue_size=10
    )
    rospy.Subscriber(
        '/airbot_play/joint_states', JointState, self._joint_cb
    )
    rospy.Subscriber('/airbot_play/end_pose', Pose, self._end_pose_cb)
    rospy.Subscriber('/qr_coordinates', Point, self._marker_cb)

  def _joint_cb(self, msg):
    self._joint_state = msg

  def _end_pose_cb(self, msg):
    self._end_pose = msg

  def _marker_cb(self, msg):
    self._marker = np.array([msg.x, msg.y])
    self._marker_fresh = True

  def get_joint_positions(self) -> np.ndarray:
    return np.asarray(self._joint_state.position)

  def get_end_pose(self) -> np.ndarray:
    p = self._end_pose.position
    return np.array([p.x, p.y, p.z])

  def get_marker_position(self) -> Optional[np.ndarray]:
    if not self._marker_fresh:
      return None
    self._marker_fresh = False
    return self._marker

  def send_joint_position_cmd(self, joint_positions: np.ndarray) -> None:
    js = JointState()
    js.name = [f'joint{i}' for i in range(1, 7)]
    js.position = list(np.asarray(joint_positions))
    self._pub_joint_q.publish(js)

  def send_gripper_cmd(self, value: float) -> None:
    self._pub_gripper.publish(Float64(data=value))

  def publish_step_complete(self, step: int) -> None:
    self._pub_step.publish(Header(stamp=rospy.Time.now(), seq=step))
