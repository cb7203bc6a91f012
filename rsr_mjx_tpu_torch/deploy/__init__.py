"""Real-robot deployment: checkpoint inference, obs reconstruction,
control loop, optional ROS adapters.

Counterpart of ``rsr_mjx_tpu/deploy``.  ``PolicyInference`` serves a
trained policy on the card (or the CPU); the rest is host numpy.
``perception`` (``cv2``) and ``ros_adapter`` (``rospy``) are imported on
their own.
"""

from rsr_mjx_tpu_torch.deploy.interface import (
    RobotInterface,
    build_cube_observation,
)
from rsr_mjx_tpu_torch.deploy.policy import PolicyInference
from rsr_mjx_tpu_torch.deploy.control_loop import run_cube_push_control_loop

__all__ = [
    'PolicyInference',
    'RobotInterface',
    'build_cube_observation',
    'run_cube_push_control_loop',
]
