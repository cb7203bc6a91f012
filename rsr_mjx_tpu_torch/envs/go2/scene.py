"""Unitree Go2 scene as MJCF (feet-only collision, primitives).

The port's own copy of the flat-terrain part of
``rsr_mjx_tpu/envs/go2/scene.py``: kinematic chain, inertials, joint classes
(damping 0.5, armature 0.005, frictionloss 0.3/1.0), kp=35 position
actuators with ±24/±35.55 Nm force ranges, sphere feet as the only
colliders, the IMU + feet sensor suite (17 sensors, 52 values), and the
home/footstand/handstand/pre-recovery keyframes.  The rough-terrain and
full-collision scenes come with the slices that run them.

The MJCF is compiled by ``snapshot.py`` where ``mujoco`` is installed; the
envs read the committed snapshot.
"""

from __future__ import annotations

_LEGS = {
    'FR': ((0.1934, -0.0465, 0), (0, -0.0955, 0), -1),
    'FL': ((0.1934, 0.0465, 0), (0, 0.0955, 0), 1),
    'RR': ((-0.1934, -0.0465, 0), (0, -0.0955, 0), -1),
    'RL': ((-0.1934, 0.0465, 0), (0, 0.0955, 0), 1),
}

# per-leg inertials (hip, thigh, calf) — front/rear mirror x, left/right
# mirror y (go2_mjx_feetonly.xml)
_HIP_I = (
    '0.00088403 0.000596003 0.000479967',
    0.678,
)
_THIGH_I = ('0.00594973 0.00584149 0.000878787', 1.152)
_CALF_I = ('0.0014901 0.00146356 5.31397e-05', 0.241352)

_HIP_QUAT = {
    'FR': '0.498237 0.505462 0.499245 0.497014',
    'FL': '0.497014 0.499245 0.505462 0.498237',
    'RR': '0.499245 0.497014 0.498237 0.505462',
    'RL': '0.505462 0.498237 0.497014 0.499245',
}
_THIGH_QUAT = {
    'FR': '0.551623 -0.0200632 0.0847635 0.829533',
    'FL': '0.829533 0.0847635 -0.0200632 0.551623',
    'RR': '0.551623 -0.0200632 0.0847635 0.829533',
    'RL': '0.829533 0.0847635 -0.0200632 0.551623',
}
_CALF_QUAT = {
    'FR': '0.703508 -0.00450087 0.00154099 0.710672',
    'FL': '0.710672 0.00154099 -0.00450087 0.703508',
    'RR': '0.703508 -0.00450087 0.00154099 0.710672',
    'RL': '0.710672 0.00154099 -0.00450087 0.703508',
}


def _leg_xml(name: str) -> str:
  hip_pos, thigh_pos, side = _LEGS[name]
  fr = 1 if name[0] == 'F' else -1
  hip_ipos = f'{0.0054 * -fr} {0.00194 * side} -0.000105'
  thigh_ipos = f'-0.00374 {-0.0223 * -side} -0.0327'
  calf_ipos = f'0.00629595 {0.000622121 * -side} -0.141417'
  return f"""
      <body name="{name}_hip" pos="{hip_pos[0]} {hip_pos[1]} {hip_pos[2]}">
        <inertial pos="{hip_ipos}" quat="{_HIP_QUAT[name]}" mass="{_HIP_I[1]}" diaginertia="{_HIP_I[0]}"/>
        <joint name="{name}_hip_joint" class="abduction"/>
        <body name="{name}_thigh" pos="{thigh_pos[0]} {thigh_pos[1]} {thigh_pos[2]}">
          <inertial pos="{thigh_ipos}" quat="{_THIGH_QUAT[name]}" mass="{_THIGH_I[1]}" diaginertia="{_THIGH_I[0]}"/>
          <joint name="{name}_thigh_joint" class="hip"/>
          <body name="{name}_calf" pos="0 0 -0.213">
            <inertial pos="{calf_ipos}" quat="{_CALF_QUAT[name]}" mass="{_CALF_I[1]}" diaginertia="{_CALF_I[0]}"/>
            <joint name="{name}_calf_joint" class="knee"/>
            <geom name="{name}" class="foot"/>
            <site name="{name}" pos="0 0 -0.213" type="sphere" size="0.023" group="5"/>
          </body>
        </body>
      </body>
"""


_KEYFRAMES = """
  <keyframe>
    <key name="home" qpos="0 0 0.278  1 0 0 0  0.1 0.9 -1.8  -0.1 0.9 -1.8  0.1 0.9 -1.8  -0.1 0.9 -1.8"
      ctrl="0.1 0.9 -1.8 -0.1 0.9 -1.8 0.1 0.9 -1.8 -0.1 0.9 -1.8"/>
    <key name="home_higher" qpos="0 0 0.31 1 0 0 0 0 0.82 -1.63 0 0.82 -1.63 0 0.82 -1.63 0 0.82 -1.63"
      ctrl="0 0.82 -1.63 0 0.82 -1.63 0 0.82 -1.63 0 0.82 -1.63"/>
    <key name="footstand"
      qpos="0 0 0.54  0.8 0 -0.8 0  0 0.82 -1.6 0 0.82 -1.68 0 1.82 -1.16 0.0 1.82 -1.16"
      ctrl="0 0.82 -1.6 0 0.82 -1.68 0 1.82 -1.16 0.0 1.82 -1.16"/>
    <key name="handstand"
      qpos="0 0 0.54  0.8 0 0.8 0  0 -0.686 -1.16 0 -0.686 -1.16 0 1.7 -1.853 0 1.7 -1.853"
      ctrl="0 -0.686 -1.16 0 -0.686 -1.16 0 1.7 -1.853 0 1.7 -1.853"/>
    <key name="pre_recovery"
      qpos="-0.0318481 -0.000215369 0.0579031 1 -2.70738e-05 6.06169e-05 0.000231261 -0.352275 1.18554 -2.80738 0.360892 1.1806 -2.80281 -0.381197 1.16812 -2.79123 0.391054 1.1622 -2.78576"
      ctrl="-0.352275 1.18554 -2.80738 0.360892 1.1806 -2.80281 -0.381197 1.16812 -2.79123 0.391054 1.1622 -2.78576"/>
  </keyframe>
"""


def _robot_xml() -> str:
  legs = ''.join(_leg_xml(n) for n in ('FR', 'FL', 'RR', 'RL'))
  return f"""
  <default>
    <default class="go2">
      <geom condim="1" contype="0" conaffinity="0"/>
      <joint axis="0 1 0" damping="0.5" armature="0.005"/>
      <position forcerange="-24 24" inheritrange="1" kp="35"/>
      <default class="abduction">
        <joint axis="1 0 0" range="-1.0472 1.0472" frictionloss="0.3"/>
      </default>
      <default class="hip">
        <joint range="-1.5708 3.4907" frictionloss="0.3"/>
      </default>
      <default class="knee">
        <joint range="-2.7227 -0.83776" frictionloss="1.0"/>
        <position forcerange="-35.55 35.55"/>
      </default>
      <default class="collision">
        <geom group="3" type="capsule"/>
        <default class="foot">
          <geom type="sphere" size="0.023" pos="0 0 -0.213" solimp="0.9 .95 0.023" contype="0" conaffinity="1"/>
        </default>
      </default>
    </default>
  </default>

  <worldbody>
    <body name="trunk" pos="0 0 0.445" childclass="go2">
      <inertial pos="0.021112 0 -0.005366" quat="-0.000543471 0.713435 -0.00173769 0.700719" mass="6.921"
        diaginertia="0.107027 0.0980771 0.0244531"/>
      <freejoint/>
      <geom size="0.125 0.04675 0.057" type="box" class="collision"/>
      <site name="imu" pos="-0.02557 0 0.04232" group="5"/>
{legs}
    </body>
  </worldbody>

  <actuator>
    <position class="abduction" name="FR_hip" joint="FR_hip_joint"/>
    <position class="hip" name="FR_thigh" joint="FR_thigh_joint"/>
    <position class="knee" name="FR_calf" joint="FR_calf_joint"/>
    <position class="abduction" name="FL_hip" joint="FL_hip_joint"/>
    <position class="hip" name="FL_thigh" joint="FL_thigh_joint"/>
    <position class="knee" name="FL_calf" joint="FL_calf_joint"/>
    <position class="abduction" name="RR_hip" joint="RR_hip_joint"/>
    <position class="hip" name="RR_thigh" joint="RR_thigh_joint"/>
    <position class="knee" name="RR_calf" joint="RR_calf_joint"/>
    <position class="abduction" name="RL_hip" joint="RL_hip_joint"/>
    <position class="hip" name="RL_thigh" joint="RL_thigh_joint"/>
    <position class="knee" name="RL_calf" joint="RL_calf_joint"/>
  </actuator>

  <sensor>
    <gyro site="imu" name="gyro"/>
    <velocimeter site="imu" name="local_linvel"/>
    <accelerometer site="imu" name="accelerometer"/>
    <framepos objtype="site" objname="imu" name="position"/>
    <framezaxis objtype="site" objname="imu" name="upvector"/>
    <framexaxis objtype="site" objname="imu" name="forwardvector"/>
    <framelinvel objtype="site" objname="imu" name="global_linvel"/>
    <frameangvel objtype="site" objname="imu" name="global_angvel"/>
    <framequat objtype="site" objname="imu" name="orientation"/>
    <framelinvel objtype="site" objname="FR" name="FR_global_linvel"/>
    <framelinvel objtype="site" objname="FL" name="FL_global_linvel"/>
    <framelinvel objtype="site" objname="RR" name="RR_global_linvel"/>
    <framelinvel objtype="site" objname="RL" name="RL_global_linvel"/>
    <framepos objtype="site" objname="FR" name="FR_pos" reftype="site" refname="imu"/>
    <framepos objtype="site" objname="FL" name="FL_pos" reftype="site" refname="imu"/>
    <framepos objtype="site" objname="RR" name="RR_pos" reftype="site" refname="imu"/>
    <framepos objtype="site" objname="RL" name="RL_pos" reftype="site" refname="imu"/>
  </sensor>
"""


def build_flat_scene() -> str:
  """Flat-terrain Go2 scene (scene_mjx_feetonly_flat_terrain.xml)."""
  return f"""
<mujoco model="go2_feetonly_flat">
  <option iterations="1" ls_iterations="5" timestep="0.004" integrator="Euler">
    <flag eulerdamp="disable"/>
  </option>
  <compiler angle="radian"/>
{_robot_xml()}
  <worldbody>
    <geom name="floor" size="0 0 0.01" type="plane" contype="1" conaffinity="0" priority="1"
      friction="0.6" condim="3"/>
  </worldbody>
{_KEYFRAMES}
</mujoco>
"""
