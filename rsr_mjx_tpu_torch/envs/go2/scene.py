"""Unitree Go2 scenes as MJCF (primitives).

The port's own copy of ``rsr_mjx_tpu/envs/go2/scene.py``: kinematic chain,
inertials, joint classes (damping 0.5, armature 0.005, frictionloss
0.3/1.0), kp=35 position actuators with ±24/±35.55 Nm force ranges, the
IMU + feet sensor suite (17 sensors, 52 values), and the
home/footstand/handstand/pre-recovery keyframes, in three scenes:

  - ``build_flat_scene``: sphere feet as the only colliders, on a plane
    (the joystick);
  - ``build_rough_scene``: the same robot on the reference's 256 × 256
    heightfield (the rough-terrain joystick); its heights are
    ``reference_heightfield()``, written into the model by ``snapshot.py``;
  - ``build_full_scene``: the full-collision robot (capsule trunk, hips,
    thighs and calves, sphere feet) on a plane, with 100 condim-1
    self-collision ``<pair>``s (getup, handstand, footstand).

The procedural ``rough_heightfield`` of the JAX module is used by no env and
is not copied.  The MJCF is compiled by ``snapshot.py`` where ``mujoco`` is
installed; the envs read the committed snapshots.
"""

from __future__ import annotations

import os

import numpy as np

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


def build_rough_scene(nrow: int = 256, ncol: int = 256) -> str:
  """Rough-terrain scene with the reference heightfield geometry
  (scene_mjx_feetonly_rough_terrain.xml:15-24: hfield size 10×10 m,
  0.05 m elevation range, 0.1 m base).  The elevations themselves are
  ``reference_heightfield()``, which ``snapshot.py`` writes into the
  compiled model, as the JAX Go2 env does."""
  return f"""
<mujoco model="go2_feetonly_rough">
  <option iterations="1" ls_iterations="5" timestep="0.004" integrator="Euler">
    <flag eulerdamp="disable"/>
  </option>
  <compiler angle="radian"/>
  <asset>
    <hfield name="terrain" nrow="{nrow}" ncol="{ncol}" size="10 10 0.05 0.1"/>
  </asset>
{_robot_xml()}
  <worldbody>
    <geom name="floor" type="hfield" hfield="terrain" contype="1" conaffinity="0" priority="1"
      friction="1.0" condim="3"/>
  </worldbody>
{_KEYFRAMES}
</mujoco>
"""


def reference_heightfield() -> np.ndarray:
  """The reference's compiled heightfield (65536 elevations in [0, 1],
  float64), from the port's copy ``rsr_mjx_tpu_torch/assets/
  hfield_heights.npz`` of the JAX package's asset."""
  path = os.path.join(os.path.dirname(os.path.dirname(
      os.path.dirname(os.path.abspath(__file__)))), 'assets',
      'hfield_heights.npz')
  with np.load(path) as z:
    return z['heights'].astype(np.float64)


_FULL_LEG_POS = {
    'FR': ((0.1881, -0.04675, 0), (0, -0.08, 0)),
    'FL': ((0.1881, 0.04675, 0), (0, 0.08, 0)),
    'RR': ((-0.1881, -0.04675, 0), (0, -0.08, 0)),
    'RL': ((-0.1881, 0.04675, 0), (0, 0.08, 0)),
}
_FULL_HIP_QUAT = {
    'FR': '0.507341 0.514169 0.495027 0.482891',
    'FL': '0.482891 0.495027 0.514169 0.507341',
    'RR': '0.495027 0.482891 0.507341 0.514169',
    'RL': '0.514169 0.507341 0.482891 0.495027',
}
_FULL_THIGH_QUAT = {
    'FR': '0.65243 -0.0272313 0.0775126 0.753383',
    'FL': '0.753383 0.0775126 -0.0272313 0.65243',
    'RR': '0.65243 -0.0272313 0.0775126 0.753383',
    'RL': '0.753383 0.0775126 -0.0272313 0.65243',
}


def _full_leg_xml(name: str) -> str:
  hip_pos, thigh_pos = _FULL_LEG_POS[name]
  lo = name.lower()
  fr = 1 if name[0] == 'F' else -1
  side = 1 if name[1] == 'L' else -1
  hip_ipos = f'{-0.0049166 * fr} {0.00762615 * -side} -8.865e-05'
  thigh_ipos = f'-0.00304722 {0.019315 * -side} -0.0305004'
  hip_cls = 'hip_left' if side == 1 else 'hip_right'
  return f"""
      <body name="{name}_hip" pos="{hip_pos[0]} {hip_pos[1]} {hip_pos[2]}">
        <inertial pos="{hip_ipos}" quat="{_FULL_HIP_QUAT[name]}" mass="0.68" diaginertia="0.000734064 0.000468438 0.000398719"/>
        <joint class="abduction" name="{name}_hip_joint"/>
        <geom name="{lo}_hip" class="{hip_cls}1"/>
        <body name="{name}_thigh" pos="{thigh_pos[0]} {thigh_pos[1]} {thigh_pos[2]}">
          <inertial pos="{thigh_ipos}" quat="{_FULL_THIGH_QUAT[name]}" mass="1.009" diaginertia="0.00478717 0.00460903 0.000709268"/>
          <joint class="hip" name="{name}_thigh_joint"/>
          <geom name="{lo}_thigh1" class="thigh1"/>
          <geom name="{lo}_thigh2" class="thigh2"/>
          <geom name="{lo}_thigh3" class="thigh3"/>
          <body name="{name}_calf" pos="0 0 -0.213">
            <inertial pos="0.00429862 0.000976676 -0.146197" quat="0.691246 0.00357467 0.00511118 0.722592" mass="0.195862" diaginertia="0.00149767 0.00148468 3.58427e-05"/>
            <joint class="knee" name="{name}_calf_joint"/>
            <geom name="{lo}_calf1" class="calf1"/>
            <geom name="{lo}_calf2" class="calf2"/>
            <geom name="{name}" class="foot"/>
            <site name="{name}" pos="0 0 -0.213" type="sphere" size="0.023" group="5"/>
          </body>
        </body>
      </body>
"""


def _self_collision_pairs() -> str:
  """Explicit <pair> elements enabling bounded robot self-collision.

  The reference full-collision model allows all robot part↔part contact
  via contype/conaffinity and bounds the simultaneous set dynamically with
  MJX's ``max_geom_pairs=12`` custom (go2_mjx_fullcollisions.xml).  The
  static-shape engine instead enumerates the pairs that are geometrically
  reachable in folded/fall poses — cross-leg feet/calves/thighs and
  leg↔trunk — each a single-slot capsule/sphere contact, so the whole set
  adds ~100 static narrow-phase slots.  Pair contact params are mixed from
  the geom params (geom-combine rule) rather than MJCF pair defaults.
  """
  legs = ('FR', 'FL', 'RR', 'RL')
  pairs = []
  # cross-leg: feet↔feet, foot↔calf, calf↔calf, thigh1↔thigh1
  for i, a in enumerate(legs):
    for b in legs[i + 1:]:
      la, lb = a.lower(), b.lower()
      pairs.append((a, b))
      for seg in ('calf1', 'calf2'):
        pairs.append((a, f'{lb}_{seg}'))
        pairs.append((b, f'{la}_{seg}'))
      for s1 in ('calf1', 'calf2'):
        for s2 in ('calf1', 'calf2'):
          pairs.append((f'{la}_{s1}', f'{lb}_{s2}'))
      pairs.append((f'{la}_thigh1', f'{lb}_thigh1'))
  # leg↔trunk: thighs and calves against both trunk capsules
  for a in legs:
    la = a.lower()
    for seg in ('thigh1', 'thigh2', 'thigh3', 'calf1', 'calf2'):
      for trunk in ('trunk1', 'trunk2'):
        pairs.append((f'{la}_{seg}', trunk))
  rows = '\n'.join(
      f'    <pair geom1="{g1}" geom2="{g2}" condim="1"/>' for g1, g2 in pairs
  )
  return f'  <contact>\n{rows}\n  </contact>'


def build_full_scene(self_collision: bool = True) -> str:
  """Full-collision flat-terrain Go2 (menagerie variant), used by the
  getup and handstand/footstand tasks (reference:
  go2_mjx_fullcollisions.xml / go2_mjx.xml + their scene files).

  Deviations from the reference, those of the JAX package's static-shape
  engine: cylinders are approximated by equal-size capsules, and robot
  self-collision is a curated static pair list (``_self_collision_pairs``)
  instead of the reference's dynamic contype/conaffinity broad-phase
  bounded by MJX max_geom_pairs=12.  ``self_collision=False`` leaves the
  floor as the only collider.
  """
  legs = ''.join(_full_leg_xml(n) for n in ('FR', 'FL', 'RR', 'RL'))
  contact_block = _self_collision_pairs() if self_collision else ''
  return f"""
<mujoco model="go2_fullcollisions_flat">
  <option iterations="1" ls_iterations="5" timestep="0.004" integrator="Euler">
    <flag eulerdamp="disable"/>
  </option>
  <compiler angle="radian" autolimits="true"/>

  <default>
    <default class="go2">
      <geom condim="1" contype="0" conaffinity="1"/>
      <joint axis="0 1 0" armature="0.005" damping="0.5"/>
      <position forcerange="-23.7 23.7" inheritrange="1" kp="35"/>
      <default class="abduction">
        <joint axis="1 0 0" range="-0.863 0.863" frictionloss="0.3"/>
      </default>
      <default class="hip">
        <joint range="-0.686 4.501" frictionloss="0.3"/>
      </default>
      <default class="knee">
        <joint range="-2.818 -0.888" frictionloss="1.0"/>
        <position forcerange="-35.55 35.55"/>
      </default>
      <default class="collision">
        <geom group="3" type="capsule"/>
        <default class="hip_left1"><geom size="0.046 0.02" pos="0 0.045 0" quat="1 1 0 0"/></default>
        <default class="hip_right1"><geom size="0.046 0.02" pos="0 -0.045 0" quat="1 1 0 0"/></default>
        <default class="thigh1"><geom size="0.015" fromto="-0.02 0 0 -0.02 0 -0.16"/></default>
        <default class="thigh2"><geom size="0.015" fromto="0 0 0 -0.02 0 -0.1"/></default>
        <default class="thigh3"><geom size="0.015" fromto="-0.02 0 -0.16 0 0 -0.2"/></default>
        <default class="calf1"><geom size="0.01" fromto="0 0 0 0.02 0 -0.13"/></default>
        <default class="calf2"><geom size="0.01" fromto="0.02 0 -0.13 0 0 -0.2"/></default>
        <default class="foot">
          <geom type="sphere" size="0.023" pos="0 0 -0.213" solimp="0.9 .95 0.023" condim="3"/>
        </default>
      </default>
    </default>
  </default>

  <worldbody>
    <body name="trunk" pos="0 0 0.445" childclass="go2">
      <site name="head" pos="0.3 0 0" size="0.02" group="5"/>
      <inertial pos="0.0223 0.002 -0.0005" quat="-0.00342088 0.705204 0.000106698 0.708996" mass="5.204"
        diaginertia="0.0716565 0.0630105 0.0168101"/>
      <freejoint/>
      <geom name="trunk1" class="collision" quat="1 0 1 0" pos="0 -0.04 0" size="0.058 0.125"/>
      <geom name="trunk2" class="collision" quat="1 0 1 0" pos="0 0.04 0" size="0.058 0.125"/>
      <site name="imu" pos="-0.01592 -0.06659 -0.00617" group="5"/>
{legs}
    </body>
    <geom name="floor" size="0 0 0.01" type="plane" contype="1" conaffinity="0" priority="1"
      friction="0.6" condim="3"/>
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
    <framepos objtype="site" objname="head" name="head_pos"/>
  </sensor>
{contact_block}
{_KEYFRAMES}
</mujoco>
"""
