"""Airbot Play scene builders (MJCF text): cube-push and T-push.

Counterpart of ``rsr_mjx_tpu/envs/airbot/scene.py``, kept as its own copy:
the port imports nothing of the JAX package.  The port uses it only to
regenerate the committed model snapshots (``envs/airbot/snapshot.py``),
because the machine that runs the port on the card has no ``mujoco`` to
compile MJCF.

The arm, table, cube and target marker reproduce the reference scenes
(test/sf.xml, ppo_train/airbot_training/cube.xml); the builder takes the
table and cube frictions the two cube-push variants differ in.  The T-push
scene (T_shape.xml) shares the arm and the table.

Collision groups:
  arm geoms        contype=0 conaffinity=1
  cube             contype=1 conaffinity=0
  table top        contype=3 conaffinity=3
  target marker    contype=0 conaffinity=2   (rests on the table)
"""

from __future__ import annotations

_ARM_DEFAULTS = """
    <default class="arm-j1"><joint axis="0 0 1" range="-3.14 2.09" actuatorfrcrange="-24 24" damping="0.2" frictionloss="15"/></default>
    <default class="arm-j2"><joint axis="0 0 1" range="-2.96 0.17" actuatorfrcrange="-24 24" damping="0.2" frictionloss="15"/></default>
    <default class="arm-j3"><joint axis="0 0 1" range="-0.087 3.14" actuatorfrcrange="-24 24" damping="0.2" frictionloss="15"/></default>
    <default class="arm-j4"><joint axis="0 0 1" range="1.569 1.571" damping="0.1" frictionloss="5"/></default>
    <default class="arm-j5"><joint axis="0 0 1" range="-1.74 1.74" actuatorfrcrange="-8 8" damping="0.1" frictionloss="5"/></default>
    <default class="arm-j6"><joint axis="0 0 1" range="-3.14 3.14" actuatorfrcrange="-8 8" damping="0.1" frictionloss="5"/></default>
    <default class="finger-l"><joint type="slide" axis="0 1 0" range="-0.0331 -0.0329" damping="0.5" frictionloss="15"/></default>
    <default class="finger-r"><joint type="slide" axis="0 1 0" range="0.0329 0.0331" damping="0.5" frictionloss="15"/></default>
"""

# soft-contact parameters shared by fingers / table / cube
_SOFT = 'condim="4" solimp="0.8 1 0.01" solref="0.01 1"'


def _arm_xml() -> str:
  """The Airbot Play arm subtree (shared by cube-push and T-shape)."""
  finger_geoms_r = f"""
            <geom {_SOFT} friction="1 0.005 0.0001" type="box" pos="0.012 0.002 0.002" size="0.012 0.002 0.01" contype="0" conaffinity="1"/>
            <geom {_SOFT} friction="1 0.005 0.0001" type="box" pos="-0.012 0.002 0.005" size="0.012 0.002 0.02" contype="0" conaffinity="1"/>
            <geom name="right_finger" {_SOFT} friction="1 0.005 0.0001" type="box" pos="-0.036 0.002 0.00" size="0.012 0.002 0.03" contype="0" conaffinity="1"/>
"""
  finger_geoms_l = f"""
            <geom {_SOFT} friction="1 0.005 0.0001" type="box" pos="0.012 -0.002 0.002" size="0.012 0.002 0.01" contype="0" conaffinity="1"/>
            <geom {_SOFT} friction="1 0.005 0.0001" type="box" pos="-0.012 -0.002 0.005" size="0.012 0.002 0.02" contype="0" conaffinity="1"/>
            <geom name="left_finger" {_SOFT} friction="1 0.005 0.0001" type="box" pos="-0.036 -0.002 0.00" size="0.012 0.002 0.03" contype="0" conaffinity="1"/>
"""

  return f"""
    <body name="arm_pose" pos="0 0 0.78">
      <body name="arm_base">
        <geom type="box" pos="-0.02 0 0.005" size="0.0806 0.1375 0.0025" euler="0 0 1.5708" contype="0" conaffinity="1"/>
        <geom type="box" pos="-0.015 0 0.045" size="0.07 0.05 0.04" contype="0" conaffinity="1"/>
        <body name="link1" pos="0 0 0.1172">
          <inertial pos="7.9126e-05 -0.002527 -0.0041359" quat="0.696716 0.716558 0.0238919 -0.0236876" mass="0.54639" diaginertia="0.000346294 0.000325437 0.000286269"/>
          <joint name="joint1" class="arm-j1"/>
          <body name="link2" quat="0.135866 0.135867 -0.69393 0.693932">
            <inertial pos="0.22493 0.0047721 0.008023" quat="-0.210875 0.632473 -0.273056 0.693506" mass="0.64621" diaginertia="0.00516535 0.00505042 0.000418626"/>
            <joint name="joint2" class="arm-j2"/>
            <geom type="box" pos="0.08 0.015 0" euler="0 0 0.15" size="0.11 0.03 0.04" contype="0" conaffinity="1"/>
            <geom type="box" pos="0.235 0.015 0" euler="0 0 -0.3" size="0.065 0.025 0.045" contype="0" conaffinity="1"/>
            <body name="link3" pos="0.27009 0 0" quat="0.192144 0 0 -0.981367">
              <inertial pos="0.16813 -5.5576e-05 0.0031184" quat="0.511278 0.488423 0.489191 0.510617" mass="0.26829" diaginertia="0.0031527 0.0030951 0.000239403"/>
              <joint name="joint3" class="arm-j3"/>
              <geom type="box" pos="0.13 0 0" size="0.13 0.025 0.025" contype="0" conaffinity="1"/>
              <body name="link4" pos="0.29015 0 0" quat="-2.59734e-06 0.707105 2.59735e-06 0.707108">
                <inertial pos="5.2436e-06 0.00040412 -0.03228" quat="0.999969 -0.000174762 -0.00792041 -6.98144e-05" mass="0.34876" diaginertia="0.000423574 0.000412 0.000126826"/>
                <joint name="joint4" class="arm-j4"/>
                <geom type="box" size="0.03 0.03 0.03" contype="0" conaffinity="1"/>
                <body name="link5" quat="0.707105 0.707108 0 0">
                  <inertial pos="8.3328e-06 0.026148 0.002525" quat="0.531568 0.4663 0.4663 0.531568" mass="0.36132" diaginertia="0.0004677 0.000432922 0.000178178"/>
                  <joint name="joint5" class="arm-j5"/>
                  <geom type="box" pos="0 0.06 0" size="0.03 0.03 0.03" contype="0" conaffinity="1"/>
                  <body name="link6" pos="0 0.23645 0" quat="0.499998 -0.5 0.5 0.500002">
                    <inertial pos="-0.0047053 7.3857e-05 -0.12293" mass="0.53855" diaginertia="5e-05 5e-05 3.85e-05"/>
                    <joint name="joint6" class="arm-j6"/>
                    <geom type="box" pos="0 0 -0.11" size="0.03 0.03 0.03" contype="0" conaffinity="1"/>
                    <geom name="fixed_gripper" type="box" pos="0 0 -0.07" size="0.025 0.08 0.015" contype="0" conaffinity="1"/>
                    <site name="endpoint" pos="0 0 0.025" euler="0 -1.5708 0" size="0.001" type="sphere"/>
                    <body name="right" quat="9.38184e-07 0.707105 -9.38187e-07 0.707108">
                      <inertial pos="-0.048742 0.0096369 0.00044322" quat="0.757393 0.0415116 0.0313705 0.650883" mass="0.0626" diaginertia="2.79281e-05 1.90181e-05 1.21737e-05"/>
                      <joint name="endright" class="finger-r"/>
{finger_geoms_r}
                    </body>
                    <body name="left" quat="9.38184e-07 0.707105 -9.38187e-07 0.707108">
                      <inertial pos="-0.049039 -0.0096764 0.00038868" quat="0.650491 0.0296695 0.0398251 0.757889" mass="0.061803" diaginertia="2.74809e-05 1.88104e-05 1.19127e-05"/>
                      <joint name="endleft" class="finger-l"/>
{finger_geoms_l}
                    </body>
                  </body>
                </body>
              </body>
            </body>
          </body>
        </body>
      </body>
    </body>
"""


def _table_xml(table_friction) -> str:
  return f"""
    <body name="table-a" pos="0.2 0 0">
      <geom name="table-b" size="0.8 0.3 0.01" pos="0 0 0.77" type="box" rgba="0.45 0.33 0.22 1"
            {_SOFT} friction="{table_friction}" contype="3" conaffinity="3"/>
      <geom size="0.02 0.02 0.385" pos=" 0.56 -0.28 0.385" type="box" contype="0" conaffinity="0"/>
      <geom size="0.02 0.02 0.385" pos=" 0.56  0.28 0.385" type="box" contype="0" conaffinity="0"/>
      <geom size="0.02 0.02 0.385" pos="-0.56 -0.28 0.385" type="box" contype="0" conaffinity="0"/>
      <geom size="0.02 0.02 0.385" pos="-0.56  0.28 0.385" type="box" contype="0" conaffinity="0"/>
    </body>
"""


_EQUALITY_AND_ACTUATORS = """
  <equality>
    <joint joint1="endleft" joint2="endright" polycoef="0 -1 0 0 0"/>
  </equality>

  <actuator>
    <position name="joint1" ctrllimited="true" ctrlrange="-3.14 2.09"  joint="joint1" kp="1000" forcelimited="true" forcerange="-300 300"/>
    <position name="joint2" ctrllimited="true" ctrlrange="-2.96 0.17"  joint="joint2" kp="1000" forcelimited="true" forcerange="-300 300"/>
    <position name="joint3" ctrllimited="true" ctrlrange="-0.087 3.14" joint="joint3" kp="1000" forcelimited="true" forcerange="-300 300"/>
    <position name="joint5" ctrllimited="true" ctrlrange="-1.74 1.74"  joint="joint5" kp="350" forcelimited="true" forcerange="-300 300"/>
    <position name="joint6" ctrllimited="true" ctrlrange="-3.14 3.14"  joint="joint6" kp="100" forcelimited="true" forcerange="-300 300"/>
  </actuator>
"""

# The reference ground plane carries contype/conaffinity 3, which makes
# every arm link and the cube potential ground colliders (sf.xml:17).  The
# table blocks the arm from ever reaching the ground and the cube episode
# terminates (z < 0.6) before ground impact, so those ~64 contact slots are
# permanently inactive; with a static contact table they would only burn
# solver rows.  The plane is kept for visuals/raycasts but excluded from
# collision.
_GROUND = """
    <light pos="0.3 0 2.2" dir="0 0 -1" directional="true" diffuse="0.7 0.7 0.7"/>
    <light pos="1.5 1.0 1.5" dir="-0.5 -0.4 -1" diffuse="0.4 0.4 0.4"/>
    <geom name="ground" type="plane" pos="0 0 0" size="3 3 0.1" rgba="0.55 0.57 0.6 1"
          solimp=".9 .95 .001" solref="-10000 -1000" contype="0" conaffinity="0"/>
"""

# rendering-only: headlight + camera defaults so --render output is lit
# (the reference scenes inherit MuJoCo's bundled visual assets; these
# fields never enter the physics Model)
_VISUAL = """
  <visual>
    <headlight ambient="0.4 0.4 0.4" diffuse="0.7 0.7 0.7" specular="0.1 0.1 0.1"/>
    <global azimuth="130" elevation="-25"/>
  </visual>
"""


def build_cube_scene(
    table_friction: float = 0.4,
    cube_friction: float = 1.22,
    cube_start: tuple = (0.32, 0.0, 0.82),
    target_start: tuple = (0.4664427, 0.10352592, 0.81999997),
) -> str:
  """MJCF for the cube-push task.

  Defaults reproduce test/sf.xml (the RSR-registered variant);
  ``build_cube_scene(table_friction=1.0, cube_friction=1.0)`` reproduces
  the ppo_train training variant (cube.xml).
  """
  return f"""
<mujoco model="airbot_cube_push">
{_VISUAL}
  <option timestep="0.0025" iterations="20" integrator="implicitfast" gravity="0 0 -9.81"/>
  <compiler angle="radian" inertiafromgeom="auto" inertiagrouprange="22 22"/>

  <default>
    <geom contype="0" conaffinity="0" condim="4"/>
{_ARM_DEFAULTS}
  </default>

  <worldbody>
{_GROUND}
{_arm_xml()}
{_table_xml(f'{table_friction} 0.005 0.0001')}
    <body name="target_pos" pos="{target_start[0]} {target_start[1]} {target_start[2]}">
      <geom name="target" type="box" size="0.04 0.04 0.04" rgba="0.2 0.8 0.3 0.45" contype="0" conaffinity="2" mass="0"/>
      <inertial pos="0 0 0" mass="0.5" diaginertia="0.0005333 0.0005333 0.0005333"/>
      <freejoint/>
    </body>

    <body name="cube_for_push" pos="{cube_start[0]} {cube_start[1]} {cube_start[2]}">
      <freejoint/>
      <inertial pos="0 0 0" mass="0.5" diaginertia="0.0005333 0.0005333 0.0005333"/>
      <geom name="geom_for_push" type="box" size="0.04 0.04 0.04" {_SOFT} rgba="0.85 0.2 0.15 1"
            friction="{cube_friction} 0.1 0.1" contype="1" conaffinity="0"/>
    </body>
  </worldbody>
{_EQUALITY_AND_ACTUATORS}
</mujoco>
"""


def build_tshape_scene() -> str:
  """MJCF for the T-shape push task (reference: T_shape.xml).

  Differences from the cube scene: finer timestep (0.00025, iterations 8),
  ``inertiafromgeom="true"`` (all inertials recomputed from geoms by the
  compiler), near-zero finger travel, (1, 0.1, 0.0001) table friction, a
  static two-box T target and a free two-box T block with tail sites.
  """
  # finger classes with locked travel (T_shape.xml:76-80)
  defaults = _ARM_DEFAULTS.replace(
      'range="-0.0331 -0.0329"', 'range="-0.001 0.001"'
  ).replace('range="0.0329 0.0331"', 'range="-0.001 0.001"')
  return f"""
<mujoco model="airbot_t_push">
{_VISUAL}
  <option timestep="0.00025" iterations="8" integrator="implicitfast" gravity="0 0 -9.81"/>
  <compiler angle="radian" inertiafromgeom="true"/>

  <default>
    <geom contype="0" conaffinity="0" condim="4"/>
{defaults}
  </default>

  <worldbody>
{_GROUND}
{_arm_xml()}
{_table_xml('1 0.1 0.0001')}
    <body name="T_target" pos="0.29 0.12 0.805" euler="0 0 0.785398163">
      <inertial pos="0 -0.03 0" mass="0.5" diaginertia="0.001 0.001 0.001"/>
      <geom name="base_target" type="box" size="0.075 0.025 0.025" contype="0" conaffinity="0"/>
      <geom name="vertical_target" type="box" pos="0 -0.075 0" size="0.025 0.05 0.025" contype="0" conaffinity="0"/>
      <site name="T_target_tail" pos="0.0 -0.1 0.0" size="0.001" type="sphere"/>
    </body>

    <body name="T_block" pos="0.27 0.1 0.805">
      <freejoint/>
      <inertial pos="0 -0.03 0" mass="0.5" diaginertia="0.0000260417 0.0000708333 0.0000708333"/>
      <geom name="base_block" type="box" {_SOFT} size="0.075 0.025 0.025"
            friction="1 0.1 0.0001" contype="1" conaffinity="0"/>
      <geom name="vertical_block" type="box" {_SOFT} pos="0 -0.075 0" size="0.025 0.05 0.025"
            friction="1 0.1 0.0001" contype="1" conaffinity="0"/>
      <site name="T_tail" pos="0.0 -0.1 0.0" size="0.001" type="sphere"/>
    </body>
  </worldbody>
{_EQUALITY_AND_ACTUATORS}
</mujoco>
"""
