"""Render-only Go2 visual model.

Counterpart of ``rsr_mjx_tpu/envs/go2/visual.py``: the physics scenes stay
primitive (meshes never affect the dynamics), and a second MuJoCo model
with the reference's visual meshes is compiled for rendering only.
``build_visual_scene`` grafts the meshes, a ``go2visual`` default class,
per-body visual geoms and lights onto a physics scene's MJCF.  The 15 OBJ
meshes (22 MB) are read where the JAX package keeps them (``MESH_DIR``),
not copied into this package.

The port's envs load npz snapshots and hold no ``mujoco.MjModel``, so
``render_model`` compiles one from the port's scene builders with the edits
of the JAX env's constructor (``rsr_mjx_tpu/envs/go2/base.py:60-86``):
timestep, joint damping, actuator gains, the reference heightfield, then
the visual graft.  As there, a graft that finds nothing to graft onto
leaves the primitive model: the full-collision scene (getup, handstand,
footstand), whose compiler line and joint attributes differ, renders with
primitives in both packages.  ``mujoco`` is imported where a model is
compiled.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from rsr_mjx_tpu_torch.envs.go2 import scene, snapshot

# the JAX package's copy of the reference meshes
MESH_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    'rsr_mjx_tpu', 'envs', 'go2', 'assets', 'meshes')

_VISUAL_MESHES = [
    'base_0', 'base_1', 'base_2', 'base_3', 'hip_0', 'hip_1',
    'thigh_0', 'thigh_1', 'thigh_mirror_0', 'thigh_mirror_1',
    'calf_0', 'calf_1', 'calf_mirror_0', 'calf_mirror_1', 'foot',
]

# per-leg (hip mesh quat attr, thigh/calf mirrored?) —
# reference go2_mjx_feetonly.xml:85-190
_LEG_VISUAL = {
    'FR': ('quat="4.63268e-05 1 0 0"', True),
    'FL': ('', False),
    'RR': ('quat="2.14617e-09 4.63268e-05 4.63268e-05 -1"', True),
    'RL': ('quat="4.63268e-05 0 1 0"', False),
}

_MATERIALS = (
    '    <material name="dark" rgba="0.2 0.2 0.2 1"/>\n'
    '    <material name="metal" rgba=".9 .95 .95 1"/>\n'
    '    <material name="black" rgba="0 0 0 1"/>\n'
    '    <material name="white" rgba="1 1 1 1"/>\n'
    '    <material name="gray" rgba="0.671705 0.692426 0.774270 1"/>\n'
)

_VISUAL_DEFAULT = (
    '<default class="go2visual">\n'
    '      <geom type="mesh" contype="0" conaffinity="0" group="2" '
    'material="dark"/>\n'
    '    </default>\n    <default class="go2">'
)

_TRUNK_VISUAL = (
    '<site name="imu" pos="-0.02557 0 0.04232" group="5"/>\n'
    # reference tracking camera (go2_mjx_feetonly.xml:67)
    '      <camera name="track" pos="0.846 -1.3 0.316" '
    'xyaxes="0.866 0.500 0.000 -0.171 0.296 0.940" mode="trackcom"/>\n'
    '      <geom mesh="base_0" material="black" class="go2visual"/>\n'
    '      <geom mesh="base_1" material="black" class="go2visual"/>\n'
    '      <geom mesh="base_2" material="black" class="go2visual"/>\n'
    '      <geom mesh="base_3" material="white" class="go2visual"/>'
)

_LIGHTS = (
    '<worldbody>\n'
    '    <light pos="0 0 3.5" dir="0 0 -1" directional="true" '
    'diffuse="0.7 0.7 0.7"/>\n'
    '    <light pos="2 2 2.5" dir="-0.5 -0.5 -1" diffuse="0.4 0.4 0.4"/>'
)


def visual_assets() -> dict:
  """{filename: bytes} for mujoco.MjModel.from_xml_string(xml, assets),
  read from ``MESH_DIR``."""
  out = {}
  for name in _VISUAL_MESHES:
    with open(os.path.join(MESH_DIR, name + '.obj'), 'rb') as f:
      out[name + '.obj'] = f.read()
  return out


def _leg_visual_xml(name: str):
  quat, mirror = _LEG_VISUAL[name]
  sfx = '_mirror' if mirror else ''
  hip = (
      f'<geom mesh="hip_0" material="metal" class="go2visual" {quat}/>'
      f'<geom mesh="hip_1" material="gray" class="go2visual" {quat}/>'
  )
  thigh = (
      f'<geom mesh="thigh{sfx}_0" material="metal" class="go2visual"/>'
      f'<geom mesh="thigh{sfx}_1" material="gray" class="go2visual"/>'
  )
  calf = (
      f'<geom mesh="calf{sfx}_0" material="gray" class="go2visual"/>'
      f'<geom mesh="calf{sfx}_1" material="black" class="go2visual"/>'
      f'<geom pos="0 0 -0.213" mesh="foot" class="go2visual" '
      f'material="black"/>'
  )
  return hip, thigh, calf


def build_visual_scene(base_xml: str) -> str:
  """Graft the reference visual meshes + lights onto a physics scene XML.

  Inserts the mesh asset block, a ``go2visual`` default class, per-body
  visual geoms (trunk + 4 legs) and lights; the result is for the C
  MuJoCo renderer only — the physics model compiles from ``base_xml``.
  """
  meshes = '\n'.join(
      f'    <mesh file="{n}.obj"/>' for n in _VISUAL_MESHES
  )
  asset_block = f'\n  <asset>\n{_MATERIALS}{meshes}\n  </asset>\n'
  s = base_xml
  s = s.replace(
      '<compiler angle="radian"/>',
      '<compiler angle="radian"/>' + asset_block,
      1,
  )
  s = s.replace('<default class="go2">', _VISUAL_DEFAULT, 1)
  s = s.replace(
      '<site name="imu" pos="-0.02557 0 0.04232" group="5"/>',
      _TRUNK_VISUAL,
      1,
  )
  for leg in ('FR', 'FL', 'RR', 'RL'):
    hip, thigh, calf = _leg_visual_xml(leg)
    s = s.replace(
        f'<joint name="{leg}_hip_joint" class="abduction"/>',
        f'<joint name="{leg}_hip_joint" class="abduction"/>{hip}', 1)
    s = s.replace(
        f'<joint name="{leg}_thigh_joint" class="hip"/>',
        f'<joint name="{leg}_thigh_joint" class="hip"/>{thigh}', 1)
    s = s.replace(
        f'<joint name="{leg}_calf_joint" class="knee"/>',
        f'<joint name="{leg}_calf_joint" class="knee"/>{calf}', 1)
  s = s.replace('<worldbody>', _LIGHTS, 1)
  return s


def _compile(xml: str, sim_dt: float, assets: Optional[dict] = None):
  import mujoco

  mjm = mujoco.MjModel.from_xml_string(xml, assets)
  mjm.opt.timestep = sim_dt
  if mjm.nhfield:
    # the reference's compiled heightfield, as the snapshot holds it
    mjm.hfield_data[:] = scene.reference_heightfield()
  return mjm


def visual_model(task: str, sim_dt: float):
  """The mesh model of ``task``'s scene, or None where the graft finds
  nothing (the JAX env's ``_mjm_render``): same qpos layout, at least one
  mesh."""
  xml = snapshot.TASKS[task][1]()
  try:
    vm = _compile(build_visual_scene(xml), sim_dt, visual_assets())
  except ValueError:  # the graft left geoms naming no mesh: primitives
    return None
  nq = _compile(xml, sim_dt).nq
  return vm if vm.nq == nq and vm.nmesh else None


def render_model(task: str, sim_dt: float, kp, kd):
  """The model to render ``task``'s env with: the visual model where the
  graft takes, else the physics scene with the env's timestep, joint
  damping ``kd`` and actuator gains ``kp``."""
  vm = visual_model(task, sim_dt)
  if vm is not None:
    return vm
  mjm = _compile(snapshot.TASKS[task][1](), sim_dt)
  mjm.dof_damping[6:] = kd
  mjm.actuator_gainprm[:, 0] = kp
  mjm.actuator_biasprm[:, 1] = -np.asarray(kp)
  return mjm
