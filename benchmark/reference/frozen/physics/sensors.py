"""Sensor evaluation over a batch of envs.

Counterpart of ``rsr_mjx_tpu/physics/sensors.py``, the subset the Go2 suite
uses: IMU gyro / accelerometer / velocimeter, frame position (with or
without a reference frame), frame quaternion and axes, frame linear and
angular velocity, subtree linear velocity.  Every value is a pure function
of the filled ``Data`` (batch-major, leading env axis B); the sensor list is
static, so the loop over sensors unrolls in python as in the JAX module.
"""

from __future__ import annotations

import torch

from benchmark.reference.frozen.physics import statics
from benchmark.reference.frozen.physics.types import Data, Model, SensorType

# mjtObj values
OBJ_BODY = 1
OBJ_XBODY = 2
OBJ_GEOM = 5
OBJ_SITE = 6


def _frame(m: Model, d: Data, objtype: int, objid: int):
  """(pos (B, 3), mat (B, 3, 3), bodyid) of the referenced frame."""
  if objtype == OBJ_SITE:
    return (d.site_xpos[:, objid], d.site_xmat[:, objid],
            int(m.site_bodyid[objid]))
  if objtype == OBJ_XBODY:
    return d.xpos[:, objid], d.xmat[:, objid], objid
  if objtype == OBJ_BODY:
    return d.xipos[:, objid], d.ximat[:, objid], objid
  if objtype == OBJ_GEOM:
    return (d.geom_xpos[:, objid], d.geom_xmat[:, objid],
            int(m.geom_bodyid[objid]))
  raise NotImplementedError(f'sensor objtype {objtype}')


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.linalg.cross(a, b, dim=-1)


def _to_frame(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """matᵀ v per env: v (B, 3) expressed in the frame mat (B, 3, 3)."""
  return torch.sum(mat * v[:, :, None], dim=1)


def _point_vel(m: Model, d: Data, body: int, point: torch.Tensor):
  """World-frame (angvel, linvel) (B, 3) of a body-fixed point."""
  anchor = d.subtree_com[:, int(m.body_rootid[body])]
  ang = d.cvel[:, body, :3]
  lin = d.cvel[:, body, 3:] + _cross(ang, point - anchor)
  return ang, lin


def mat_to_quat(mat: torch.Tensor) -> torch.Tensor:
  """Rotation matrices (B, 3, 3) → quaternions (w, x, y, z), branch-free:
  of the four constructions, the one with the largest pivot."""
  m00, m01, m02 = mat[:, 0, 0], mat[:, 0, 1], mat[:, 0, 2]
  m10, m11, m12 = mat[:, 1, 0], mat[:, 1, 1], mat[:, 1, 2]
  m20, m21, m22 = mat[:, 2, 0], mat[:, 2, 1], mat[:, 2, 2]
  tr = m00 + m11 + m22
  st = lambda *xs: torch.stack(xs, dim=-1)
  cands = torch.stack([
      st(1.0 + tr, m21 - m12, m02 - m20, m10 - m01),
      st(m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20),
      st(m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21),
      st(m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22),
  ], dim=1)  # (B, 4 variants, 4 components)
  best = torch.argmax(st(tr, m00, m11, m22), dim=-1)  # first on ties
  q = torch.gather(cands, 1, best[:, None, None].expand(-1, 1, 4))[:, 0]
  q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                      min=1e-12)
  w = q[:, :1]
  return q * torch.sign(w + (w == 0).to(q.dtype))


def _motion_cross(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """Spatial motion cross v ×ₘ u over the last axis (6)."""
  vang, vlin = v[..., :3], v[..., 3:]
  uang, ulin = u[..., :3], u[..., 3:]
  return torch.cat(
      [_cross(vang, uang), _cross(vang, ulin) + _cross(vlin, uang)], dim=-1)


def _accelerometer(m: Model, d: Data, body: int, pos, mat):
  """Specific force at a site: linear acceleration of the site point minus
  gravity, in the site frame, from ``d.qacc`` and the velocity-product
  propagation over the body's ancestor dofs."""
  mask = statics.table(m, f'anc_mask.{body}', lambda: m.anc_mask[body],
                       pos.device, pos.dtype)  # (nv,)
  cd_dot = _motion_cross(d.cvel[:, body][:, None, :].expand_as(d.cdof),
                         d.cdof)
  cacc = torch.sum(
      (d.cdof * d.qacc[:, :, None] + cd_dot * d.qvel[:, :, None])
      * mask[None, :, None], dim=1)  # (B, 6)
  anchor = d.subtree_com[:, int(m.body_rootid[body])]
  ang_acc = cacc[:, :3]
  lin_acc = cacc[:, 3:] + _cross(ang_acc, pos - anchor)
  angvel, linvel = _point_vel(m, d, body, pos)
  a_point = lin_acc + _cross(angvel, linvel)  # convective term ω × v
  return _to_frame(mat, a_point - m.opt.gravity)


def _subtree_linvel(m: Model, d: Data, body: int):
  """Mass-weighted mean linear velocity of the subtree rooted at ``body``."""
  subtree = [body]
  for b in range(body + 1, m.nbody):
    if int(m.body_parentid[b]) in subtree:
      subtree.append(b)
  mass = m.lanes('body_mass')[subtree].t()  # (B or 1, k)
  vels = torch.stack(
      [_point_vel(m, d, b, d.xipos[:, b])[1] for b in subtree], dim=1)
  tot = torch.clamp(torch.sum(mass, dim=1, keepdim=True), min=1e-12)
  return torch.sum(vels * mass[:, :, None], dim=1) / tot


def sensordata(m: Model, d: Data) -> Data:
  """``d`` with ``sensordata`` (B, nsensordata) filled from its kinematics,
  velocities and ``qacc``."""
  if m.nsensor == 0:
    return d
  B = d.qpos.shape[0]
  vals = []
  for s in range(m.nsensor):
    stype = int(m.sensor_type[s])
    objid = int(m.sensor_objid[s])
    pos, mat, body = _frame(m, d, int(m.sensor_objtype[s]), objid)
    # optional reference frame (the Go2 foot positions relative to the imu)
    refid = int(m.sensor_refid[s])
    ref = None
    if refid >= 0:
      ref = _frame(m, d, int(m.sensor_reftype[s]), refid)

    if stype == SensorType.FRAMEPOS:
      val = pos if ref is None else _to_frame(ref[1], pos - ref[0])
    elif stype == SensorType.FRAMEQUAT:
      val = mat_to_quat(mat)
    elif stype in (SensorType.FRAMEXAXIS, SensorType.FRAMEYAXIS,
                   SensorType.FRAMEZAXIS):
      axis = mat[:, :, stype - SensorType.FRAMEXAXIS]
      val = axis if ref is None else _to_frame(ref[1], axis)
    elif stype == SensorType.FRAMELINVEL:
      _, val = _point_vel(m, d, body, pos)
      if ref is not None:
        _, ref_lin = _point_vel(m, d, ref[2], ref[0])
        val = _to_frame(ref[1], val - ref_lin)
    elif stype == SensorType.FRAMEANGVEL:
      val, _ = _point_vel(m, d, body, pos)
    elif stype == SensorType.GYRO:
      val = _to_frame(mat, _point_vel(m, d, body, pos)[0])
    elif stype == SensorType.VELOCIMETER:
      val = _to_frame(mat, _point_vel(m, d, body, pos)[1])
    elif stype == SensorType.ACCELEROMETER:
      val = _accelerometer(m, d, body, pos, mat)
    elif stype == SensorType.SUBTREELINVEL:
      val = _subtree_linvel(m, d, objid)
    else:
      raise NotImplementedError(f'sensor type {stype}')
    if int(m.sensor_adr[s]) != sum(v.shape[1] for v in vals):
      raise ValueError('sensor addresses are not contiguous')
    vals.append(val.reshape(B, -1)[:, : int(m.sensor_dim[s])])
  return d.replace(sensordata=torch.cat(vals, dim=1))
