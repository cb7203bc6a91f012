"""Forward kinematics with the batch in the trailing axis.

Counterpart of ``rsr_mjx_tpu/physics/lanes_kinematics.py``: every
quaternion is a (4, B) tensor, every position (3, B), cdof (nv, 6, B).  The
kinematic tree unrolls in python exactly like the JAX code, so the two
compute the same quantities op for op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.frozen.physics import statics
from benchmark.reference.frozen.physics.types import JointType, Model


def _cross(a, b):
  """Cross product over component axis -2 (batch trailing)."""
  ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
  bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
  return torch.stack(
      [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-2
  )


def _qmul(u, v):
  """Hamilton product over component axis -2; (…, 4, B)."""
  w1, x1, y1, z1 = u[..., 0, :], u[..., 1, :], u[..., 2, :], u[..., 3, :]
  w2, x2, y2, z2 = v[..., 0, :], v[..., 1, :], v[..., 2, :], v[..., 3, :]
  return torch.stack([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ], dim=-2)


def _qrot(q, v):
  """Rotate v (…, 3, B) by unit quaternion q (…, 4, B)."""
  qv = q[..., 1:, :]
  w = q[..., 0:1, :]
  t = 2.0 * _cross(qv, v)
  return v + w * t + _cross(qv, t)


def _qnormalize(q):
  return q / torch.sqrt(torch.sum(q * q, dim=-2, keepdim=True))


def _qmat(q):
  """Unit quaternion (…, 4, B) → rotation matrix (…, 3, 3, B)."""
  w, x, y, z = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  m = torch.stack([
      1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
      2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
      2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
  ], dim=-2)
  return m.reshape(m.shape[:-2] + (3, 3) + m.shape[-1:])


def _aaq(axis, angle):
  """axis (…, 3, B), angle (…, B) → quaternion (…, 4, B)."""
  half = angle * 0.5
  s = torch.sin(half)
  return torch.cat([torch.cos(half)[..., None, :], axis * s[..., None, :]],
                   dim=-2)


class KinLeaves(NamedTuple):
  """Inputs of the kinematics stage, each with a trailing batch axis of
  size B (qpos, domain-randomised model leaves) or 1 (shared leaves)."""

  qpos: torch.Tensor
  qpos0: torch.Tensor
  body_pos: torch.Tensor
  body_quat: torch.Tensor
  body_ipos: torch.Tensor
  body_iquat: torch.Tensor
  body_mass: torch.Tensor
  jnt_pos: torch.Tensor
  jnt_axis: torch.Tensor
  geom_pos: torch.Tensor
  geom_quat: torch.Tensor
  site_pos: torch.Tensor
  site_quat: torch.Tensor


def gather_kin(m: Model, qpos_l: torch.Tensor) -> KinLeaves:
  """Lanes qpos (nq, B) plus the model leaves in lanes (``Model.lanes``)."""
  return KinLeaves(qpos_l, *(m.lanes(f) for f in KinLeaves._fields[1:]))


class KinOut(NamedTuple):
  xpos: torch.Tensor        # (nbody, 3, B)
  xquat: torch.Tensor       # (nbody, 4, B)
  xmat: torch.Tensor        # (nbody, 3, 3, B)
  xipos: torch.Tensor       # (nbody, 3, B)
  ximat: torch.Tensor       # (nbody, 3, 3, B)
  geom_xpos: torch.Tensor   # (ngeom, 3, B)
  geom_xmat: torch.Tensor   # (ngeom, 3, 3, B)
  site_xpos: torch.Tensor   # (nsite, 3, B)
  site_xmat: torch.Tensor   # (nsite, 3, 3, B)
  subtree_com: torch.Tensor  # (nbody, 3, B)
  cdof: torch.Tensor        # (nv, 6, B)
  cdof_anchor: torch.Tensor  # (nv, 3, B)


def kinematics_lanes(m: Model, kl: KinLeaves) -> KinOut:
  nb = m.nbody
  qpos = kl.qpos  # (nq, B)
  B = qpos.shape[-1]
  dtype, dev = qpos.dtype, qpos.device
  bc = lambda a, n: a.expand(n, B)

  xpos = [None] * nb
  xquat = [None] * nb
  xpos[0] = torch.zeros((3, 1), dtype=dtype, device=dev)
  xquat[0] = statics.table(m, 'quat_identity', lambda: np.eye(4)[:, :1],
                           dev, dtype)
  jnt_xanchor = [None] * m.njnt
  jnt_xaxis = [None] * m.njnt

  for b in range(1, nb):
    p = int(m.body_parentid[b])
    pos = xpos[p] + _qrot(xquat[p], kl.body_pos[b])
    quat = _qmul(xquat[p], kl.body_quat[b])
    jadr, jnum = int(m.body_jntadr[b]), int(m.body_jntnum[b])
    for ji in range(jadr, jadr + jnum):
      jtype = int(m.jnt_type[ji])
      qadr = int(m.jnt_qposadr[ji])
      if jtype == JointType.FREE:
        pos = qpos[qadr : qadr + 3]
        quat = _qnormalize(qpos[qadr + 3 : qadr + 7])
        jnt_xanchor[ji] = pos
        jnt_xaxis[ji] = _qrot(quat, kl.jnt_axis[ji])
      else:
        anchor = pos + _qrot(quat, kl.jnt_pos[ji])
        axis = _qrot(quat, kl.jnt_axis[ji])
        jnt_xanchor[ji] = anchor
        jnt_xaxis[ji] = axis
        if jtype == JointType.SLIDE:
          pos = pos + axis * (qpos[qadr] - kl.qpos0[qadr])[..., None, :]
        elif jtype == JointType.HINGE:
          angle = qpos[qadr] - kl.qpos0[qadr]  # (B,)
          quat = _qmul(quat, _aaq(kl.jnt_axis[ji], angle))
          pos = anchor - _qrot(quat, kl.jnt_pos[ji])
          jnt_xaxis[ji] = _qrot(quat, kl.jnt_axis[ji])
        elif jtype == JointType.BALL:
          quat = _qmul(quat, _qnormalize(qpos[qadr : qadr + 4]))
          pos = anchor - _qrot(quat, kl.jnt_pos[ji])
        else:
          raise NotImplementedError(f'joint type {jtype}')
    xpos[b] = pos
    xquat[b] = quat

  xpos_s = torch.stack([bc(x, 3) for x in xpos])  # (nbody, 3, B)
  xquat_s = torch.stack([bc(q, 4) for q in xquat])  # (nbody, 4, B)
  xmat = _qmat(xquat_s)
  xipos = xpos_s + _qrot(xquat_s, kl.body_ipos)
  ximat = _qmat(_qmul(xquat_s, kl.body_iquat))

  gb = statics.table(m, 'geom_bodyid', lambda: m.geom_bodyid, dev, torch.long)
  geom_xpos = xpos_s[gb] + _qrot(xquat_s[gb], kl.geom_pos)
  geom_xmat = _qmat(_qmul(xquat_s[gb], kl.geom_quat))
  sb = statics.table(m, 'site_bodyid', lambda: m.site_bodyid, dev, torch.long)
  site_xpos = xpos_s[sb] + _qrot(xquat_s[sb], kl.site_pos)
  site_xmat = _qmat(_qmul(xquat_s[sb], kl.site_quat))

  # subtree CoM (mass-weighted, accumulated leaf -> root)
  mass_x = kl.body_mass[:, None, :] * xipos  # (nbody, 3, B)
  sub_mass = [kl.body_mass[b] for b in range(nb)]
  sub_mx = [mass_x[b] for b in range(nb)]
  for b in range(nb - 1, 0, -1):
    p = int(m.body_parentid[b])
    sub_mass[p] = sub_mass[p] + sub_mass[b]
    sub_mx[p] = sub_mx[p] + sub_mx[b]
  sub_mass = torch.stack([s.expand(B) for s in sub_mass])
  sub_mx = torch.stack([bc(x, 3) for x in sub_mx])
  subtree_com = sub_mx / torch.clamp(sub_mass, min=1e-12)[:, None, :]

  # cdof: dof motion axes anchored at the root subtree CoM
  cdof = [None] * m.nv
  cdof_anchor = [None] * m.nv
  z3B = torch.zeros((3, B), dtype=dtype, device=dev)
  for ji in range(m.njnt):
    jtype = int(m.jnt_type[ji])
    b = int(m.jnt_bodyid[ji])
    vadr = int(m.jnt_dofadr[ji])
    anchor = subtree_com[int(m.body_rootid[b])]  # (3, B)
    if jtype == JointType.FREE:
      eye3 = statics.table(m, 'eye3', lambda: np.eye(3), dev, dtype)
      for k in range(3):
        cdof[vadr + k] = torch.cat(
            [z3B, eye3[:, k : k + 1].expand(3, B)], dim=0
        )
        cdof_anchor[vadr + k] = anchor
      for k in range(3):
        w = xmat[b][:, k, :]  # (3, B)
        cdof[vadr + 3 + k] = torch.cat([w, _cross(w, anchor - xpos_s[b])],
                                       dim=0)
        cdof_anchor[vadr + 3 + k] = anchor
    elif jtype == JointType.HINGE:
      a = bc(jnt_xaxis[ji], 3)
      cdof[vadr] = torch.cat([a, _cross(a, anchor - jnt_xanchor[ji])], dim=0)
      cdof_anchor[vadr] = anchor
    elif jtype == JointType.SLIDE:
      cdof[vadr] = torch.cat([z3B, bc(jnt_xaxis[ji], 3)], dim=0)
      cdof_anchor[vadr] = anchor
    elif jtype == JointType.BALL:
      for k in range(3):
        w = xmat[b][:, k, :]
        cdof[vadr + k] = torch.cat(
            [w, _cross(w, anchor - jnt_xanchor[ji])], dim=0
        )
        cdof_anchor[vadr + k] = anchor
  return KinOut(
      xpos=xpos_s, xquat=xquat_s, xmat=xmat, xipos=xipos, ximat=ximat,
      geom_xpos=geom_xpos, geom_xmat=geom_xmat,
      site_xpos=site_xpos, site_xmat=site_xmat, subtree_com=subtree_com,
      cdof=torch.stack(cdof),
      cdof_anchor=torch.stack([bc(a, 3) for a in cdof_anchor]),
  )
