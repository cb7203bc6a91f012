"""Smooth dynamics with the batch in the trailing axis.

Counterpart of ``rsr_mjx_tpu/physics/lanes_smooth.py``: com_vel → CRB mass
matrix → RNE bias → passive → actuation → fwd_velocity, plus the
xfrc_applied projection, every per-body 3-vector a (3, B) tensor and the
mass matrix (nv, nv, B).  It ends in kernel K1 (``spd_solve_lanes``) for
qacc_smooth = M⁻¹ qfrc_smooth.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.frozen.physics import linalg_kernels as _lk
from benchmark.reference.frozen.physics import statics
from benchmark.reference.frozen.physics.types import (
    BiasType, GainType, JointType, Model, TrnType,
)


def _cross(a, b):
  """Cross product over component axis -2 (batch trailing)."""
  ax, ay, az = a[..., 0, :], a[..., 1, :], a[..., 2, :]
  bx, by, bz = b[..., 0, :], b[..., 1, :], b[..., 2, :]
  return torch.stack(
      [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-2
  )


def _mc(v, u):
  """Spatial motion cross v ×ₘ u; (…, 6, B)."""
  vang, vlin = v[..., :3, :], v[..., 3:, :]
  uang, ulin = u[..., :3, :], u[..., 3:, :]
  return torch.cat(
      [_cross(vang, uang), _cross(vang, ulin) + _cross(vlin, uang)], dim=-2
  )


def _mcf(v, f):
  """Spatial motion-force cross v ×f* f; (…, 6, B)."""
  vang, vlin = v[..., :3, :], v[..., 3:, :]
  ftrq, ffrc = f[..., :3, :], f[..., 3:, :]
  return torch.cat(
      [_cross(vang, ftrq) + _cross(vlin, ffrc), _cross(vang, ffrc)], dim=-2
  )


def _imul(I, h, mass, mv):
  """Spatial inertia × motion vector; I (3,3,B), h (3,B), mv (6,B)."""
  w, v = mv[:3], mv[3:]
  trq = sum(I[:, j] * w[j][None] for j in range(3)) + _cross(h, v)
  frc = mass[None] * v - _cross(h, w)
  return torch.cat([trq, frc], dim=0)


class SmoothLeaves(NamedTuple):
  """Inputs of the smooth stages (kinematics outputs plus model leaves);
  each carries a trailing batch axis of size B or 1."""

  qpos: torch.Tensor
  qvel: torch.Tensor
  ctrl: torch.Tensor
  qfrc_applied: torch.Tensor
  xfrc_applied: torch.Tensor
  cdof: torch.Tensor
  cdof_anchor: torch.Tensor
  ximat: torch.Tensor
  xipos: torch.Tensor
  subtree_com: torch.Tensor
  body_mass: torch.Tensor
  body_inertia: torch.Tensor
  dof_armature: torch.Tensor
  dof_damping: torch.Tensor
  jnt_stiffness: torch.Tensor
  qpos0: torch.Tensor
  gravity: torch.Tensor
  gainprm: torch.Tensor
  biasprm: torch.Tensor
  gear: torch.Tensor
  ctrlrange: torch.Tensor
  forcerange: torch.Tensor


def gather_smooth(m: Model, qpos, qvel, ctrl, qfrc_applied, xfrc_applied,
                  kout=None) -> SmoothLeaves:
  """Lanes state (…, B) and kinematics outputs plus the model leaves in
  lanes (``Model.lanes``: per env under domain randomisation, else with a
  trailing axis of 1); with no ``kout`` the five kinematics fields are
  None, to be filled in later (the fused region's inputs)."""
  kin = ((kout.cdof, kout.cdof_anchor, kout.ximat, kout.xipos,
          kout.subtree_com) if kout is not None else (None,) * 5)
  return SmoothLeaves(
      qpos, qvel, ctrl, qfrc_applied, xfrc_applied, *kin,
      m.lanes('body_mass'), m.lanes('body_inertia'), m.lanes('dof_armature'),
      m.lanes('dof_damping'), m.lanes('jnt_stiffness'), m.lanes('qpos0'),
      m.opt.gravity[..., None], m.lanes('actuator_gainprm'),
      m.lanes('actuator_biasprm'), m.lanes('actuator_gear'),
      m.lanes('actuator_ctrlrange'), m.lanes('actuator_forcerange'),
  )


def lanes_supported(m: Model) -> bool:
  """Actuation here covers joint transmissions on hinge/slide dofs only."""
  for u in range(m.nu):
    if int(m.actuator_trntype[u]) not in (TrnType.JOINT, TrnType.JOINTINPARENT):
      return False
    ji = int(m.actuator_trnid[u][0])
    if int(m.jnt_type[ji]) not in (JointType.HINGE, JointType.SLIDE):
      return False
  return True


def actuated_dofs(m: Model) -> np.ndarray:
  """Static dof address of each actuator's joint."""
  return np.array(
      [int(m.jnt_dofadr[int(m.actuator_trnid[u][0])]) for u in range(m.nu)],
      dtype=np.int64,
  )


def onehot_vu(m: Model) -> np.ndarray:
  """Static (nv, nu) map of each actuator onto its joint's dof."""
  out = np.zeros((m.nv, m.nu), np.float32)
  out[actuated_dofs(m), np.arange(m.nu)] = 1.0
  return out


def smooth_lanes(m: Model, sl: SmoothLeaves):
  """Returns lanes outputs (qM (nv, nv, B), cvel (nbody, 6, B),
  qfrc_bias (nv, B), qfrc_passive (nv, B), actuator_force (nu, B),
  qfrc_actuator (nv, B), qfrc_smooth (nv, B), qacc_smooth (nv, B))."""
  if not lanes_supported(m):
    raise NotImplementedError('actuator transmission not ported yet')
  nv, nbody, nu = m.nv, m.nbody, m.nu
  qpos, qvel, cdof = sl.qpos, sl.qvel, sl.cdof
  B = qvel.shape[-1]
  dtype, dev = qvel.dtype, qvel.device
  # static tables on the device, in the batch's dtype
  const = lambda name, build, dt=dtype: statics.table(m, name, build, dev, dt)
  eye3 = const('eye3', lambda: np.eye(3))[:, :, None]

  # spatial body inertias about the root subtree CoM
  rootid = const('body_rootid', lambda: m.body_rootid, torch.long)
  anchors = sl.subtree_com[rootid]  # (nbody, 3, B)
  ximat, diag = sl.ximat, sl.body_inertia
  I_c = sum(
      ximat[:, :, k, None, :] * ximat[:, None, :, k, :]
      * diag[:, k, None, None, :]
      for k in range(3)
  )  # (nbody, 3, 3, B)
  dvec = sl.xipos - anchors
  d2 = torch.sum(dvec * dvec, dim=1)  # (nbody, B)
  mass4 = sl.body_mass[:, None, None, :]
  I_a = I_c + mass4 * (
      d2[:, None, None, :] * eye3[None]
      - dvec[:, :, None, :] * dvec[:, None, :, :]
  )
  h_a = sl.body_mass[:, None, :] * dvec  # (nbody, 3, B)

  # CRB: composite inertias leaf -> root
  parent = m.body_parentid
  Ic = [I_a[b] for b in range(nbody)]
  hc = [h_a[b] for b in range(nbody)]
  mc = [sl.body_mass[b] for b in range(nbody)]
  for b in range(nbody - 1, 0, -1):
    p = int(parent[b])
    if p == 0:
      continue
    Ic[p] = Ic[p] + Ic[b]
    hc[p] = hc[p] + hc[b]
    mc[p] = mc[p] + mc[b]

  dof_body = m.dof_bodyid
  F = torch.stack([
      _imul(Ic[int(dof_body[v])], hc[int(dof_body[v])], mc[int(dof_body[v])],
            cdof[v])
      for v in range(nv)
  ])  # (nv, 6, B)
  M_full = sum(F[:, k, None, :] * cdof[None, :, k, :] for k in range(6))
  mask = const('dof_anc', lambda: m.dof_anc)[:, :, None]
  tril = const('tril_nv', lambda: np.tril(np.ones((nv, nv))))[:, :, None]
  eyev = const('eye_nv', lambda: np.eye(nv))[:, :, None]
  L = M_full * mask * tril
  qM = L + L.transpose(0, 1) - L * eyev
  qM = qM + eyev * sl.dof_armature[:, None, :]
  qM = qM.expand(nv, nv, B)

  # com_vel
  weighted = cdof * qvel[:, None, :]  # (nv, 6, B)
  cvel = torch.tensordot(const('anc_mask', lambda: m.anc_mask), weighted,
                         dims=1)  # (nbody, 6, B)

  # RNE velocity-product + gravity accelerations (root -> leaf)
  grav6 = torch.cat([torch.zeros_like(sl.gravity), -sl.gravity], dim=0)
  cacc = [None] * nbody
  cacc[0] = grav6
  vrec = [None] * nbody
  vrec[0] = torch.zeros((6, 1), dtype=dtype, device=dev)
  for b in range(1, nbody):
    p = int(parent[b])
    acc = cacc[p]
    v = vrec[p]
    jadr, jnum = int(m.body_jntadr[b]), int(m.body_jntnum[b])
    for ji in range(jadr, jadr + jnum):
      jt = int(m.jnt_type[ji])
      vadr = int(m.jnt_dofadr[ji])
      if jt == JointType.FREE:
        t = sum(cdof[vadr + k] * qvel[vadr + k][None] for k in range(3))
        v = v + t
        r = sum(cdof[vadr + 3 + k] * qvel[vadr + 3 + k][None]
                for k in range(3))
        acc = acc + _mc(v, r)
        v = v + r
      elif jt == JointType.BALL:
        r = sum(cdof[vadr + k] * qvel[vadr + k][None] for k in range(3))
        acc = acc + _mc(v, r)
        v = v + r
      else:
        s = cdof[vadr] * qvel[vadr][None]
        acc = acc + _mc(v, s)
        v = v + s
    cacc[b] = acc
    vrec[b] = v

  # body forces f = I·a + v ×f* (I·v) at the com_vel velocities
  cfrc = []
  for b in range(nbody):
    cv = cvel[b]
    Iv = _imul(I_a[b], h_a[b], sl.body_mass[b], cv)
    f = _imul(I_a[b], h_a[b], sl.body_mass[b], cacc[b].expand(6, B)) + _mcf(
        cv, Iv
    )
    cfrc.append(f)
  for b in range(nbody - 1, 0, -1):
    p = int(parent[b])
    if p != 0:
      cfrc[p] = cfrc[p] + cfrc[b]
  qfrc_bias = torch.stack([
      torch.sum(cdof[v] * cfrc[int(dof_body[v])], dim=0) for v in range(nv)
  ])  # (nv, B)

  # passive: damping + joint springs
  qfrc_passive = -sl.dof_damping * qvel
  spring = torch.zeros((nv, B), dtype=dtype, device=dev)
  for ji in range(m.njnt):
    if int(m.jnt_type[ji]) in (JointType.HINGE, JointType.SLIDE):
      qadr, vadr = int(m.jnt_qposadr[ji]), int(m.jnt_dofadr[ji])
      spring[vadr] = spring[vadr] + (
          -sl.jnt_stiffness[ji] * (qpos[qadr] - sl.qpos0[qadr])
      )
  qfrc_passive = qfrc_passive.expand(nv, B) + spring

  # actuation (hinge/slide joint transmissions)
  if nu:
    qadr_u = const('actuator_qadr', lambda: np.array(
        [int(m.jnt_qposadr[int(m.actuator_trnid[u][0])]) for u in range(nu)]
    ), torch.long)
    vadr_u = const('actuator_vadr', lambda: actuated_dofs(m), torch.long)
    gear0 = sl.gear[:, 0]  # (nu, 1)
    length = gear0 * qpos[qadr_u]
    velocity = gear0 * qvel[vadr_u]
    limited = const('ctrllimited',
                    lambda: m.actuator_ctrllimited.astype(bool),
                    torch.bool)[:, None]
    ctrl = torch.where(
        limited,
        torch.minimum(torch.maximum(sl.ctrl, sl.ctrlrange[:, 0]),
                      sl.ctrlrange[:, 1]),
        sl.ctrl,
    )
    aff_g = const('gain_affine',
                  lambda: np.asarray(m.actuator_gaintype) == GainType.AFFINE,
                  torch.bool)[:, None]
    gain = torch.where(
        aff_g,
        sl.gainprm[:, 0] + sl.gainprm[:, 1] * length
        + sl.gainprm[:, 2] * velocity,
        sl.gainprm[:, 0].expand(nu, B),
    )
    aff_b = const('bias_affine',
                  lambda: np.asarray(m.actuator_biastype) == BiasType.AFFINE,
                  torch.bool)[:, None]
    bias = torch.where(
        aff_b,
        sl.biasprm[:, 0] + sl.biasprm[:, 1] * length
        + sl.biasprm[:, 2] * velocity,
        torch.zeros((), dtype=dtype, device=dev),
    )
    force = gain * ctrl + bias
    flimited = const('forcelimited',
                     lambda: m.actuator_forcelimited.astype(bool),
                     torch.bool)[:, None]
    force = torch.where(
        flimited,
        torch.minimum(torch.maximum(force, sl.forcerange[:, 0]),
                      sl.forcerange[:, 1]),
        force,
    )
    force = force.expand(nu, B)
    qfrc_actuator = torch.tensordot(const('onehot_vu', lambda: onehot_vu(m)),
                                    gear0 * force, dims=1)
    lim_j = np.nonzero(m.jnt_actfrclimited)[0]
    if len(lim_j):
      # out of place: the clamp's backward reads the rows it clamps
      lim_v = const('actfrc_dofs', lambda: m.jnt_dofadr[lim_j], torch.long)
      rng = const('actfrc_range', lambda: np.asarray(
          m.jnt_actfrcrange[lim_j], np.float32))  # (L, 2)
      qfrc_actuator = qfrc_actuator.index_put(
          (lim_v,), torch.clamp(qfrc_actuator[lim_v], rng[:, :1],
                                rng[:, 1:]))
    actuator_force = force
  else:
    actuator_force = torch.zeros((0, B), dtype=dtype, device=dev)
    qfrc_actuator = torch.zeros((nv, B), dtype=dtype, device=dev)

  # xfrc_applied projection: ancestor-mask sums per dof first,
  #   qx[j] = ang_j·(T_j − anchor_j×F_j + X_j) + lin_j·F_j
  frc = sl.xfrc_applied[:, :3, :]  # (nbody, 3, B)
  trq = sl.xfrc_applied[:, 3:, :]
  mask_nv = const('anc_mask_T', lambda: m.anc_mask.T)  # (nv, nbody)
  T = torch.tensordot(mask_nv, trq, dims=1)  # (nv, 3, B)
  F1 = torch.tensordot(mask_nv, frc, dims=1)
  X = torch.tensordot(mask_nv, _cross(sl.xipos, frc), dims=1)
  ang = cdof[:, :3, :]
  lin = cdof[:, 3:, :]
  qx = torch.sum(ang * (T - _cross(sl.cdof_anchor, F1) + X), dim=1) + \
      torch.sum(lin * F1, dim=1)  # (nv, B)

  qfrc_smooth = (qfrc_passive - qfrc_bias + qfrc_actuator
                 + sl.qfrc_applied.expand(nv, B) + qx)
  qacc_smooth = _lk.spd_solve(qM.contiguous(), qfrc_smooth.contiguous())
  return (
      qM, cvel, qfrc_bias, qfrc_passive, actuator_force, qfrc_actuator,
      qfrc_smooth, qacc_smooth,
  )
