"""Constraint assembly with the batch in the trailing axis.

Counterpart of ``rsr_mjx_tpu/physics/lanes_assembly.py`` with its dynamic
leaves in lanes (``dyn_lanes=True``), in both forms:

  - ``basis=True`` (the cube-push step): top-k contact selection through
    kernel K2 (``contact_select_lanes``); the structured rows [equality |
    dof friction | joint limits] as a (J, aref, D, floss) block and the
    selected contacts as the pyramid BASIS U = [Jn | μ₁A₁ | …] with
    per-basis aref and per-contact D, which kernel K3 consumes;
  - ``basis=False`` (the Go2 step, and any model fed to the generic Newton
    kernel K4): every contact expanded into its own rows after the
    structured ones, contact-major, then friction axis, then ±; condim-1
    contacts give one normal row each.  Contacts are all the slots (no
    selection, grouped by condim) or the K2-selected ones.  The rows are
    written into preallocated outputs: the structured ones at their head,
    the contacts' rows, with their aref, D and floss, into their tail by
    kernel K5 (``linalg_kernels.assemble_rows``; on the CPU its plain
    version, the former expansion) in one pass, with no concatenation.

Under domain randomisation the per-slot contact parameters may be per env
(a randomised ``geom_friction``).  K2 then gathers their 13 columns with the
dynamic features (Fd 13 → 26) and its pair table holds the dof masks alone,
so its output has the column layout of the JAX package's ``lax.top_k`` +
one-hot einsum branch for that case (dyn 0:13, parameters 13:26, masks
from 26); the JAX package leaves its kernel there for a TPU VMEM limit that
the H100 does not share.
"""

from __future__ import annotations

import numpy as np
import torch

from rsr_mjx_tpu_torch.physics import constraint as C
from rsr_mjx_tpu_torch.physics import linalg_kernels as _lk
from rsr_mjx_tpu_torch.physics import statics
from rsr_mjx_tpu_torch.physics.types import EqType, Model
from rsr_mjx_tpu_torch.utils import tracing

_MJ_MINVAL = C._MJ_MINVAL


def _pair_slot0(m: Model) -> np.ndarray:
  """Static first-slot id of each collision pair (slot order)."""
  out = [off + np.arange(P) * k for _, P, k, off in C.pair_groups(m)]
  return np.concatenate(out) if out else np.zeros((0,), np.int64)


def _limit_pattern(m: Model, lim_j: np.ndarray) -> np.ndarray:
  """Static Jacobian (nv, 2L) of the interleaved lo/hi limit rows."""
  pattern = np.zeros((m.nv, 2 * len(lim_j)), np.float32)
  for i, v in enumerate(m.jnt_dofadr[lim_j]):
    pattern[v, 2 * i] = 1.0
    pattern[v, 2 * i + 1] = -1.0
  return pattern


def contact_row_table(m: Model) -> np.ndarray:
  """Static (nc, 3) table of the generic route's contacts in row order: the
  slot each reads (of all ncon slots, or of the nsel selected), its first
  row counted from the first contact row, its condim.  The condim groups
  come in ascending order, each contact-major (``constraint.layout``)."""
  condims = C._condims_static(m)
  nsel = C._selection_size(m)
  if nsel:
    slots, cds = np.arange(nsel), np.full(nsel, condims[0])
  else:
    order = [np.nonzero(condims == cd)[0] for cd in sorted(set(condims))]
    slots = np.concatenate(order) if order else np.zeros(0, np.int64)
    cds = condims[slots]
  nrows = np.array([C._contact_rows(int(cd)) for cd in cds], np.int64)
  first = np.concatenate([[0], np.cumsum(nrows)[:-1]]).astype(np.int64)
  return np.stack([slots, first, cds], axis=1).astype(np.int32)


def assemble_lanes(m: Model, lv: C.AssembleLeaves, basis: bool = True):
  """Narrow phase + assembly over a batch.

  Every leaf of ``lv`` ends in the batch axis: B for the six dynamic
  leaves (qpos, qvel, cdof, cdof_anchor, geom_xpos, geom_xmat) and for
  domain-randomised model leaves, 1 for shared ones (``gather_leaves``).

  ``basis=True`` requires contact selection (``m.ncon_sel``) with uniform
  condim ≥ 2 and returns (J_s (nv, Rs, B), aref_s, D_s, floss_s (Rs, B),
  dist (B, ncon), U (nv, (naxes+1)·nsel, B), arefU ((naxes+1)·nsel, B),
  D_c (nsel, B), naxes).  ``basis=False`` returns the generic rows
  (J (nv, nefc, B), aref, D, floss (nefc, B), dist (B, ncon)) in the order
  of ``constraint.layout``, the contacts' rows from K5 (with grad mode on
  and an input requiring grad, through ``linalg_kernels.AssembleRows``).
  """
  lay = C.layout_cached(m)
  nv = m.nv
  nsel = C._selection_size(m)
  condims = C._condims_static(m)
  if basis:
    if not (m.ncon and nsel):
      raise ValueError('basis assembly requires contacts and ncon_sel')
    if int(condims[0]) < 2:
      raise ValueError('basis assembly requires condim >= 2')
  qpos, qvel = lv.qpos, lv.qvel  # (nq, B), (nv, B)
  B = qpos.shape[-1]
  dtype, dev = qpos.dtype, qpos.device
  bc = lambda x: x.expand(x.shape[:-1] + (B,))
  inv0 = lv.dof_invweight0  # (nv, B or 1)
  zrow = lambda r: torch.zeros((r, B), dtype=dtype, device=dev)
  const = lambda name, build, dt=None: statics.table(m, name, build, dev, dt)

  J_blocks, pos_blocks, sr_blocks, si_blocks = [], [], [], []
  diagA_blocks, floss_blocks, margin_blocks = [], [], []

  # ---- equality (JOINT)
  for q in range(m.neq):
    if int(m.eq_type[q]) != EqType.JOINT:
      raise NotImplementedError('connect/weld equality not yet implemented')
    j1, j2 = int(m.eq_obj1id[q]), int(m.eq_obj2id[q])
    q1adr, v1adr = int(m.jnt_qposadr[j1]), int(m.jnt_dofadr[j1])
    data = lv.eq_data[q]  # (11, B or 1)
    row = torch.zeros((nv, 1, B), dtype=dtype, device=dev)
    row[v1adr] = 1.0
    if 0 <= j2 < m.njnt and j2 != j1:
      q2adr, v2adr = int(m.jnt_qposadr[j2]), int(m.jnt_dofadr[j2])
      dif = qpos[q2adr] - lv.qpos0[q2adr]  # (B,)
      poly = (data[0] + data[1] * dif + data[2] * dif**2 + data[3] * dif**3
              + data[4] * dif**4)
      dpoly = (data[1] + 2 * data[2] * dif + 3 * data[3] * dif**2
               + 4 * data[4] * dif**3)
      pos = (qpos[q1adr] - lv.qpos0[q1adr]) - poly
      row[v2adr] = row[v2adr] - dpoly[None, :]
      diagA = (inv0[v1adr] + inv0[v2adr]).expand(B)
    else:
      pos = qpos[q1adr] - lv.qpos0[q1adr] - data[0]
      diagA = inv0[v1adr].expand(B)
    J_blocks.append(row)
    pos_blocks.append(pos[None])
    sr_blocks.append(bc(lv.eq_solref[q])[None])
    si_blocks.append(bc(lv.eq_solimp[q])[None])
    diagA_blocks.append(diagA[None])
    floss_blocks.append(zrow(1))
    margin_blocks.append(zrow(1))

  # ---- dof friction loss
  J_blocks.append(torch.eye(nv, dtype=dtype, device=dev)[:, :, None]
                  .expand(nv, nv, B))
  pos_blocks.append(zrow(nv))
  sr_blocks.append(bc(lv.dof_solref))
  si_blocks.append(bc(lv.dof_solimp))
  diagA_blocks.append(bc(inv0))
  floss_blocks.append(bc(lv.dof_frictionloss))
  margin_blocks.append(zrow(nv))

  # ---- joint limits (interleaved lo/hi rows per limited joint)
  lim_j = np.nonzero(m.jnt_limited != 0)[0]
  L = len(lim_j)
  if L:
    qadr = const('limit_qadr', lambda: m.jnt_qposadr[lim_j], torch.long)
    vadr = const('limit_vadr', lambda: m.jnt_dofadr[lim_j], torch.long)
    lim_t = const('limit_jnt', lambda: lim_j, torch.long)
    J_blocks.append(const('limit_pattern', lambda: _limit_pattern(m, lim_j),
                          dtype)[:, :, None].expand(nv, 2 * L, B))
    q = qpos[qadr]  # (L, B)
    lo = lv.jnt_range[lim_t, 0]  # (L, B or 1)
    hi = lv.jnt_range[lim_t, 1]
    pos_blocks.append(torch.stack([q - lo, hi - q], dim=1).reshape(2 * L, B))
    rep2 = lambda x: torch.repeat_interleave(x, 2, dim=0)
    sr_blocks.append(bc(rep2(lv.jnt_solref[lim_t])))
    si_blocks.append(bc(rep2(lv.jnt_solimp[lim_t])))
    diagA_blocks.append(bc(rep2(inv0[vadr])))
    floss_blocks.append(zrow(2 * L))
    margin_blocks.append(bc(rep2(lv.jnt_margin[lim_t])))

  # ---- contacts: narrow phase, then the top-nsel selection (kernel K2)
  # or every slot as it is
  zero = torch.zeros((), dtype=dtype, device=dev)
  basis_out = ()
  if m.ncon:
    with tracing.span('physics.collision'):
      dist_l, pos_l, frame_l = C.narrowphase_leaves(m, lv)
    dist_bm = dist_l.transpose(0, 1)  # (B, ncon)
    dmask_all = const('contact_dmask', lambda: C.contact_dmask(m),
                      dtype)  # (ncon, nv)
    if nsel:
      feat_dyn = torch.cat(
          [dist_l[:, None], pos_l, frame_l.reshape(m.ncon, 9, B)], dim=1
      )  # (ncon, 13, B)
      slot0 = const('pair_slot0', lambda: _pair_slot0(m), torch.long)
      st = (lv.con_friction, lv.con_solref, lv.con_solimp,
            lv.con_invweight[:, None])
      Bm = max(x.shape[-1] for x in st)
      feat_st = torch.cat([x.expand(x.shape[:-1] + (Bm,)) for x in st],
                          dim=1)  # (ncon, 13, B or 1)
      if Bm == 1:
        # shared parameters, constant within a pair: a column block of the
        # pair table
        ptab = torch.cat([feat_st[slot0, :, 0], dmask_all[slot0]], dim=1)
      else:
        # per-env parameters ride with the dynamic features
        feat_dyn = torch.cat([feat_dyn, feat_st], dim=1)  # (ncon, 26, B)
        ptab = dmask_all[slot0]
      pair_struct = tuple((P, k, off) for _, P, k, off in C.pair_groups(m))
      sel, _ = _lk.contact_select_lanes(
          pair_struct, nsel, dist_l.contiguous(), feat_dyn.contiguous(),
          ptab.contiguous())  # (nsel, 13 + 13 + nv, B)
      c_dist = sel[:, 0]  # (nc, B)
      c_pos = sel[:, 1:4]  # (nc, 3, B)
      c_frame = sel[:, 4:13]  # (nc, 9, B)
      sel_st = sel[:, 13:26]
      c_friction = sel_st[:, 0:5]
      c_solref = sel_st[:, 5:7]
      c_solimp = sel_st[:, 7:12]
      c_invw = sel_st[:, 12]
      dmask = sel[:, 26 : 26 + nv]  # (nc, nv, B)
      groups = [(int(condims[0]), slice(None))]
    else:
      c_dist = dist_l  # (ncon, B)
      c_pos = pos_l  # (ncon, 3, B)
      c_frame = frame_l.reshape(m.ncon, 9, B)
      # shared (B 1) or per env (B)
      c_friction, c_solref, c_solimp, c_invw = (
          lv.con_friction, lv.con_solref, lv.con_solimp, lv.con_invweight)
      dmask = dmask_all[:, :, None]  # (ncon, nv, 1)
      groups = [
          (cd, const(f'condim{cd}_slots',
                     lambda cd=cd: np.nonzero(condims == cd)[0], torch.long))
          for cd in sorted(set(int(x) for x in condims))
      ]

    if basis:
      Jn, friction_axes = C.contact_jacobians(lv.cdof, lv.cdof_anchor, c_pos,
                                              c_frame, dmask)
      nf = int(condims[0]) - 1
      axes = friction_axes(nf)
      U_parts = [Jn.transpose(0, 1)]  # (nv, nc, B)
      velU = [torch.sum(Jn * qvel[None], dim=1)]  # (nc, B)
      for i in range(nf):
        Ai = c_friction[:, i][:, None, :] * axes[i]  # μᵢAᵢ
        U_parts.append(Ai.transpose(0, 1))
        velU.append(torch.sum(Ai * qvel[None], dim=1))
      U_basis = torch.cat(U_parts, dim=1).contiguous()  # (nv, (nf+1)·nc, B)
      imp_c = C._impedance(c_solimp, c_dist)
      kk_c, bb_c = C._kbi(c_solref, c_solimp[:, 1])
      mu0 = c_friction[:, 0]
      diagA_c = (c_invw * 2.0 * torch.clamp(mu0 * mu0, min=_MJ_MINVAL)
                 / m.opt.impratio)
      Rreg_c = torch.clamp(
          (1.0 - imp_c) / torch.clamp(imp_c, min=_MJ_MINVAL) * diagA_c,
          min=_MJ_MINVAL,
      )
      sep_c = c_dist >= 0.0
      D_c = torch.where(sep_c, zero, 1.0 / Rreg_c)
      aref_n = torch.where(sep_c, zero,
                           -bb_c * velU[0] - kk_c * imp_c * c_dist)
      arefU = torch.cat(
          [aref_n] + [torch.where(sep_c, zero, -bb_c * v) for v in velU[1:]],
          dim=0,
      )
      basis_out = (U_basis, arefU.contiguous(), D_c.contiguous(), nf)
    else:
      # the contacts' generic rows (K5), written after the structured ones
      spec = _lk.RowSpec(tuple(groups), const(
          'selected_row_table' if nsel else 'contact_row_table',
          lambda: contact_row_table(m), torch.int32), lay.n_con)
      rows_in = tuple(x.contiguous() for x in (
          qvel, lv.cdof, lv.cdof_anchor, c_dist, c_pos, c_frame, c_friction,
          c_solref, c_solimp, c_invw, dmask))
  else:
    dist_bm = torch.zeros((B, 0), dtype=dtype, device=dev)

  # ---- structured rows: impedance, aref, D
  n_struct = lay.n_eq + lay.n_fri + lay.n_lim
  if basis:
    J = torch.cat(J_blocks, dim=1)  # (nv, Rs, B)
  else:
    # the generic rows: the structured blocks written into the head of J,
    # the contacts' rows (K5) into its tail
    J = torch.empty((nv, lay.nefc, B), dtype=dtype, device=dev)
    aref = torch.empty((lay.nefc, B), dtype=dtype, device=dev)
    D, floss = torch.empty_like(aref), torch.empty_like(aref)
    r = 0
    for blk in J_blocks:
      J[:, r : r + blk.shape[1]] = blk
      r += blk.shape[1]
    if r != n_struct or lay.nefc != n_struct + (spec.n_rows if m.ncon else 0):
      raise AssertionError((r, lay))
    if m.ncon:
      _lk.contact_rows(spec, m.opt.impratio, *rows_in, J, aref, D, floss)
  pos = torch.cat(pos_blocks, dim=0)  # (Rs, B)
  sr = torch.cat(sr_blocks, dim=0)  # (Rs, 2, B)
  si = torch.cat(si_blocks, dim=0)  # (Rs, 5, B)
  diagA = torch.cat(diagA_blocks, dim=0)
  floss_s = torch.cat(floss_blocks, dim=0)
  margin = torch.cat(margin_blocks, dim=0)
  if pos.shape[0] != n_struct:
    raise AssertionError((pos.shape, lay))
  kind = lay.kind[:n_struct]
  onesided = const('struct_onesided',
                   lambda: ((kind == C.LIMIT) | (kind == C.CONTACT))[:, None],
                   torch.bool)
  # J·qvel of the structured rows; on the CPU summed over every row of J, as
  # the plain K5 sums the contacts' (the CPU's rounding of the sum depends on
  # the shape summed, and the tests hold these rows to the former assembly's
  # bit for bit)
  Jv = J if basis or dev.type == 'cpu' else J[:, :n_struct]
  vel = torch.sum(Jv * qvel[:, None, :], dim=0)[:n_struct]
  aref_s, D_s = C.soft_rows(vel, pos, margin, sr, si, diagA, onesided, zero)
  if basis:
    return (J.contiguous(), aref_s.contiguous(), D_s.contiguous(),
            floss_s.contiguous(), dist_bm) + basis_out
  aref[:n_struct], D[:n_struct], floss[:n_struct] = aref_s, D_s, floss_s
  return J, aref, D, floss, dist_bm
