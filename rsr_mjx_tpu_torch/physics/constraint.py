"""Constraint layout and soft-constraint math (MuJoCo semantics).

Counterpart of ``rsr_mjx_tpu/physics/constraint.py``: the static row
layout ``[equality | dof friction loss | joint limits | contact pyramids]``,
the pair-group bookkeeping the contact selection needs, the solref/solimp
impedance math, and the gathering of the assembly's inputs.  The batch
lives in the trailing axis (lanes layout), as in the JAX lanes stages.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from rsr_mjx_tpu_torch.physics import statics
from rsr_mjx_tpu_torch.physics.io import GROUP_NCON
from rsr_mjx_tpu_torch.physics.types import EqType, Model

_MJ_MINVAL = 1e-15
_MINIMP = 0.0001
_MAXIMP = 0.9999

# row kinds
EQUALITY = 0
FRICTION = 1
LIMIT = 2
CONTACT = 3


@dataclasses.dataclass(frozen=True)
class EfcLayout:
  """Static description of the constraint rows for a model."""

  nefc: int
  n_eq: int
  n_fri: int
  n_lim: int
  n_con: int
  kind: np.ndarray  # (nefc,) row kind


def _contact_rows(condim: int) -> int:
  return 1 if condim == 1 else 2 * (condim - 1)


def contact_condims(m: Model) -> list:
  """Static per-contact condim, in the collider's slot order."""
  out = []
  for name, tbl in m.pairs:
    for row in tbl:
      out.extend([int(row[2])] * GROUP_NCON[name])
  return out


def _selection_size(m: Model) -> int:
  """Effective top-k contact selection size (0 = disabled)."""
  nsel = m.ncon_sel or 0
  if nsel <= 0 or nsel >= m.ncon:
    return 0
  condims = set(contact_condims(m))
  if len(condims) > 1:
    raise NotImplementedError(
        'ncon_sel requires uniform contact condim; got %s' % sorted(condims)
    )
  return nsel


def layout(m: Model) -> EfcLayout:
  n_eq = 0
  for e in range(m.neq):
    t = int(m.eq_type[e])
    if t == EqType.JOINT:
      n_eq += 1
    elif t == EqType.CONNECT:
      n_eq += 3
    elif t == EqType.WELD:
      n_eq += 6
    else:
      raise NotImplementedError(f'equality type {t}')
  n_fri = m.nv
  n_lim = 2 * int(np.sum(m.jnt_limited != 0))
  condims = contact_condims(m)
  nsel = _selection_size(m)
  if nsel:
    n_con = _contact_rows(condims[0]) * nsel
  else:
    n_con = sum(_contact_rows(cd) for cd in condims)
  kind = np.concatenate([
      np.full(n_eq, EQUALITY),
      np.full(n_fri, FRICTION),
      np.full(n_lim, LIMIT),
      np.full(n_con, CONTACT),
  ]).astype(np.int32)
  return EfcLayout(len(kind), n_eq, n_fri, n_lim, n_con, kind)


_LAYOUT_CACHE: dict = {}


def _pairs_key(m: Model):
  return tuple((n, t.tobytes()) for n, t in m.pairs)


def layout_cached(m: Model) -> EfcLayout:
  key = (m.neq, m.nv, m.jnt_limited.tobytes(), _pairs_key(m), m.ncon,
         m.ncon_sel)
  if key not in _LAYOUT_CACHE:
    _LAYOUT_CACHE[key] = layout(m)
  return _LAYOUT_CACHE[key]


def _condims_static(m: Model) -> np.ndarray:
  """Static per-slot condim vector (ncon,)."""
  return np.asarray(contact_condims(m), np.int32)


def pair_groups(m: Model):
  """Static (name, n_pairs, slots_per_pair, slot_offset) per pair group, in
  the collider's slot order (pair-major blocks of ``slots_per_pair``)."""
  out = []
  off = 0
  for name, tbl in m.pairs:
    P = len(tbl)
    if not P:
      continue
    k = GROUP_NCON[name]
    out.append((name, P, k, off))
    off += P * k
  return out


def contact_geom_ids(m: Model):
  """Static per-slot (geom1, geom2) int arrays in slot order."""
  g1, g2 = [], []
  for name, tbl in m.pairs:
    if len(tbl):
      k = GROUP_NCON[name]
      g1.append(np.repeat(tbl[:, 0], k))
      g2.append(np.repeat(tbl[:, 1], k))
  if not g1:
    return np.zeros(0, np.int32), np.zeros(0, np.int32)
  return np.concatenate(g1), np.concatenate(g2)


def contact_dmask(m: Model) -> np.ndarray:
  """Static (ncon, nv) relative dof mask anc_mask[b2] − anc_mask[b1]."""
  g1, g2 = contact_geom_ids(m)
  b1 = m.geom_bodyid[g1]
  b2 = m.geom_bodyid[g2]
  return m.anc_mask[b2] - m.anc_mask[b1]


def _impedance(si: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
  """Impedance d(pos); solimp ``si`` (r, 5, B), pos (r, B)."""
  dmin = torch.clamp(si[:, 0], _MINIMP, _MAXIMP)
  dmax = torch.clamp(si[:, 1], _MINIMP, _MAXIMP)
  width = torch.clamp(si[:, 2], min=_MJ_MINVAL)
  mid = torch.clamp(si[:, 3], _MINIMP, _MAXIMP)
  power = torch.clamp(si[:, 4], min=1.0)
  x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
  a = 1.0 / torch.pow(mid, power - 1.0)
  b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
  y = torch.where(
      x <= mid,
      a * torch.pow(x, power),
      1.0 - b * torch.pow(1.0 - x, power),
  )
  return torch.clamp(dmin + y * (dmax - dmin), _MINIMP, _MAXIMP)


def _kbi(sr: torch.Tensor, dmax: torch.Tensor):
  """Stiffness/damping from solref (standard or direct form); solref ``sr``
  (r, 2, B), dmax (r, B) — the raw solimp[1], as the reference reads it."""
  timeconst, dampratio = sr[:, 0], sr[:, 1]
  standard = timeconst > 0
  one = torch.ones_like(timeconst)
  tc = torch.where(standard, torch.clamp(timeconst, min=_MJ_MINVAL), one)
  dr = torch.where(standard, torch.clamp(dampratio, min=_MJ_MINVAL), one)
  k_std = 1.0 / torch.clamp(dmax * dmax * tc * tc * dr * dr, min=_MJ_MINVAL)
  b_std = 2.0 / torch.clamp(dmax * tc, min=_MJ_MINVAL)
  k_dir = -timeconst / torch.clamp(dmax * dmax, min=_MJ_MINVAL)
  b_dir = -dampratio / torch.clamp(dmax, min=_MJ_MINVAL)
  return torch.where(standard, k_std, k_dir), torch.where(standard, b_std, b_dir)


def soft_rows(vel, pos, margin, sr, si, diagA, onesided, zero):
  """aref and D of constraint rows (MuJoCo's soft constraints) from their
  velocities vel = J·qvel, pos, margin, diagA (R, B), solref ``sr`` (R, 2,
  B), solimp ``si`` (R, 5, B) and ``onesided`` (R, 1) bool; aref and D are
  ``zero`` where a one-sided row's pos − margin >= 0."""
  imp = _impedance(si, pos - margin)
  kk, bb = _kbi(sr, si[:, 1])  # dmax = raw solimp[1], as the reference
  aref = -bb * vel - kk * imp * (pos - margin)
  Rreg = torch.clamp(
      (1.0 - imp) / torch.clamp(imp, min=_MJ_MINVAL) * diagA, min=_MJ_MINVAL
  )
  D = 1.0 / Rreg
  off = onesided & (pos - margin >= 0.0)
  return torch.where(off, zero, aref), torch.where(off, zero, D)


def contact_jacobians(cdof, cdof_anchor, c_pos, c_frame, dmask):
  """The contacts' normal Jacobian and their friction axes.  cdof (nv, 6,
  B), cdof_anchor (nv, 3, B), contact points c_pos (nc, 3, B), frames
  c_frame (nc, 9, B), dof masks dmask (nc, nv, B or 1).  Returns (Jn
  (nc, nv, B), friction_axes): ``friction_axes(nf)`` is the list of the
  first nf of t1, t2, torsion, roll1, roll2, each (nc, nv, B); it builds
  all five whatever nf is."""
  ang = [cdof[:, k] for k in range(3)]  # each (nv, B)
  lin = [cdof[:, 3 + k] for k in range(3)]
  anch = cdof_anchor  # (nv, 3, B)

  def contract(jac, vec9, off):
    """Σ_k jac[k] * frame component (off + k); jac[k] (nc, nv, B)."""
    return sum(jac[k] * vec9[:, off + k][:, None, :] for k in range(3))

  jac_p, jac_r = [], []
  for k in range(3):
    relk2 = c_pos[:, (k + 2) % 3][:, None, :] - anch[:, (k + 2) % 3][None]
    relk1 = c_pos[:, (k + 1) % 3][:, None, :] - anch[:, (k + 1) % 3][None]
    jac_t = (lin[k][None] + ang[(k + 1) % 3][None] * relk2
             - ang[(k + 2) % 3][None] * relk1)  # (nc, nv, B)
    jac_p.append(jac_t * dmask)
    jac_r.append(ang[k][None] * dmask)

  Jn = contract(jac_p, c_frame, 0)  # (nc, nv, B)
  friction_axes = lambda nf: [
      contract(jac_p, c_frame, 3),  # t1
      contract(jac_p, c_frame, 6),  # t2
      contract(jac_r, c_frame, 0),  # torsion
      contract(jac_r, c_frame, 3),  # roll1
      contract(jac_r, c_frame, 6),  # roll2
  ][:nf]
  return Jn, friction_axes


class AssembleLeaves(NamedTuple):
  """Inputs of the assembly, every one with the batch in the trailing axis.
  The six dynamic leaves (qpos, qvel, cdof, cdof_anchor, geom_xpos,
  geom_xmat) are lanes tensors (…, B); the model leaves and the contact
  parameters mixed from them end in an axis of B where domain
  randomisation makes them per env, else of 1 (``Model.lanes``).
  """

  qpos: torch.Tensor
  qvel: torch.Tensor
  cdof: torch.Tensor
  cdof_anchor: torch.Tensor
  geom_xpos: torch.Tensor
  geom_xmat: torch.Tensor
  geom_size: torch.Tensor
  con_friction: torch.Tensor
  con_solref: torch.Tensor
  con_solimp: torch.Tensor
  con_invweight: torch.Tensor
  eq_data: torch.Tensor
  qpos0: torch.Tensor
  dof_invweight0: torch.Tensor
  eq_solref: torch.Tensor
  eq_solimp: torch.Tensor
  dof_solref: torch.Tensor
  dof_solimp: torch.Tensor
  dof_frictionloss: torch.Tensor
  jnt_range: torch.Tensor
  jnt_solref: torch.Tensor
  jnt_solimp: torch.Tensor
  jnt_margin: torch.Tensor


def gather_leaves(m: Model, qpos, qvel, cdof, cdof_anchor, geom_xpos,
                  geom_xmat) -> AssembleLeaves:
  """Collect the assembly's inputs: the given lanes dynamic leaves plus the
  per-slot contact solver parameters (mj_contactParam mixing and body
  invweights, pure functions of model leaves) and the model leaves, all in
  lanes (``Model.lanes``)."""
  from rsr_mjx_tpu_torch.physics import collision as _col

  if m.ncon:
    g1, g2 = contact_geom_ids(m)
    dev = m.device
    b1 = statics.table(m, 'contact_body1', lambda: m.geom_bodyid[g1], dev,
                       torch.long)
    b2 = statics.table(m, 'contact_body2', lambda: m.geom_bodyid[g2], dev,
                       torch.long)
    inv = m.lanes('body_invweight0')  # (nbody, 2, Bm)
    con_invweight = inv[b1][:, 0] + inv[b2][:, 0]  # (ncon, Bm)
    con_friction, con_solref, con_solimp = _col.combine_solparams(m)
  else:
    z = torch.zeros((0, 1), dtype=qpos.dtype, device=qpos.device)
    con_friction, con_solref, con_solimp, con_invweight = (
        z.reshape(0, 5, 1), z.reshape(0, 2, 1), z.reshape(0, 5, 1), z
    )
  return AssembleLeaves(
      qpos, qvel, cdof, cdof_anchor, geom_xpos, geom_xmat,
      m.lanes('geom_size'), con_friction, con_solref, con_solimp,
      con_invweight, *(m.lanes(f) for f in AssembleLeaves._fields[11:]),
  )


def narrowphase_leaves(m: Model, lv: AssembleLeaves):
  """Narrow phase in lanes layout: dist (ncon, B), pos (ncon, 3, B),
  frame (ncon, 3, 3, B)."""
  from rsr_mjx_tpu_torch.physics import collision as _col

  return _col._collide_lanes(m, lv.geom_size, lv.geom_xpos,
                             lv.geom_xmat)
