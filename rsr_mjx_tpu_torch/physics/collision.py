"""Static-shape narrow phase, batch in the trailing axis.

Counterpart of ``rsr_mjx_tpu/physics/collision.py``.  The pair table is
built on the host (io._collision_pairs); every potential pair always
produces its fixed quota of contact slots, with ``dist > 0`` marking
separated candidates.  Each 3-vector is a python list of three (P, B)
tensors (P pairs, B envs), so each primitive is one elementwise op over
the whole batch.

Ported pair groups: box_box, the only one the Airbot cube scene has
(30 pairs × 16 probes = 480 slots), and plane_sphere, the only one the Go2
flat-terrain scene has (four feet against the floor, 4 slots).  The other
groups (plane-box, plane-capsule, sphere and capsule pairs, the
heightfield) raise ``NotImplementedError`` naming the pair; they come with
T-push and the remaining Go2 tasks.

Contact convention (MuJoCo): ``frame[0]`` is the normal from geom1 towards
geom2; ``dist < 0`` means penetration; ``pos`` is the midpoint between the
two surfaces.
"""

from __future__ import annotations

import numpy as np
import torch

from rsr_mjx_tpu_torch.physics import statics
from rsr_mjx_tpu_torch.physics.io import GROUP_NCON
from rsr_mjx_tpu_torch.physics.types import Data, Model

_MJ_MINVAL = 1e-15


def _dot(a, b):
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
  return [a[i] - b[i] for i in range(3)]


def _add(a, b):
  return [a[i] + b[i] for i in range(3)]


def _scale(a, s):
  return [a[i] * s for i in range(3)]


def _cross(a, b):
  return [
      a[1] * b[2] - a[2] * b[1],
      a[2] * b[0] - a[0] * b[2],
      a[0] * b[1] - a[1] * b[0],
  ]


def _matvec(M, v):
  return [M[i][0] * v[0] + M[i][1] * v[1] + M[i][2] * v[2] for i in range(3)]


def _matTvec(M, v):
  return [M[0][j] * v[0] + M[1][j] * v[1] + M[2][j] * v[2] for j in range(3)]


def _safe_normalize_v(v):
  """(v/‖v‖, ‖v‖) with zero output at v = 0."""
  sq = _dot(v, v)
  is_zero = sq < _MJ_MINVAL
  n = torch.where(is_zero, torch.zeros_like(sq),
                  torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)))
  inv = 1.0 / torch.where(n < _MJ_MINVAL, torch.ones_like(n), n)
  return _scale(v, inv), n


def _make_frame(n):
  """Orthonormal frame (n, t1, t2) from a unit normal."""
  pick = torch.abs(n[0]) < 0.5
  one, zero = torch.ones_like(n[0]), torch.zeros_like(n[0])
  a = [torch.where(pick, one, zero), torch.where(pick, zero, one), zero]
  t1, _ = _safe_normalize_v(_cross(n, a))
  t2 = _cross(n, t1)
  return n, t1, t2


_SIGNS = [
    (sx, sy, sz)
    for sx in (-1.0, 1.0)
    for sy in (-1.0, 1.0)
    for sz in (-1.0, 1.0)
]


def _point_box(v, pb, mb, sb):
  """Signed distance and direction from point v to a box (dist < 0 inside).

  Outside: dist = |v − closest|, n = (closest − v)/dist.  Inside: dist =
  −(least face margin), n = −outward normal of that face (first-axis
  tie-break)."""
  local = _matTvec(mb, _sub(v, pb))
  clamped = [torch.minimum(torch.maximum(local[j], -sb[j]), sb[j])
             for j in range(3)]
  odir, out_d = _safe_normalize_v(_sub(local, clamped))
  inside = out_d < _MJ_MINVAL

  margins = [sb[j] - torch.abs(local[j]) for j in range(3)]
  k0 = (margins[0] <= margins[1]) & (margins[0] <= margins[2])
  k1 = (~k0) & (margins[1] <= margins[2])
  k2 = (~k0) & (~k1)
  mmin = torch.minimum(margins[0], torch.minimum(margins[1], margins[2]))
  ow_local = [
      torch.where(k, torch.sign(local[j]) + (local[j] == 0).to(local[j].dtype),
                  torch.zeros_like(local[j]))
      for j, k in enumerate((k0, k1, k2))
  ]
  outward = _matvec(mb, ow_local)
  n_out = _scale(_matvec(mb, odir), -1.0)
  dist = torch.where(inside, -mmin, out_d)
  n = [torch.where(inside, -outward[i], n_out[i]) for i in range(3)]
  return dist, n


def _box_corner(p, mat, size, sg):
  local = [sg[j] * size[j] for j in range(3)]
  return _add(p, _matvec(mat, local))


def _box_box(p1, m1, s1, p2, m2, s2):
  """Vertex-in-box probes both directions: 8 + 8 slots per pair."""
  out = []
  for pa, ma, sa, pb, mb, sb, flip in (
      (p1, m1, s1, p2, m2, s2, 1.0),
      (p2, m2, s2, p1, m1, s1, -1.0),
  ):
    for sg in _SIGNS:
      v = _box_corner(pa, ma, sa, sg)
      dist, n = _point_box(v, pb, mb, sb)
      pos = _add(v, _scale(n, 0.5 * dist))
      out.append((dist, pos, _scale(n, flip)))
  return out


def _plane_sphere(p1, m1, s1, p2, m2, s2):
  """One slot per pair: the sphere's lowest point along the plane normal."""
  n = [m1[i][2] for i in range(3)]
  r = s2[0]
  dist = _dot(n, _sub(p2, p1)) - r
  pos = _sub(p2, _scale(n, r + 0.5 * dist))
  return [(dist, pos, n)]


_GROUP_FN = {'box_box': _box_box, 'plane_sphere': _plane_sphere}


def _collide_lanes(m: Model, geom_size, gxpos, gxmat):
  """Narrow phase over a batch.  geom_size (ngeom, 3, Bp) with Bp = B or 1,
  gxpos (ngeom, 3, B), gxmat (ngeom, 3, 3, B).  Returns lanes tensors
  dist (ncon, B), pos (ncon, 3, B), frame (ncon, 3, 3, B)."""
  dist_parts, pos_parts, frame_parts = [], [], []
  dev = gxpos.device
  for name, tbl in m.pairs:
    if len(tbl) == 0:
      continue
    fn = _GROUP_FN.get(name)
    if fn is None:
      raise NotImplementedError(
          f'collision pair group {name!r} is not ported yet'
      )
    g1 = statics.table(m, f'pairs.{name}.g1', lambda: tbl[:, 0], dev,
                       torch.long)
    g2 = statics.table(m, f'pairs.{name}.g2', lambda: tbl[:, 1], dev,
                       torch.long)
    p1 = [gxpos[g1, i] for i in range(3)]
    m1 = [[gxmat[g1, i, j] for j in range(3)] for i in range(3)]
    s1 = [geom_size[g1, i] for i in range(3)]
    p2 = [gxpos[g2, i] for i in range(3)]
    m2 = [[gxmat[g2, i, j] for j in range(3)] for i in range(3)]
    s2 = [geom_size[g2, i] for i in range(3)]
    slots = fn(p1, m1, s1, p2, m2, s2)
    assert len(slots) == GROUP_NCON[name]

    d_sl, pos_sl, fr_sl = [], [], []
    for dist, pos, n in slots:
      nrm, t1, t2 = _make_frame(n)
      d_sl.append(dist)  # (P, B)
      pos_sl.append(torch.stack(pos, dim=-2))  # (P, 3, B)
      fr_sl.append(torch.stack(
          [torch.stack(v, dim=-2) for v in (nrm, t1, t2)], dim=-3
      ))  # (P, 3, 3, B)
    P, B = d_sl[0].shape
    nk = len(d_sl)
    # (P, k, ...) → (P·k, ...): pair-major slot order
    dist_parts.append(torch.stack(d_sl, dim=1).reshape(P * nk, B))
    pos_parts.append(torch.stack(pos_sl, dim=1).reshape(P * nk, 3, B))
    frame_parts.append(torch.stack(fr_sl, dim=1).reshape(P * nk, 3, 3, B))
  return (
      torch.cat(dist_parts), torch.cat(pos_parts), torch.cat(frame_parts)
  )


def _combine_params(m: Model, name: str, g1, g2):
  """mj_contactParam mixing per pair of group ``name``, in lanes:
  (friction (P, 5, Bm), solref (P, 2, Bm), solimp (P, 5, Bm)), Bm the
  number of envs where domain randomisation makes a mixed leaf per env,
  else 1."""
  p1 = m.geom_priority[g1]
  p2 = m.geom_priority[g2]
  dev = m.device
  const = lambda key, build, dt: statics.table(m, f'pairs.{name}.{key}',
                                               build, dev, dt)
  pri1 = const('pri1', lambda: p1 > p2, torch.bool)[:, None, None]
  pri2 = const('pri2', lambda: p2 > p1, torch.bool)[:, None, None]
  nopri = ~(pri1 | pri2)  # (P, 1, 1)
  gi1 = const('g1', lambda: g1, torch.long)
  gi2 = const('g2', lambda: g2, torch.long)
  fric, solref = m.lanes('geom_friction'), m.lanes('geom_solref')
  solimp, solmix = m.lanes('geom_solimp'), m.lanes('geom_solmix')
  f1, f2 = fric[gi1], fric[gi2]  # (P, 3, Bm)
  sr1, sr2 = solref[gi1], solref[gi2]
  si1, si2 = solimp[gi1], solimp[gi2]
  mix1, mix2 = solmix[gi1][:, None], solmix[gi2][:, None]  # (P, 1, Bm)

  denom = mix1 + mix2
  w1 = torch.where(denom > _MJ_MINVAL,
                   mix1 / torch.clamp(denom, min=_MJ_MINVAL),
                   torch.full_like(denom, 0.5))
  w1 = torch.where((mix1 < _MJ_MINVAL) & (mix2 >= _MJ_MINVAL),
                   torch.zeros_like(w1), w1)
  w1 = torch.where((mix2 < _MJ_MINVAL) & (mix1 >= _MJ_MINVAL),
                   torch.ones_like(w1), w1)

  z = lambda x: torch.zeros_like(x)
  friction3 = (torch.where(pri1, f1, z(f1)) + torch.where(pri2, f2, z(f2))
               + torch.where(nopri, torch.maximum(f1, f2), z(f1)))
  solref_mix = w1 * sr1 + (1 - w1) * sr2
  direct = (sr1[:, 0:1] <= 0) | (sr2[:, 0:1] <= 0)
  solref_nopri = torch.where(direct, torch.minimum(sr1, sr2), solref_mix)
  solref_c = (torch.where(pri1, sr1, z(sr1)) + torch.where(pri2, sr2, z(sr2))
              + torch.where(nopri, solref_nopri, z(sr1)))
  solimp_c = (torch.where(pri1, si1, z(si1)) + torch.where(pri2, si2, z(si2))
              + torch.where(nopri, w1 * si1 + (1 - w1) * si2, z(si1)))
  friction = torch.stack([
      friction3[:, 0], friction3[:, 0], friction3[:, 1], friction3[:, 2],
      friction3[:, 2],
  ], dim=1)
  return friction, solref_c, solimp_c


def combine_solparams(m: Model):
  """Per-slot contact solver parameters (friction (ncon, 5, Bm), solref
  (ncon, 2, Bm), solimp (ncon, 5, Bm)) in slot order, constant within a
  pair; Bm as in ``_combine_params``."""
  fr, sr, si = [], [], []
  for name, tbl in m.pairs:
    if len(tbl) == 0:
      continue
    k = GROUP_NCON[name]
    f, r, i = _combine_params(m, name, tbl[:, 0], tbl[:, 1])
    fr.append(torch.repeat_interleave(f, k, dim=0))
    sr.append(torch.repeat_interleave(r, k, dim=0))
    si.append(torch.repeat_interleave(i, k, dim=0))
  return torch.cat(fr), torch.cat(sr), torch.cat(si)


def contact_static_ids(m: Model):
  """Static per-slot (geom1, geom2, condim) arrays in slot order."""
  g1, g2, cd = [], [], []
  for name, tbl in m.pairs:
    if len(tbl):
      k = GROUP_NCON[name]
      g1.append(np.repeat(tbl[:, 0], k))
      g2.append(np.repeat(tbl[:, 1], k))
      cd.append(np.repeat(tbl[:, 2], k))
  return np.concatenate(g1), np.concatenate(g2), np.concatenate(cd)


def geoms_colliding(m: Model, d: Data, geom1: int, geom2: int) -> torch.Tensor:
  """(B,) bool: whether any contact slot of the (geom1, geom2) pair
  penetrates.  The slots are located from the static contact table, so this
  is a fixed gather and a reduction."""
  g1, g2 = d.contact.geom1, d.contact.geom2
  sel = np.nonzero(
      ((g1 == geom1) & (g2 == geom2)) | ((g1 == geom2) & (g2 == geom1))
  )[0]
  dist = d.contact.dist
  if len(sel) == 0:
    return torch.zeros(dist.shape[0], dtype=torch.bool, device=dist.device)
  idx = statics.table(m, f'colliding.{geom1}.{geom2}', lambda: sel,
                      dist.device, torch.long)
  return torch.any(dist[:, idx] < 0, dim=1)
