"""Static-shape narrow phase, batch in the trailing axis.

Counterpart of ``rsr_mjx_tpu/physics/collision.py``.  The pair table is
built on the host (io._collision_pairs); every potential pair always
produces its fixed quota of contact slots, with ``dist > 0`` marking
separated candidates.  Each 3-vector is a python list of three (P, B)
tensors (P pairs, B envs), so each primitive is one elementwise op over
the whole batch.

Every pair group of the JAX package is here, op for op with its fp32
thresholds: plane_sphere, plane_capsule, plane_box, sphere_sphere,
sphere_capsule, sphere_box, capsule_capsule, capsule_box, box_box and the
heightfield against a sphere (hfield_sphere, a bilinear sample of
``Model.hfield_data``).  The Airbot cube scenes run box_box; the Go2
feet-only scene plane_sphere; the Go2 full-collision scene plane_sphere,
plane_capsule, sphere_sphere, sphere_capsule and capsule_capsule; the Go2
rough scene hfield_sphere.  plane_box, sphere_box and capsule_box have no
registered env.

Contact convention (MuJoCo): ``frame[0]`` is the normal from geom1 towards
geom2; ``dist < 0`` means penetration; ``pos`` is the midpoint between the
two surfaces.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.frozen.physics import statics
from benchmark.reference.frozen.physics.io import GROUP_NCON
from benchmark.reference.frozen.physics.types import Data, Model

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


def _safe_norm_v(v):
  """‖v‖, 0 at v = 0 with a finite gradient there (a where on both sides
  of the square root)."""
  sq = _dot(v, v)
  is_zero = sq < _MJ_MINVAL
  return torch.where(is_zero, torch.zeros_like(sq),
                     torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)))


def _safe_normalize_v(v):
  """(v/‖v‖, ‖v‖) with zero output at v = 0."""
  n = _safe_norm_v(v)
  inv = 1.0 / torch.where(n < _MJ_MINVAL, torch.ones_like(n), n)
  return _scale(v, inv), n


def _clip(x, lo, hi):
  """jnp.clip: max with ``lo``, then min with ``hi``."""
  return torch.minimum(torch.maximum(x, lo), hi)


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
  clamped = [_clip(local[j], -sb[j], sb[j]) for j in range(3)]
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


def _plane_capsule(p1, m1, s1, p2, m2, s2):
  """Two slots per pair: each end of the capsule's segment."""
  n = [m1[i][2] for i in range(3)]
  axis = [m2[i][2] for i in range(3)]
  r, half = s2[0], s2[1]
  out = []
  for sgn in (1.0, -1.0):
    e = _add(p2, _scale(axis, sgn * half))
    dist = _dot(e, n) - _dot(n, p1) - r
    pos = _sub(e, _scale(n, r + 0.5 * dist))
    out.append((dist, pos, n))
  return out


def _plane_box(p1, m1, s1, p2, m2, s2):
  """All 8 corners are slots (separated ones are inert downstream)."""
  n = [m1[i][2] for i in range(3)]
  d0 = _dot(n, p1)
  out = []
  for sg in _SIGNS:
    c = _box_corner(p2, m2, s2, sg)
    dist = _dot(c, n) - d0
    pos = _sub(c, _scale(n, 0.5 * dist))
    out.append((dist, pos, n))
  return out


def _sphere_sphere_at(p1, r1, p2, r2):
  n, l = _safe_normalize_v(_sub(p2, p1))
  dist = l - r1 - r2
  pos = _add(p1, _scale(n, r1 + 0.5 * dist))
  return dist, pos, n


def _sphere_sphere(p1, m1, s1, p2, m2, s2):
  return [_sphere_sphere_at(p1, s1[0], p2, s2[0])]


def _closest_on_segment(p, a, axis, half):
  t = _clip(_dot(_sub(p, a), axis), -half, half)
  return _add(a, _scale(axis, t))


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
  axis = [m2[i][2] for i in range(3)]
  c = _closest_on_segment(p1, p2, axis, s2[1])
  return [_sphere_sphere_at(p1, s1[0], c, s2[0])]


def _sphere_box(p1, m1, s1, p2, m2, s2):
  dist_c, n = _point_box(p1, p2, m2, s2)
  r = s1[0]
  dist = dist_c - r
  pos = _add(p1, _scale(n, r + 0.5 * dist))
  return [(dist, pos, n)]


def _capsule_box(p1, m1, s1, p2, m2, s2):
  """Two slots per pair: each end of the capsule's segment against the
  box."""
  axis = [m1[i][2] for i in range(3)]
  r, half = s1[0], s1[1]
  out = []
  for sgn in (1.0, -1.0):
    e = _add(p1, _scale(axis, sgn * half))
    dc, n = _point_box(e, p2, m2, s2)
    dist = dc - r
    pos = _add(e, _scale(n, r + 0.5 * dist))
    out.append((dist, pos, n))
  return out


def _segment_segment(a1, u1, h1, a2, u2, h2):
  """Closest points of two segments (centres a, unit directions u, half
  lengths h).  Near-parallel segments (|1 − (u1·u2)²| <= 1e-9, decided in
  the working precision) start from s = 0."""
  d = _sub(a1, a2)
  b = _dot(u1, u2)
  e = _dot(u1, d)
  f = _dot(u2, d)
  denom = 1.0 - b * b
  ok = torch.abs(denom) > 1e-9
  s = torch.where(ok, (b * f - e) / torch.where(ok, denom,
                                                torch.ones_like(denom)),
                  torch.zeros_like(denom))
  s = _clip(s, -h1, h1)
  t = _clip(b * s + f, -h2, h2)
  s = _clip(b * t - e, -h1, h1)
  return _add(a1, _scale(u1, s)), _add(a2, _scale(u2, t))


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
  u1 = [m1[i][2] for i in range(3)]
  u2 = [m2[i][2] for i in range(3)]
  c1, c2 = _segment_segment(p1, u1, s1[1], p2, u2, s2[1])
  return [_sphere_sphere_at(c1, s1[0], c2, s2[0])]


_GROUP_FN = {
    'plane_sphere': _plane_sphere,
    'plane_capsule': _plane_capsule,
    'plane_box': _plane_box,
    'sphere_sphere': _sphere_sphere,
    'sphere_capsule': _sphere_capsule,
    'sphere_box': _sphere_box,
    'capsule_capsule': _capsule_capsule,
    'capsule_box': _capsule_box,
    'box_box': _box_box,
}


def _hfield_sphere(m: Model, tbl, geom_size, gxpos, gxmat):
  """Heightfield against sphere, one slot per pair: the bilinear height
  of the cell under the sphere's centre (clipped to the grid, 1.001 cells
  short of its far edges) and a normal from the cell's finite
  differences.  Heights come from ``m.hfield_data``, which no randomiser
  batches.  Returns one slot, a (dist (P, B), pos, n) triple."""
  dists, poss, ns = [], [], []
  hdata = m.hfield_data
  for hgeom, sgeom, _ in np.asarray(tbl):
    hgeom, sgeom = int(hgeom), int(sgeom)
    hid = int(m.geom_dataid[hgeom])
    nrow, ncol = int(m.hfield_nrow[hid]), int(m.hfield_ncol[hid])
    adr = int(m.hfield_adr[hid])
    hsize = m.hfield_size[hid]  # (4,) numpy

    hpos = [gxpos[hgeom, i] for i in range(3)]  # (B,)
    hmat = [[gxmat[hgeom, i, j] for j in range(3)] for i in range(3)]
    center = [gxpos[sgeom, i] for i in range(3)]
    r = geom_size[sgeom, 0]  # (B or 1,)

    local = _matTvec(hmat, _sub(center, hpos))
    fx = (local[0] / float(hsize[0]) * 0.5 + 0.5) * (ncol - 1)
    fy = (local[1] / float(hsize[1]) * 0.5 + 0.5) * (nrow - 1)
    fx = torch.clamp(fx, 0.0, ncol - 1.001)
    fy = torch.clamp(fy, 0.0, nrow - 1.001)
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    wx = fx - x0
    wy = fy - y0
    base = (adr + y0 * ncol + x0).long()
    h00 = hdata[base]
    h01 = hdata[base + 1]
    h10 = hdata[base + ncol]
    h11 = hdata[base + ncol + 1]
    zs = float(hsize[2])
    h = (h00 * (1 - wx) * (1 - wy) + h01 * wx * (1 - wy)
         + h10 * (1 - wx) * wy + h11 * wx * wy) * zs
    dx = 2 * float(hsize[0]) / (ncol - 1)
    dy = 2 * float(hsize[1]) / (nrow - 1)
    gx = (h01 - h00) * zs / dx
    gy = (h10 - h00) * zs / dy
    n_local = [-gx, -gy, torch.ones_like(gx)]
    inv = 1.0 / torch.sqrt(_dot(n_local, n_local))
    n = _matvec(hmat, _scale(n_local, inv))
    dist = (local[2] - h) - r
    pos = _sub(center, _scale(n, r + 0.5 * dist))
    dists.append(dist)
    poss.append(pos)
    ns.append(n)
  cat = lambda parts: torch.stack(parts, dim=0)  # (P, B)
  return [(cat(dists), [cat([p[i] for p in poss]) for i in range(3)],
           [cat([v[i] for v in ns]) for i in range(3)])]


def _group_slots(m: Model, name: str, tbl, geom_size, gxpos, gxmat):
  """The slots of pair group ``name``: gather both geoms' poses and sizes
  by the pair table and run the group's function."""
  dev = gxpos.device
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
  return _GROUP_FN[name](p1, m1, s1, p2, m2, s2)


def _collide_lanes(m: Model, geom_size, gxpos, gxmat):
  """Narrow phase over a batch.  geom_size (ngeom, 3, Bp) with Bp = B or 1,
  gxpos (ngeom, 3, B), gxmat (ngeom, 3, 3, B).  Returns lanes tensors
  dist (ncon, B), pos (ncon, 3, B), frame (ncon, 3, 3, B)."""
  dist_parts, pos_parts, frame_parts = [], [], []
  for name, tbl in m.pairs:
    if len(tbl) == 0:
      continue
    if name == 'hfield_sphere':
      slots = _hfield_sphere(m, tbl, geom_size, gxpos, gxmat)
    else:
      slots = _group_slots(m, name, tbl, geom_size, gxpos, gxmat)
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
