"""The batched small linear algebra of the physics step in the port's
plain PyTorch versions of its four kernels (frozen copy):

  K1 ``spd_solve_lanes``      batched SPD solve (column Cholesky)
  K2 ``contact_select_lanes`` top-nsel contact selection, feature gather
  K3 ``newton_lanes_pyr_t``   pyramid-basis fixed-iteration Newton solve
  K4 ``_newton_lanes_core``   generic-row fixed-iteration Newton solve

Each keeps the JAX lanes layout (batch in the trailing axis) and the
port's argument order and checks; the port's CUDA route, its shared-memory
sizing and the backward passes are left out (the reference runs no kernel
and takes no gradient through the physics).  The functions take float32 or
float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


# row kinds (constraint.py); kept here too so this module imports nothing
# of the assembly
_FRICTION = 1
_LIMIT = 2
_CONTACT = 3


def _check(name: str, t: torch.Tensor, shape, ref: torch.Tensor) -> None:
  """t has ``shape``, is contiguous and matches ref's device and dtype."""
  if t.dtype != ref.dtype:
    raise TypeError(f'{name}: {t.dtype}, expected {ref.dtype}')
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f'{name}: shape {tuple(t.shape)} != {tuple(shape)}')
  if t.device != ref.device:
    raise ValueError(f'{name}: on {t.device}, expected {ref.device}')
  if not t.is_contiguous():
    raise ValueError(f'{name}: must be contiguous')


def _chol_cols(H: torch.Tensor, eps: float):
  """H (n, n, B) → (cols, djs): cols[j] column j of L as (n, B), zero above
  the diagonal; djs[j] = L[j, j] as (1, B)."""
  n = H.shape[0]
  rows = torch.arange(n, device=H.device)[:, None]
  S = H
  cols, djs = [], []
  for j in range(n):
    Sj = S[j]
    dj2 = torch.clamp(Sj[j : j + 1], min=eps)
    inv = torch.rsqrt(dj2)
    c = Sj * inv * (rows >= j).to(H.dtype)
    cols.append(c)
    djs.append(dj2 * inv)
    if j < n - 1:
      S = S - c[None, :, :] * c[:, None, :]
  return cols, djs


def _cho_solve_cols(cols, djs, b: torch.Tensor) -> torch.Tensor:
  """Solve L Lᵀ x = b from the column factor; b, x (n, B)."""
  n = b.shape[0]
  g = b
  ys = []
  for j in range(n):
    yj = g[j : j + 1] / djs[j]
    ys.append(yj)
    g = g - cols[j] * yj
  x = torch.zeros_like(b)
  for j in range(n - 1, -1, -1):
    t = torch.sum(cols[j] * x, dim=0, keepdim=True)
    x = x.clone()
    x[j : j + 1] = (ys[j] - t) / djs[j]
  return x


# K1


def spd_solve_plain(At: torch.Tensor, bt: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
  """Plain version of K1: A (n, n, B), b (n, B) → x (n, B)."""
  cols, djs = _chol_cols(At, eps)
  return _cho_solve_cols(cols, djs, bt)


def spd_solve_lanes(At: torch.Tensor, bt: torch.Tensor,
                    eps: float = 1e-12) -> torch.Tensor:
  """Lanes-layout batched SPD solve; A (n, n, B), b (n, B) → x (n, B).

  Only the triangle A[a][b >= a] reaches x."""
  n, B = bt.shape
  _check('b', bt, (n, B), bt)
  _check('A', At, (n, n, B), bt)
  return spd_solve_plain(At, bt, eps)


# the frozen stack takes no gradient: the solve itself
spd_solve = spd_solve_lanes


# K2: ascending dist, ties to the lowest slot index (lax.top_k order)


@functools.lru_cache(maxsize=16)
def _slot_pair(pair_struct: tuple, device: torch.device) -> torch.Tensor:
  """Static slot → pair-row map (ncon,) int32 for ((P, k, off), ...), made
  on ``device`` once."""
  out, base = [], 0
  for P, k, off in pair_struct:
    out.append(base + np.arange(P * k) // k)
    base += P
  return torch.tensor(np.concatenate(out), dtype=torch.int32, device=device)


def contact_select_plain(pair_struct: tuple, nsel: int, dist_l, feat_dyn,
                         pair_table):
  """Plain version of K2.  dist_l (ncon, B), feat_dyn (ncon, Fd, B),
  pair_table (Ptot, nst) → (sel (nsel, Fd + nst, B), picks (nsel, B)
  int32)."""
  ncon, Fd, B = feat_dyn.shape
  # ascending dist, lowest index on ties: a stable sort keeps index order
  idx = torch.sort(dist_l, dim=0, stable=True).indices[:nsel]  # (nsel, B)
  dyn = torch.gather(
      feat_dyn, 0, idx[:, None, :].expand(nsel, Fd, B)
  )  # (nsel, Fd, B)
  pair = _slot_pair(pair_struct, idx.device).long()[idx]  # (nsel, B)
  st = pair_table[pair].permute(0, 2, 1)  # (nsel, nst, B)
  return torch.cat([dyn, st], dim=1), idx.to(torch.int32)


def contact_select_lanes(pair_struct: tuple, nsel: int, dist_l: torch.Tensor,
                         feat_dyn: torch.Tensor, pair_table: torch.Tensor):
  """Top-nsel contact selection and feature gather.

  dist_l (ncon, B); feat_dyn (ncon, Fd, B) per-slot dynamic features;
  pair_table (Ptot, nst) static per-pair columns; pair_struct = static
  ((P, k, off), ...) slot layout of the pair groups.  Returns
  (sel (nsel, Fd + nst, B): row j = features of the j-th nearest slot,
  picks (nsel, B) int32: that slot)."""
  ncon, Fd, B = feat_dyn.shape
  Ptot, nst = pair_table.shape
  _check('feat_dyn', feat_dyn, (ncon, Fd, B), dist_l)
  _check('dist_l', dist_l, (ncon, B), dist_l)
  _check('pair_table', pair_table, (Ptot, nst), dist_l)
  if sum(P * k for P, k, _ in pair_struct) != ncon:
    raise ValueError('pair_struct does not cover the ncon slots')
  if not 0 < nsel <= ncon:
    raise ValueError(f'nsel {nsel} out of range for ncon {ncon}')
  return contact_select_plain(pair_struct, nsel, dist_l, feat_dyn,
                              pair_table)


# K3 and K4: the row penalties


@functools.lru_cache(maxsize=16)
def _row_masks(kinds: tuple, device: torch.device, dtype: torch.dtype):
  """Row masks (Rs,) of the static kinds on ``device``, made once: one-sided
  rows (limits, contacts) and dof-friction rows."""
  kind_s = np.asarray(kinds)
  onesided = (kind_s == _LIMIT) | (kind_s == _CONTACT)
  fric = kind_s == _FRICTION
  return (torch.tensor(onesided, device=device, dtype=dtype),
          torch.tensor(fric, device=device, dtype=dtype))


def _penalty_se(r, D, floss, ones_m, fric_m):
  """(ŝ', ŝ'') of the piecewise row penalties, all (R, B)."""
  zero = torch.zeros((), dtype=r.dtype, device=r.device)
  grad_q = D * r
  active = (r < 0) | (ones_m <= 0)
  lim = torch.where(fric_m > 0, floss, torch.full_like(floss, 1e30))
  in_quad = torch.abs(grad_q) <= lim
  s_grad = torch.where(in_quad, grad_q, torch.sign(r) * lim)
  s_curv = torch.where(in_quad, D, zero)
  s_grad = torch.where(active, s_grad, zero)
  s_curv = torch.where(active, s_curv, zero)
  inert = (fric_m > 0) & (floss <= 0)
  return torch.where(inert, zero, s_grad), torch.where(inert, zero, s_curv)


def _penalty_cost_rows(r, D, floss, ones_m, fric_m):
  """Per-row penalty cost sᵢ(rᵢ), (R, B)."""
  zero = torch.zeros((), dtype=r.dtype, device=r.device)
  active = (r < 0) | (ones_m <= 0)
  quad = 0.5 * D * r * r
  lim = torch.where(fric_m > 0, floss, torch.full_like(floss, 1e30))
  in_quad = torch.abs(D * r) <= lim
  tail = floss * torch.abs(r) - 0.5 * floss * floss / torch.clamp(D, min=1e-12)
  cost = torch.where(in_quad, quad, tail)
  cost = torch.where(active, cost, zero)
  return torch.where((fric_m > 0) & (floss <= 0), zero, cost)


def newton_pyr_plain(iterations: int, ls_iterations: int, kind_s, Mt, a0t,
                     x0t, Js, arefs, Ds, fls, U, arefU, Dc, naxes: int):
  """Plain version of K3; same arguments and outputs as
  :func:`newton_lanes_pyr_t`."""
  nv, Rs, B = Js.shape
  C = Dc.shape[0]
  dev = Mt.device
  ones_m, fric_m = _row_masks(tuple(np.asarray(kind_s).tolist()), dev,
                              Mt.dtype)
  ones_m, fric_m = ones_m[:, None], fric_m[:, None]
  eye = torch.eye(nv, dtype=Mt.dtype, device=dev)[:, :, None]
  tril = torch.tril(torch.ones(nv, nv, dtype=torch.bool, device=dev))

  mv = lambda A, v: torch.sum(A * v[:, None, :], dim=0)  # (nv,R,B),(nv,B)
  mvT = lambda A, s: torch.sum(A * s[None, :, :], dim=1)  # → (nv, B)
  matvec_M = lambda v: torch.sum(Mt * v[None, :, :], dim=1)
  bsum = lambda a: torch.sum(a, dim=0, keepdim=True)

  def con_se(r):
    act = (r < 0).to(r.dtype)
    return Dc * r * act, Dc * act

  blk = lambda a, k: a[k * C : (k + 1) * C]
  x = x0t
  rs = mv(Js, x) - arefs
  rU = mv(U, x) - arefU

  for _ in range(iterations):
    sg_s, sc_s = _penalty_se(rs, Ds, fls, ones_m, fric_m)
    rho_n = blk(rU, 0)
    sgp, sgm, scp, scm = [], [], [], []
    for i in range(naxes):
      rho_i = blk(rU, 1 + i)
      g, c = con_se(rho_n + rho_i)
      sgp.append(g)
      scp.append(c)
      g, c = con_se(rho_n - rho_i)
      sgm.append(g)
      scm.append(c)
    w = torch.cat([sum(p + q for p, q in zip(sgp, sgm))]
                  + [p - q for p, q in zip(sgp, sgm)], dim=0)
    xa = x - a0t
    grad = matvec_M(xa) + mvT(Js, sg_s) + mvT(U, w)

    S00 = sum(p + q for p, q in zip(scp, scm))
    Un = U[:, 0:C]
    Wn = S00[None] * Un
    Wi = []
    for i in range(naxes):
      Ui = U[:, (1 + i) * C : (2 + i) * C]
      S0i = scp[i] - scm[i]
      Sii = scp[i] + scm[i]
      Wn = Wn + S0i[None] * Ui
      Wi.append(S0i[None] * Un + Sii[None] * Ui)
    Wmat = torch.cat([Wn] + Wi, dim=1)  # (nv, NU, B)
    # H[a, b] = Σ_r J[a,r] c_r J[b,r] + Σ_k W[a,k] U[b,k], taken from the
    # lower triangle (b ≥ a) and mirrored as the TPU kernel does
    P_s = Js * sc_s[None]
    T = (torch.einsum('arb,crb->acb', Js, P_s)
         + torch.einsum('akb,ckb->acb', Wmat, U))
    T = torch.where(tril.T[:, :, None], T, torch.zeros_like(T))
    H = T + T.transpose(0, 1) - eye * T + Mt
    dmax = torch.amax(H * eye, dim=(0, 1), keepdim=True)
    H = H + eye * (1e-6 * dmax + 1e-12)
    cols, djs = _chol_cols(H, 1e-12)
    dx = -_cho_solve_cols(cols, djs, grad)

    mdx = matvec_M(dx)
    jdx_s = mv(Js, dx)
    u = mv(U, dx)
    un = u[0:C]
    g0 = bsum(xa * mdx)
    h0 = bsum(dx * mdx)
    t = torch.ones_like(g0)
    for _ in range(ls_iterations):
      sg, sc = _penalty_se(rs + t * jdx_s, Ds, fls, ones_m, fric_m)
      dphi = g0 + t * h0 + bsum(sg * jdx_s)
      ddphi = h0 + bsum(sc * jdx_s * jdx_s)
      rtn = rho_n + t * un
      for i in range(naxes):
        ui = blk(u, 1 + i)
        rti = blk(rU, 1 + i) + t * ui
        jp, jm = un + ui, un - ui
        gp, cp = con_se(rtn + rti)
        gm, cm = con_se(rtn - rti)
        dphi = dphi + bsum(gp * jp + gm * jm)
        ddphi = ddphi + bsum(cp * jp * jp + cm * jm * jm)
      t = torch.clamp(t - dphi / torch.clamp(ddphi, min=1e-12), 0.0, 4.0)

    s_old = bsum(_penalty_cost_rows(rs, Ds, fls, ones_m, fric_m))
    s_new = bsum(_penalty_cost_rows(rs + t * jdx_s, Ds, fls, ones_m, fric_m))
    rtn = rho_n + t * un
    for i in range(naxes):
      ui = blk(u, 1 + i)
      rho_i = blk(rU, 1 + i)
      rti = rho_i + t * ui
      for r_old, r_new in ((rho_n + rho_i, rtn + rti),
                           (rho_n - rho_i, rtn - rti)):
        s_old = s_old + bsum(0.5 * Dc * r_old * r_old * (r_old < 0))
        s_new = s_new + bsum(0.5 * Dc * r_new * r_new * (r_new < 0))
    accept = (t * g0 + 0.5 * t * t * h0 + s_new - s_old) < 0
    x = torch.where(accept, x + t * dx, x)
    rs = torch.where(accept, rs + t * jdx_s, rs)
    rU = torch.where(accept, rU + t * u, rU)

  sg_s, _ = _penalty_se(rs, Ds, fls, ones_m, fric_m)
  rho_n = blk(rU, 0)
  fc_parts = []
  wf_n = torch.zeros_like(rho_n)
  wf_parts = []
  for i in range(naxes):
    rho_i = blk(rU, 1 + i)
    gp, _ = con_se(rho_n + rho_i)
    gm, _ = con_se(rho_n - rho_i)
    fc_parts += [-gp, -gm]
    wf_n = wf_n + (-gp) + (-gm)
    wf_parts.append((-gp) - (-gm))
  fs = -sg_s
  qf = mvT(Js, fs) + mvT(U, torch.cat([wf_n] + wf_parts, dim=0))
  fc = torch.stack(fc_parts, dim=0).reshape(naxes, 2, C, B)
  return x, _force_rows(fs, fc), qf


def _force_rows(fs, fc):
  """Structured forces (Rs, B) and contact forces grouped [axis, ±,
  contact] (naxes, 2, C, B) → rows [structured | contact, axis, ±]."""
  naxes, _, C, B = fc.shape
  fc = fc.permute(2, 0, 1, 3).reshape(C * 2 * naxes, B)
  return torch.cat([fs, fc], dim=0)


def newton_lanes_pyr_t(iterations: int, ls_iterations: int,
                       kind_s: np.ndarray, Mt, a0t, x0t, Js, arefs, Ds, fls,
                       U, arefU, Dc, naxes: int):
  """Pyramid-basis fixed-iteration Newton solve on lanes-layout inputs.

  Mt (nv, nv, B), a0t/x0t (nv, B); structured rows Js (nv, Rs, B) with
  arefs/Ds/fls (Rs, B) and static kinds ``kind_s`` (Rs,); contact basis
  U (nv, (naxes+1)·C, B) grouped [Jn | μ₁A₁ | …], arefU likewise, Dc (C, B).
  Returns (x (nv, B), force (Rs + 2·naxes·C, B) in row order
  [structured | contact, axis, ±], qfrc (nv, B))."""
  nv, Rs, B = Js.shape
  C = Dc.shape[0]
  NU = (naxes + 1) * C
  for name, t, shape in (
      ('Mt', Mt, (nv, nv, B)), ('a0t', a0t, (nv, B)), ('x0t', x0t, (nv, B)),
      ('Js', Js, (nv, Rs, B)), ('arefs', arefs, (Rs, B)), ('Ds', Ds, (Rs, B)),
      ('fls', fls, (Rs, B)), ('U', U, (nv, NU, B)), ('arefU', arefU, (NU, B)),
      ('Dc', Dc, (C, B))):
    _check(name, t, shape, Mt)
  if len(kind_s) != Rs:
    raise ValueError(f'kind_s has {len(kind_s)} rows, Js has {Rs}')
  return newton_pyr_plain(iterations, ls_iterations, kind_s, Mt, a0t, x0t,
                          Js, arefs, Ds, fls, U, arefU, Dc, naxes)


def newton_generic_plain(kind, iterations: int, ls_iterations: int, Mt, a0t,
                         x0t, Jt, areft, Dt, flt):
  """Plain version of K4; same arguments and outputs as
  :func:`_newton_lanes_core`."""
  nv, R, B = Jt.shape
  dev = Mt.device
  ones_m, fric_m = _row_masks(tuple(np.asarray(kind).tolist()), dev, Mt.dtype)
  ones_m, fric_m = ones_m[:, None], fric_m[:, None]
  eye = torch.eye(nv, dtype=Mt.dtype, device=dev)[:, :, None]
  tril = torch.tril(torch.ones(nv, nv, dtype=torch.bool, device=dev))

  matvec_J = lambda v: torch.sum(Jt * v[:, None, :], dim=0)  # → (R, B)
  matvec_Jt = lambda s: torch.sum(Jt * s[None, :, :], dim=1)  # → (nv, B)
  matvec_M = lambda v: torch.sum(Mt * v[None, :, :], dim=1)
  bsum = lambda a: torch.sum(a, dim=0, keepdim=True)

  x = x0t
  r = matvec_J(x) - areft
  for _ in range(iterations):
    s_grad, s_curv = _penalty_se(r, Dt, flt, ones_m, fric_m)
    xa = x - a0t
    grad = matvec_M(xa) + matvec_Jt(s_grad)
    # H = M + Jᵀ diag(s″) J, from the triangle b ≥ a, mirrored
    T = torch.einsum('arb,crb->acb', Jt, Jt * s_curv[None])
    T = torch.where(tril.T[:, :, None], T, torch.zeros_like(T))
    H = T + T.transpose(0, 1) - eye * T + Mt
    dmax = torch.amax(H * eye, dim=(0, 1), keepdim=True)
    H = H + eye * (1e-6 * dmax + 1e-12)
    cols, djs = _chol_cols(H, 1e-12)
    dx = -_cho_solve_cols(cols, djs, grad)

    mdx = matvec_M(dx)
    jdx = matvec_J(dx)
    g0 = bsum(xa * mdx)
    h0 = bsum(dx * mdx)
    t = torch.ones_like(g0)
    for _ in range(ls_iterations):
      sg, sc = _penalty_se(r + t * jdx, Dt, flt, ones_m, fric_m)
      dphi = g0 + t * h0 + bsum(sg * jdx)
      ddphi = h0 + bsum(sc * jdx * jdx)
      t = torch.clamp(t - dphi / torch.clamp(ddphi, min=1e-12), 0.0, 4.0)
    s_old = bsum(_penalty_cost_rows(r, Dt, flt, ones_m, fric_m))
    s_new = bsum(_penalty_cost_rows(r + t * jdx, Dt, flt, ones_m, fric_m))
    accept = (t * g0 + 0.5 * t * t * h0 + s_new - s_old) < 0
    x = torch.where(accept, x + t * dx, x)
    r = torch.where(accept, r + t * jdx, r)

  s_grad, _ = _penalty_se(r, Dt, flt, ones_m, fric_m)
  force = -s_grad
  return x, force, matvec_Jt(force)


def _newton_lanes_core(kind: np.ndarray, iterations: int, ls_iterations: int,
                       Mt, a0t, x0t, Jt, areft, Dt, flt):
  """Generic-row fixed-iteration Newton solve on lanes-layout inputs.

  Mt (nv, nv, B), a0t/x0t (nv, B), Jt (nv, R, B), areft/Dt/flt (R, B), with
  static row kinds ``kind`` (R,).  Returns (x (nv, B), force (R, B),
  qfrc (nv, B))."""
  nv, R, B = Jt.shape
  for name, t, shape in (
      ('Mt', Mt, (nv, nv, B)), ('a0t', a0t, (nv, B)), ('x0t', x0t, (nv, B)),
      ('Jt', Jt, (nv, R, B)), ('areft', areft, (R, B)), ('Dt', Dt, (R, B)),
      ('flt', flt, (R, B))):
    _check(name, t, shape, Mt)
  if len(kind) != R:
    raise ValueError(f'kind has {len(kind)} rows, Jt has {R}')
  return newton_generic_plain(kind, iterations, ls_iterations, Mt, a0t, x0t,
                              Jt, areft, Dt, flt)
