"""Gradients of the port's solves and selection against the JAX package's.

Every JAX side runs its Pallas kernels in interpret mode (``_INTERPRET``),
the code the TPU runs; the port's kernels run as their plain versions.

1. ``SpdSolve`` (K1 both ways) against ``jax.vjp`` of ``spd_solve`` under
   ``vmap`` (n 20, B 4, seeded SPD systems), and ``gradcheck`` in float64.
2. ``NewtonSolveIFT`` (K4 forward, the implicit-function-theorem backward)
   against JAX's ``solve3`` under ``vmap``: the outputs and the six
   cotangents, on the generic-row system of a JAX cube-push reset (B 4,
   the cube resting on the table) from the JAX lanes stages.
3. The IFT backward alone in float64: the port's ``_ift_cotangents``
   against JAX's under ``jax.enable_x64`` on the same residuals and
   cotangents.
4. K2's backward against the transpose of JAX's one-hot gather.

Tolerances are grounded in the port's float64: each fp32 result must lie
as close to the port's float64 evaluation as JAX's does, within a factor 2
and a floor of 1e-5 of the output's scale (fp32 sums in other orders).
JAX's fp32 result must itself lie within 1e-5 of the output's scale of the
port's float64 (fp32 rounding: measured at most 6.3e-7), so that a term
computed wrongly in both of the port's precisions fails.  Both packages in
float64 agree to 1e-12 of the scale (measured 1.5e-15); where both are
exact gathers, equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.physics import constraint as jC
from rsr_mjx_tpu.physics import lanes_assembly as jA
from rsr_mjx_tpu.physics import lanes_kinematics as jK
from rsr_mjx_tpu.physics import lanes_smooth as jS
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.physics import solver as jsolver
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.physics import solver as psolver


def _grounded(port, jax_, ref, name, floor=1e-5):
  """|port − ref| <= 2·|jax − ref| + floor·max|ref|, elementwise; ref is the
  port's float64."""
  port, jax_, ref = (np.asarray(x, np.float64) for x in (port, jax_, ref))
  assert port.shape == jax_.shape == ref.shape, name
  tol = 2 * np.abs(jax_ - ref) + floor * np.abs(ref).max()
  worst = (np.abs(port - ref) - tol).max()
  assert worst <= 0, (name, worst, np.abs(port - ref).max(),
                      np.abs(jax_ - ref).max())


def _near_ref(jax_, ref, name, rtol=1e-5):
  """|jax − ref| <= rtol·max|ref|: JAX's fp32 result is the port's float64
  one up to fp32 rounding."""
  jax_, ref = (np.asarray(x, np.float64) for x in (jax_, ref))
  gap = np.abs(jax_ - ref).max() / np.abs(ref).max()
  assert gap <= rtol, (name, gap)


def _spd(rng, n, B):
  R = rng.normal(size=(B, n, n))
  return R @ np.swapaxes(R, 1, 2) / n + 0.1 * np.eye(n)


def test_spd_solve_backward_matches_jax(monkeypatch):
  monkeypatch.setattr(jlk, '_INTERPRET', True)
  rng = np.random.default_rng(0)
  n, B = 20, 4
  A = _spd(rng, n, B).astype(np.float32)
  b = rng.normal(size=(B, n)).astype(np.float32)
  g = rng.normal(size=(B, n)).astype(np.float32)
  xj, vjp = jax.vjp(jax.vmap(jlk.spd_solve), jnp.asarray(A), jnp.asarray(b))
  Aj, bj = vjp(jnp.asarray(g))

  def port(dtype):
    At = torch.tensor(np.ascontiguousarray(np.transpose(A, (1, 2, 0))),
                      dtype=dtype,
                      requires_grad=True)
    bt = torch.tensor(b.T.copy(), dtype=dtype, requires_grad=True)
    x = plk.spd_solve(At, bt)
    gA, gb = torch.autograd.grad(x, (At, bt),
                                 torch.tensor(g.T.copy(), dtype=dtype))
    return (x.detach().numpy().T, gA.numpy().transpose(2, 0, 1),
            gb.numpy().T)

  plk.LAUNCHES.update(dict.fromkeys(plk.LAUNCHES, 0))
  p32, p64 = port(torch.float32), port(torch.float64)
  assert not any(plk.LAUNCHES.values())  # CPU tensors: the plain version
  for name, p, j, r in zip(('x', 'A_bar', 'b_bar'), p32,
                           (xj, Aj, bj), p64):
    _grounded(p, j, r, name)


def test_spd_solve_gradcheck_float64():
  """In float64 against finite differences.  K1 reads one triangle of A, so
  the check perturbs a symmetric matrix S + Sᵀ: the analytic Ā = −w xᵀ
  (JAX's, for a full A) then matches the finite differences."""
  rng = np.random.default_rng(1)
  n, B = 6, 3
  S = torch.tensor(np.ascontiguousarray(
      np.transpose(_spd(rng, n, B), (1, 2, 0)) / 2), requires_grad=True)
  b = torch.tensor(rng.normal(size=(n, B)), requires_grad=True)
  solve = lambda S, b: plk.spd_solve(S + S.transpose(0, 1), b)
  assert torch.autograd.gradcheck(solve, (S, b))


@pytest.fixture(scope='module')
def cube_system():
  """The generic-row system (the selected contacts expanded into rows) of
  a JAX reset batch of AirbotCubePush, B 4, from the JAX lanes stages in
  interpret mode: M, a0 = qacc_smooth, x0 = the reset's qacc, J, aref, D,
  floss, batch-major, and the static row kinds."""
  B = 4
  env = jenvs.load('AirbotCubePush')
  jm = env.model
  state = jax.jit(jax.vmap(env.reset))(
      jax.random.split(jax.random.PRNGKey(0), B))
  d = state.data
  saved = jlk._INTERPRET
  jlk._INTERPRET = True
  try:
    lanes = lambda x: jnp.moveaxis(x, 0, -1)
    expand = lambda x: x[..., None]
    kl = jK.gather_kin(jm, d)
    kl = jK.KinLeaves(lanes(kl.qpos), *(expand(x) for x in kl[1:]))
    kout = jax.jit(lambda kl: jK.kinematics_lanes(jm, kl))(kl)
    sl = jS.gather_smooth(jm, d)
    batched = ('qpos', 'qvel', 'ctrl', 'qfrc_applied', 'xfrc_applied')
    sl = jS.SmoothLeaves(*(
        lanes(x) if f in batched else expand(x)
        for f, x in zip(jS.SmoothLeaves._fields, sl)
    ))._replace(cdof=kout.cdof, cdof_anchor=kout.cdof_anchor,
                ximat=kout.ximat, xipos=kout.xipos,
                subtree_com=kout.subtree_com)
    sout = jax.jit(lambda sl: jS.smooth_lanes(jm, sl))(sl)
    dyn = dict(qpos=sl.qpos, qvel=sl.qvel, cdof=kout.cdof,
               cdof_anchor=kout.cdof_anchor, geom_xpos=kout.geom_xpos,
               geom_xmat=kout.geom_xmat)
    keep = ('hfield_data', 'geom_size', 'con_friction', 'con_solref',
            'con_solimp', 'con_invweight')
    lv = jC.AssembleLeaves(*(
        dyn[f] if f in dyn
        else x if f in keep else jnp.broadcast_to(x, (B,) + x.shape)
        for f, x in zip(jC.AssembleLeaves._fields, jC.gather_leaves(jm, d))
    ))
    J_l, aref_l, D_l, fl_l, _ = jax.jit(
        lambda lv: jA.assemble_lanes(jm, lv, dyn_lanes=True))(lv)
  finally:
    jlk._INTERPRET = saved
  bm = lambda x: np.asarray(jnp.moveaxis(x, -1, 0))
  arrays = dict(M=bm(sout[0]), a0=bm(sout[7]), x0=np.asarray(d.qacc),
                J=np.asarray(jnp.transpose(J_l, (2, 1, 0))), aref=bm(aref_l),
                D=bm(D_l), floss=bm(fl_l))
  kind = jC.layout_cached(jm).kind
  return kind, arrays, (jm.opt.iterations, jm.opt.ls_iterations)


_SOLVE_ARGS = ('M', 'a0', 'x0', 'J', 'aref', 'D', 'floss')


def test_newton_solve_ift_matches_jax_solve3(cube_system, monkeypatch):
  kind, arr, (iterations, ls_iterations) = cube_system
  B, R, nv = arr['J'].shape
  assert (nv, R) == (20, 181)
  assert (arr['D'] > 0).any(axis=1).all()  # rows in contact in every env
  kernel_iters = max(min(iterations, 6), 1)
  ls_eff = max(min(ls_iterations, 6), 1)
  rng = np.random.default_rng(2)
  cts = (rng.normal(size=(B, nv)), rng.normal(size=(B, R)),
         rng.normal(size=(B, nv)))
  cts = tuple(c.astype(np.float32) for c in cts)

  monkeypatch.setattr(jlk, '_INTERPRET', True)
  solve3 = jsolver._get_solver(jsolver._KindKey(kind), iterations,
                               ls_iterations,
                               1e-8)
  args = tuple(jnp.asarray(arr[k]) for k in _SOLVE_ARGS)
  out_j, vjp = jax.vjp(jax.vmap(solve3), *args)
  bars_j = vjp(tuple(jnp.asarray(c) for c in cts))

  def port(dtype):
    t = [torch.tensor(arr[k], dtype=dtype) for k in _SOLVE_ARGS]
    for i, k in enumerate(_SOLVE_ARGS):
      t[i].requires_grad_(k != 'x0')
    out = psolver.NewtonSolveIFT.apply(kind, kernel_iters, ls_eff, *t)
    wrt = [x for x in t if x.requires_grad]
    bars = torch.autograd.grad(out, wrt, [torch.tensor(c, dtype=dtype)
                                          for c in cts])
    return [o.detach().numpy() for o in out], [b.numpy() for b in bars]

  out32, bars32 = port(torch.float32)
  out64, bars64 = port(torch.float64)
  for name, p, j, r in zip(('x', 'force', 'qfrc'), out32, out_j, out64):
    _grounded(p, j, r, name)
    _near_ref(j, r, name)
  names = [k for k in _SOLVE_ARGS if k != 'x0']
  jbars = [b for k, b in zip(_SOLVE_ARGS, bars_j) if k != 'x0']
  assert not np.asarray(bars_j[2]).any()  # x0: no cotangent in JAX
  for name, p, j, r in zip(names, bars32, jbars, bars64):
    assert np.abs(r).max() > 0, name
    _grounded(p, j, r, name + '_bar')
    _near_ref(j, r, name + '_bar')


def test_ift_cotangents_float64_match_jax_x64(cube_system):
  """The residuals of the port's float64 solve of the cube system (its x)
  and seeded cotangents go through both packages' IFT math in float64:
  JAX's ``_ift_cotangents`` under ``vmap`` with x64 on (its H solve on the
  XLA Cholesky), the port's on the plain K1."""
  kind, arr, (iterations, ls_iterations) = cube_system
  B, R, nv = arr['J'].shape
  t = [torch.tensor(arr[k], dtype=torch.float64) for k in _SOLVE_ARGS]
  with torch.no_grad():
    x = psolver.NewtonSolveIFT.apply(kind, max(min(iterations, 6), 1),
                                     max(min(ls_iterations, 6), 1), *t)[0]
  res = [a for k, a in zip(_SOLVE_ARGS, t) if k != 'x0'] + [x]
  rng = np.random.default_rng(5)
  cts = [rng.normal(size=(B, nv)), rng.normal(size=(B, R)),
         rng.normal(size=(B, nv))]
  port = psolver._ift_cotangents(kind, res, [torch.from_numpy(c)
                                             for c in cts])
  with jax.enable_x64(True):
    jres = tuple(jnp.asarray(a.numpy()) for a in res)
    ref = jax.vmap(lambda r, c: jsolver._ift_cotangents(kind, r, c))(
        jres, tuple(jnp.asarray(c) for c in cts))
    ref = [np.asarray(a) for a in ref]
  assert ref[0].dtype == np.float64
  assert port[2] is None and not ref[2].any()  # x0
  for name, p, j in zip(_SOLVE_ARGS, port, ref):
    if name == 'x0':
      continue
    scale = np.abs(j).max()
    assert scale > 0, name
    assert np.abs(p.numpy() - j).max() <= 1e-12 * scale, name


def test_contact_select_backward_matches_jax_onehot_transpose():
  """The slot cotangents are the cotangent rows put back where they were
  gathered (exact in both packages); the pair rows of the port's table sum
  what JAX gives the slots of each pair (and its envs), rtol 1e-6."""
  rng = np.random.default_rng(3)
  P, K, nsel, B, Fd, nst = 30, 16, 24, 4, 13, 33
  ncon = P * K
  # exact ties; + 0.0 turns the rounding's -0 into +0 (lax.top_k orders
  # -0 below +0, K2 counts them equal)
  dist = np.round(rng.uniform(-0.01, 0.3, size=(ncon, B)) * 20) / 20 + 0.0
  dist = dist.astype(np.float32)
  feat = rng.normal(size=(ncon, Fd, B)).astype(np.float32)
  table = rng.normal(size=(P, nst)).astype(np.float32)
  g = rng.normal(size=(nsel, Fd + nst, B)).astype(np.float32)
  slot_pair = np.arange(ncon) // K

  def one(dist_e, feat_e, g_e):  # one env: (ncon,), (ncon, F), (nsel, F)
    _, idx = jax.lax.top_k(-dist_e, nsel)
    onehot = (idx[:, None] == jnp.arange(ncon)).astype(jnp.float32)
    _, vjp = jax.vjp(lambda f: onehot @ f, feat_e)
    return vjp(g_e)[0]

  feat_full = np.concatenate(
      [np.moveaxis(feat, -1, 0),
       np.broadcast_to(table[slot_pair], (B, ncon, nst))], axis=-1)
  gj = np.asarray(jax.vmap(one)(jnp.asarray(dist.T), jnp.asarray(feat_full),
                                jnp.asarray(np.moveaxis(g, -1, 0))))
  f = torch.tensor(feat, requires_grad=True)
  t = torch.tensor(table, requires_grad=True)
  sel, picks = plk.contact_select_lanes(((P, K, 0),), nsel,
                                        torch.from_numpy(dist), f, t)
  gf, gt = torch.autograd.grad(sel, (f, t), torch.from_numpy(g))
  np.testing.assert_array_equal(gf.numpy(), np.moveaxis(gj[..., :Fd], 0, -1))
  pair_sum = np.zeros((P, nst), np.float64)
  np.add.at(pair_sum, slot_pair, gj[..., Fd:].sum(0))
  np.testing.assert_allclose(gt.numpy(), pair_sum, rtol=1e-6,
                             atol=1e-6 * np.abs(pair_sum).max())
  # the backward's own function on the kernel's picks gives the same
  gf2, gt2 = plk.contact_select_backward(((P, K, 0),), picks,
                                         torch.from_numpy(g), ncon, Fd, P)
  assert torch.equal(gf2, gf) and torch.equal(gt2, gt)
  assert picks.dtype == torch.int32 and tuple(picks.shape) == (nsel, B)
