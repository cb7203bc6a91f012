"""The fused forward chain of one physics step over a batch of envs.

Counterpart of the batched lanes route of ``rsr_mjx_tpu/physics/
fwd_fused.py`` (:230-295):

  kinematics → com_vel … fwd_velocity (ends in K1) → narrow phase
  → assembly → Newton solve → per-env finite containment
  → (M + h·D)⁻¹ implicit solve (K1)

The solve takes one of two routes, as the JAX ``_build`` decides
(:98-103).  A model with top-k contact selection and condim ≥ 2 (cube-push)
assembles the contact basis through the selection kernel K2 and solves with
the pyramid-basis kernel K3.  Every other model (the Go2 family, which sets
no selection) expands its contacts into generic rows and solves with K4
(``_newton_lanes_core``).  ``basis=False`` sends a basis-capable model down
the generic route too (what the JAX package does under
``RSR_DISABLE_BASIS_KERNEL=1``).

Data arrives batch-major (B, …) and the chain runs with the batch in the
trailing axis, as the JAX lanes route does; the outputs cross back once.

Gradients: when grad mode is on and an input requires grad (a state that
depends on tuned parameters, a model leaf that does), the chain runs as
``FusedRegion``, the counterpart of JAX's ``custom_vjp`` region
(:221-320).  Its forward is the chain above with no graph kept.  Its
backward recomputes the chain from the same inputs in generic rows, as
JAX's ``fused_bwd`` differentiates its per-env ``chain`` (:113-173): the
selection through K2 and its backward, the solve as ``solver.
NewtonSolveIFT`` (K4 forward, the implicit-function-theorem backward with
K1), the finite containment, and both SPD solves through ``linalg_kernels.
spd_solve`` (K1 both ways).  So the gradient is that of the generic-row
chain at the state the step started from, not a derivative of K3.  The
recomputation runs through the lanes stages, the batched form of JAX's
per-env ``kinematics.py`` and ``smooth.py`` (held to each other by
``tests/test_fwd_fused.py``).  With no input requiring grad the chain runs
as it did: no tensor is saved and the launches are the same.
"""

from __future__ import annotations

import dataclasses

import torch

from rsr_mjx_tpu_torch.physics import constraint as _constraint
from rsr_mjx_tpu_torch.physics import lanes_assembly as _lanes
from rsr_mjx_tpu_torch.physics import lanes_kinematics as _lkin
from rsr_mjx_tpu_torch.physics import lanes_smooth as _ls
from rsr_mjx_tpu_torch.physics import linalg_kernels as _lk
from rsr_mjx_tpu_torch.physics import solver as _solver
from rsr_mjx_tpu_torch.physics import statics
from rsr_mjx_tpu_torch.physics.types import Data, IntegratorType, Model
from rsr_mjx_tpu_torch.utils import tracing

# mjDSBL_EULERDAMP: <flag eulerdamp="disable"/> makes Euler fully explicit
_DSBL_EULERDAMP = 32768


def supported(m: Model) -> bool:
  """Whether the fused chain covers model ``m``: an Euler or implicit
  integrator, at least one constraint row, and actuators the lanes smooth
  stage takes."""
  if m.opt.integrator not in (IntegratorType.EULER, IntegratorType.IMPLICIT,
                              IntegratorType.IMPLICITFAST):
    return False
  return bool(_ls.lanes_supported(m)
              and _constraint.layout_cached(m).nefc > 0)


def use_basis(m: Model) -> bool:
  """Whether ``m`` takes the contact-basis route (K2 + K3): contacts with
  top-k selection and condim >= 2."""
  return bool(m.ncon and _constraint._selection_size(m)
              and int(_constraint._condims_static(m)[0]) >= 2)


def _chain(m: Model, kl, sl, lv, x0, h, implicit: bool, basis: bool,
           grad: bool):
  """kinematics → smooth dynamics → narrow phase → assembly → solve →
  containment → implicit solve, all in lanes layout, each stage a span of
  ``utils.tracing`` (``physics.kinematics``, ``.smooth``, ``.assembly``:
  the narrow phase (``physics.collision``) and K2, ``.solve``: K3 or K4
  and the containment, ``.implicit``: the second K1).  On a card the spans fire only while
  ``graphed`` captures a substep, and in ``forward``: a replay runs none of
  this code.  ``kl``, ``sl``, ``lv`` are the stages'
  leaves (``sl`` and ``lv`` without the kinematics fields, which come from
  ``kl`` here), x0 (nv, B) the warm start, h the timestep.  ``grad``
  sends the generic-row solve through
  ``solver.NewtonSolveIFT``.  Returns the kinematics outputs, the smooth outputs,
  (x, force, qfrc, dist (B, ncon)) and, when ``implicit``, qacc_implicit,
  all lanes except dist."""
  lay = _constraint.layout_cached(m)
  kernel_iters = max(min(m.opt.iterations, 6), 1)
  ls_eff = max(min(m.opt.ls_iterations, 6), 1)
  nv, nu = m.nv, m.nu
  B = kl.qpos.shape[-1]

  with tracing.span('physics.kinematics'):
    kout = _lkin.kinematics_lanes(m, kl)
  with tracing.span('physics.smooth'):
    sl = sl._replace(cdof=kout.cdof, cdof_anchor=kout.cdof_anchor,
                     ximat=kout.ximat, xipos=kout.xipos,
                     subtree_com=kout.subtree_com)
    smooth = _ls.smooth_lanes(m, sl)
  qM_l, qsm_l, qaccsm_l = smooth[0], smooth[6], smooth[7]
  lv = lv._replace(cdof=kout.cdof, cdof_anchor=kout.cdof_anchor,
                   geom_xpos=kout.geom_xpos, geom_xmat=kout.geom_xmat)
  qM_c, a0_c = qM_l.contiguous(), qaccsm_l.contiguous()
  with tracing.span('physics.assembly'):
    if basis:
      n_struct = lay.n_eq + lay.n_fri + lay.n_lim
      (J_s, aref_s, D_s, fl_s, dist_bm, U, arefU, D_c, naxes) = (
          _lanes.assemble_lanes(m, lv, basis=True))
    else:
      J_l, aref_l, D_l, fl_l, dist_bm = _lanes.assemble_lanes(
          m, lv, basis=False)
  with tracing.span('physics.solve'):
    if basis:
      xt, force_l, qft_l = _lk.newton_lanes_pyr_t(
          kernel_iters, ls_eff, lay.kind[:n_struct], qM_c, a0_c, x0,
          J_s, aref_s, D_s, fl_s, U, arefU, D_c, naxes,
      )
    elif grad:
      x, f, q = _solver.NewtonSolveIFT.apply(
          lay.kind, kernel_iters, ls_eff, qM_c.permute(2, 0, 1), a0_c.t(),
          x0.t(), J_l.permute(2, 1, 0), aref_l.t(), D_l.t(), fl_l.t())
      xt, force_l, qft_l = x.t(), f.t(), q.t()
    else:
      xt, force_l, qft_l = _lk._newton_lanes_core(
          lay.kind, kernel_iters, ls_eff, qM_c, a0_c, x0, J_l, aref_l, D_l,
          fl_l,
      )
    # containment: an env whose solve went non-finite falls back to its
    # unconstrained acceleration (MuJoCo's mjWARN_BADQACC counterpart)
    ok = (torch.all(torch.isfinite(xt), dim=0)
          & torch.all(torch.isfinite(qft_l), dim=0))[None]
    xt = torch.where(ok, xt, qaccsm_l)
    force_l = torch.where(ok, force_l, torch.zeros_like(force_l))
    qft_l = torch.where(ok, qft_l, torch.zeros_like(qft_l))
  out = tuple(kout) + tuple(smooth) + (xt, force_l, qft_l, dist_bm)
  if not implicit:
    return out

  with tracing.span('physics.implicit'):
    euler_nodamp = (m.opt.integrator == IntegratorType.EULER
                    and bool(m.opt.disableflags & _DSBL_EULERDAMP))
    if euler_nodamp:
      return out + (xt.clone(),)
    # M + h·(diag(damping) − momentᵀ·dgain·moment); for the joint
    # transmissions admitted here the actuator term is diagonal:
    # gear²·dgain at each actuated dof
    diag = sl.dof_damping.expand(nv, B)
    if m.opt.integrator == IntegratorType.IMPLICITFAST and nu:
      dgain = sl.gainprm[:, 2] * sl.ctrl + sl.biasprm[:, 2]  # (nu, B)
      gear0 = sl.gear[:, 0]
      onehot_vu = statics.table(m, 'onehot_vu', lambda: _ls.onehot_vu(m),
                                diag.device, diag.dtype)
      diag = diag - torch.tensordot(onehot_vu, gear0 * (dgain * gear0),
                                    dims=1)
    eye = torch.eye(nv, dtype=qM_l.dtype, device=qM_l.device)[:, :, None]
    MhD = qM_l + eye * (h * diag)[:, None, :]
    qit = _lk.spd_solve(MhD.contiguous(), (qsm_l + qft_l).contiguous())
  return out + (qit,)


class FusedRegion(torch.autograd.Function):
  """The chain with JAX's ``fused_bwd`` as its backward.  Arguments:
  ``spec`` = (m, implicit, basis, len(kl), len(sl)), then the leaves of
  kl, sl and lv and (x0, h), flat (None where a kinematics field is left
  out)."""

  @staticmethod
  def forward(ctx, spec, *flat):
    ctx.set_materialize_grads(False)
    ctx.spec = spec
    ctx.save_for_backward(*flat)
    m, implicit, basis, _, _ = spec
    return _chain(m, *_unflatten(spec, flat), implicit, basis, grad=False)

  @staticmethod
  def backward(ctx, *cts):
    m, implicit, _, _, _ = ctx.spec
    needs = ctx.needs_input_grad[1:]
    inputs = [t.detach().requires_grad_(n) if t is not None else None
              for t, n in zip(ctx.saved_tensors, needs)]
    with torch.enable_grad():
      outs = _chain(m, *_unflatten(ctx.spec, inputs), implicit, basis=False,
                    grad=True)
    pairs = [(o, c) for o, c in zip(outs, cts)
             if c is not None and o.requires_grad]
    if not pairs:  # no output that reached the loss depends on the inputs
      return (None,) * (1 + len(needs))
    wrt = [t for t, n in zip(inputs, needs) if n]
    grads = iter(torch.autograd.grad(
        [o for o, _ in pairs], wrt, [c for _, c in pairs],
        allow_unused=True))
    return (None,) + tuple(next(grads) if n else None for n in needs)


def _unflatten(spec, flat):
  _, _, _, n_kl, n_sl = spec
  n_lv = len(_constraint.AssembleLeaves._fields)
  kl = _lkin.KinLeaves(*flat[:n_kl])
  sl = _ls.SmoothLeaves(*flat[n_kl : n_kl + n_sl])
  lv = _constraint.AssembleLeaves(*flat[n_kl + n_sl : n_kl + n_sl + n_lv])
  x0, h = flat[n_kl + n_sl + n_lv :]
  return kl, sl, lv, x0, h


def forward_lanes(m: Model, d: Data, implicit: bool, basis: bool = True):
  """Run the chain on batch ``d``; returns (d_filled, qacc_implicit or None).

  ``d_filled`` carries the kinematics, smooth-dynamics and constraint
  products, with qacc the constrained acceleration (what the sensors read);
  ``qacc_implicit`` is the acceleration the integrator uses (only when
  ``implicit``).  ``basis=False`` keeps a model with contact selection off
  the basis route: its selected contacts become generic rows for K4.  The
  chain runs as ``FusedRegion`` when grad mode is on and one of its inputs
  requires grad; d.qacc, the warm start, never carries a gradient (JAX's
  stop_gradient)."""
  if not supported(m):
    raise NotImplementedError(
        'the fused step covers Euler and implicit integrators, models with '
        'at least one constraint row, and joint actuators on hinge or slide '
        'joints'
    )
  basis = basis and use_basis(m)
  T = lambda a: a.movedim(0, -1)  # batch-major → lanes
  mv = lambda a: a.movedim(-1, 0)  # lanes → batch-major

  qpos_l, qvel_l = T(d.qpos), T(d.qvel)
  kl = _lkin.gather_kin(m, qpos_l)
  sl = _ls.gather_smooth(m, qpos_l, qvel_l, T(d.ctrl), T(d.qfrc_applied),
                         T(d.xfrc_applied))
  lv = _constraint.gather_leaves(m, qpos_l, qvel_l, None, None, None, None)
  x0 = T(d.qacc).detach().contiguous()
  flat = tuple(kl) + tuple(sl) + tuple(lv) + (x0, m.opt.timestep)
  if torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in flat):
    spec = (m, implicit, basis, len(kl), len(sl))
    out = FusedRegion.apply(spec, *flat)
  else:
    out = _chain(m, kl, sl, lv, x0, m.opt.timestep, implicit, basis,
                 grad=False)
  kout = _lkin.KinOut(*out[:12])
  (qM_l, cvel_l, bias_l, pass_l, af_l, qact_l, qsm_l, qaccsm_l) = out[12:20]
  xt, force_l, qft_l, dist_bm = out[20:24]
  qit = mv(out[24]) if implicit else None

  d = d.replace(
      xpos=mv(kout.xpos), xquat=mv(kout.xquat), xmat=mv(kout.xmat),
      xipos=mv(kout.xipos), ximat=mv(kout.ximat),
      geom_xpos=mv(kout.geom_xpos), geom_xmat=mv(kout.geom_xmat),
      site_xpos=mv(kout.site_xpos), site_xmat=mv(kout.site_xmat),
      subtree_com=mv(kout.subtree_com), cdof=mv(kout.cdof),
      cdof_anchor=mv(kout.cdof_anchor),
      qM=mv(qM_l), cvel=mv(cvel_l), qfrc_bias=mv(bias_l),
      qfrc_passive=mv(pass_l), actuator_force=mv(af_l),
      qfrc_actuator=mv(qact_l), qfrc_smooth=mv(qsm_l),
      qacc_smooth=mv(qaccsm_l), qacc=mv(xt), qfrc_constraint=mv(qft_l),
      efc_force=mv(force_l),
      contact=dataclasses.replace(d.contact, dist=dist_bm),
  )
  return d, qit
