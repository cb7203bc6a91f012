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

The port's gradient path (``FusedRegion`` with the implicit-function-
theorem solve of ``solver``) is left out of this copy: the reference takes
no gradient through the physics.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.frozen.physics import constraint as _constraint
from benchmark.reference.frozen.physics import lanes_assembly as _lanes
from benchmark.reference.frozen.physics import lanes_kinematics as _lkin
from benchmark.reference.frozen.physics import lanes_smooth as _ls
from benchmark.reference.frozen.physics import linalg_kernels as _lk
from benchmark.reference.frozen.physics import statics
from benchmark.reference.frozen.physics.types import Data, IntegratorType, Model

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


def _chain(m: Model, kl, sl, lv, x0, h, implicit: bool, basis: bool):
  """kinematics → smooth dynamics → narrow phase → assembly → solve →
  containment → implicit solve, all in lanes layout.  ``kl``, ``sl``,
  ``lv`` are the stages' leaves (``sl`` and ``lv`` without the kinematics
  fields, which come from ``kl`` here), x0 (nv, B) the warm start, h the
  timestep.  Returns the kinematics outputs, the smooth outputs,
  (x, force, qfrc, dist (B, ncon)) and, when ``implicit``, qacc_implicit,
  all lanes except dist."""
  lay = _constraint.layout_cached(m)
  kernel_iters = max(min(m.opt.iterations, 6), 1)
  ls_eff = max(min(m.opt.ls_iterations, 6), 1)
  nv, nu = m.nv, m.nu
  B = kl.qpos.shape[-1]

  kout = _lkin.kinematics_lanes(m, kl)
  sl = sl._replace(cdof=kout.cdof, cdof_anchor=kout.cdof_anchor,
                   ximat=kout.ximat, xipos=kout.xipos,
                   subtree_com=kout.subtree_com)
  smooth = _ls.smooth_lanes(m, sl)
  qM_l, qsm_l, qaccsm_l = smooth[0], smooth[6], smooth[7]
  lv = lv._replace(cdof=kout.cdof, cdof_anchor=kout.cdof_anchor,
                   geom_xpos=kout.geom_xpos, geom_xmat=kout.geom_xmat)
  qM_c, a0_c = qM_l.contiguous(), qaccsm_l.contiguous()
  if basis:
    n_struct = lay.n_eq + lay.n_fri + lay.n_lim
    (J_s, aref_s, D_s, fl_s, dist_bm, U, arefU, D_c, naxes) = (
        _lanes.assemble_lanes(m, lv, basis=True))
    xt, force_l, qft_l = _lk.newton_lanes_pyr_t(
        kernel_iters, ls_eff, lay.kind[:n_struct], qM_c, a0_c, x0,
        J_s, aref_s, D_s, fl_s, U, arefU, D_c, naxes,
    )
  else:
    J_l, aref_l, D_l, fl_l, dist_bm = _lanes.assemble_lanes(
        m, lv, basis=False)
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


def forward_lanes(m: Model, d: Data, implicit: bool, basis: bool = True):
  """Run the chain on batch ``d``; returns (d_filled, qacc_implicit or None).

  ``d_filled`` carries the kinematics, smooth-dynamics and constraint
  products, with qacc the constrained acceleration (what the sensors read);
  ``qacc_implicit`` is the acceleration the integrator uses (only when
  ``implicit``).  ``basis=False`` keeps a model with contact selection off
  the basis route: its selected contacts become generic rows for K4."""
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
  out = _chain(m, kl, sl, lv, x0, m.opt.timestep, implicit, basis)
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
