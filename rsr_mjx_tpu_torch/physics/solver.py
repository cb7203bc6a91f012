"""The constraint solve with gradients by the implicit function theorem.

Counterpart of ``rsr_mjx_tpu/physics/solver.py``: ``solve3`` (its
``_get_solver``, :197-294) as ``NewtonSolveIFT``, with ``_penalty_terms``
(:52) and ``_ift_cotangents`` (:297).  JAX's ``_penalty_cost`` (:78) is
``linalg_kernels._penalty_cost_rows`` and its ``_forces_at`` (:172) what K4
returns beside x, so neither has a copy here.  The solve minimises over
joint accelerations x

    Φ(x) = ½ (x − a₀)ᵀ M (x − a₀) + Σᵢ sᵢ(Jᵢ x − arefᵢ)

with MuJoCo's piecewise row penalties.  Forward, the generic-row Newton
kernel K4 (``linalg_kernels.newton_solve_batched``) runs the fixed schedule
kernel_iters × ls_eff from the warm start x0, as the JAX solve does under
``vmap`` on its kernel route (:235-268).  Backward, no gradient flows
through the iterations: x* solves g(x*) = M(x*−a₀) + Jᵀŝ(Jx*−aref) = 0, so
the cotangents of (M, a0, J, aref, D, floss) take one solve with
H = M + JᵀCJ (plus JAX's Tikhonov term), which is K1.  x0 gets none.

Arrays are batch-major, each env's system as JAX's per-env one with a
leading batch axis: M (B, nv, nv), a0/x0 (B, nv), J (B, R, nv),
aref/D/floss (B, R); ``kind`` the static (R,) row kinds.

The adaptive ``_newton_forward`` (:97) is not ported: no path of the port
runs it (the JAX package runs it only off its kernel route).  Under grad
mode the fused step's recomputation calls ``NewtonSolveIFT``; every other
caller takes K4 directly.
"""

from __future__ import annotations

import numpy as np
import torch

from rsr_mjx_tpu_torch.physics import linalg_kernels as _lk


def _penalty_terms(kind: np.ndarray, D, floss, r):
  """Per-row (dΦ/dr, d²Φ/dr²) of the piecewise penalties, (B, R) each: the
  kernels' plain ``_penalty_se`` with the row masks of the static kinds."""
  ones_m, fric_m = _lk._row_masks(tuple(np.asarray(kind).tolist()), r.device,
                                  r.dtype)
  return _lk._penalty_se(r, D, floss, ones_m, fric_m)


def _ift_cotangents(kind: np.ndarray, res, cts):
  """The IFT backward of the solve: cotangents of (M, a0, x0, J, aref, D,
  floss) from those of (x, force, qfrc), op for op JAX's per-env math over
  the batch.  The H solve is K1 (``spd_solve_lanes``)."""
  M, a0, J, aref, D, floss, x = res
  x_bar, F_bar, Q_bar = cts
  onesided, friction = (m > 0 for m in _lk._row_masks(
      tuple(np.asarray(kind).tolist()), x.device, x.dtype))
  zero = torch.zeros((), dtype=x.dtype, device=x.device)
  mv = lambda A, v: torch.einsum('brv,bv->br', A, v)  # J @ v
  mtv = lambda A, s: torch.einsum('brv,br->bv', A, s)  # Jᵀ s

  r = mv(J, x) - aref
  s_grad, s_curv = _penalty_terms(kind, D, floss, r)
  active = torch.where(onesided, r < 0, True)
  in_quad = torch.abs(D * r) <= torch.where(
      friction, floss, torch.full_like(floss, float('inf')))
  quad_zone = active & in_quad
  sat_fric = friction & active & ~in_quad
  r_quad = torch.where(quad_zone, r, zero)
  sign_sat = torch.where(sat_fric, torch.sign(r), zero)

  # explicit paths through Q = JᵀF and F = −ŝ(r*; D, floss)
  F = -s_grad
  F_t = F_bar + mv(J, Q_bar)  # total force cotangent
  J_bar = F[:, :, None] * Q_bar[:, None, :]  # ∂Q/∂J
  r_bar = -s_curv * F_t  # ∂F/∂r
  D_bar = -F_t * r_quad  # ∂F/∂D
  floss_bar = -F_t * sign_sat
  # r* = Jx* − aref
  J_bar = J_bar + r_bar[:, :, None] * x[:, None, :]
  aref_bar = -r_bar
  x_t = x_bar + mtv(J, r_bar)  # total solution cotangent

  # IFT path: θ̄ += −(∂g/∂θ)ᵀ H⁻¹ x̄_t
  H = M + torch.einsum('brv,br,brw->bvw', J, s_curv, J)
  # JAX's scale-aware Tikhonov term (its forward solves' fp32 hardening)
  reg = 1e-6 * torch.amax(torch.diagonal(H, dim1=1, dim2=2), dim=1) + 1e-12
  eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
  Hr = H + eye * reg[:, None, None]
  w = _lk.spd_solve_lanes(Hr.permute(1, 2, 0).contiguous(),
                          x_t.t().contiguous()).t()
  Jw = mv(J, w)
  xa = x - a0

  M_bar = -w[:, :, None] * xa[:, None, :]
  a0_bar = torch.einsum('bvw,bw->bv', M, w)
  aref_bar = aref_bar + s_curv * Jw
  J_bar = J_bar - (s_grad[:, :, None] * w[:, None, :]
                   + (s_curv * Jw)[:, :, None] * x[:, None, :])
  D_bar = D_bar - Jw * r_quad
  floss_bar = floss_bar - Jw * sign_sat
  return M_bar, a0_bar, None, J_bar, aref_bar, D_bar, floss_bar


class NewtonSolveIFT(torch.autograd.Function):
  """(x, force, qfrc_constraint) of the solve, batch-major.  Forward: K4 at
  the fixed schedule (its plain version for CPU tensors).  Backward:
  ``_ift_cotangents``."""

  @staticmethod
  def forward(ctx, kind, iterations, ls_iterations, M, a0, x0, J, aref, D,
              floss):
    x, force, qfrc = _lk.newton_solve_batched(
        kind, iterations, ls_iterations, M, a0, x0, J, aref, D, floss)
    ctx.kind = kind
    ctx.save_for_backward(M, a0, J, aref, D, floss, x)
    return x, force, qfrc

  @staticmethod
  def backward(ctx, x_bar, F_bar, Q_bar):
    grads = _ift_cotangents(ctx.kind, ctx.saved_tensors, (x_bar, F_bar, Q_bar))
    return (None, None, None) + grads

