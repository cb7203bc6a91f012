"""Quaternion helpers (MuJoCo conventions: quaternions are (w, x, y, z)).

Counterpart of the quaternion part of ``rsr_mjx_tpu/physics/lie.py``, with
the component axis last and any leading batch axes.  The spatial-vector
helpers of the JAX module serve its per-env reference path, which this
port does not have yet (the lanes stages keep their own copies).
"""

from __future__ import annotations

import torch


def quat_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Hamilton product u ⊗ v."""
  w1, x1, y1, z1 = u.unbind(-1)
  w2, x2, y2, z2 = v.unbind(-1)
  return torch.stack([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
  ], dim=-1)


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor):
  half = angle * 0.5
  return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]],
                   dim=-1)


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
  return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt):
  """Integrate a unit quaternion by an angular velocity in the local (child
  body) frame, as MuJoCo's free and ball joints do."""
  angle = torch.linalg.vector_norm(omega_local, dim=-1)
  safe = torch.where(angle < 1e-12, torch.ones_like(angle), angle)
  dq = axis_angle_to_quat(omega_local / safe[..., None], angle * dt)
  return normalize_quat(quat_mul(q, dq))
