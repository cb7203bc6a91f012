"""Distribution-matching primitives of the RSR penalty.

Counterpart of ``rsr_mjx_tpu/rsr/distribution.py``: a Gaussian-kernel KDE
evaluated on a grid in log space (logsumexp, then a softmax over the grid),
the discrete KL divergence and the 1-D Wasserstein distance by cumulative
sums.  The squared distances are expanded as ‖g‖² − 2·g·xᵀ + ‖x‖², so the
cross term is one matmul, run in true fp32 (TF32 off), as the JAX package
runs it at matmul precision 'highest'.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def cross(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
  """grid @ points.T with TF32 off."""
  torch.backends.cuda.matmul.allow_tf32 = False
  return grid @ points.T


def jax_abs(x: torch.Tensor) -> torch.Tensor:
  """|x| whose gradient at an exact zero is +1, as JAX's:
  ``jax.grad(jnp.abs)(0.) == 1``, where ``torch.abs`` gives 0.  The
  Wasserstein sum has such zeros wherever the densities saturate."""
  return torch.where(x >= 0, x, -x)


def evaluate_kde(data: torch.Tensor, grid: torch.Tensor,
                 bandwidth: float = 0.1) -> torch.Tensor:
  """Normalized KDE probabilities of ``data`` (N, D) on ``grid`` (M, D)."""
  g2 = torch.sum(grid * grid, dim=-1, keepdim=True)  # (M, 1)
  x2 = torch.sum(data * data, dim=-1)[None, :]  # (1, N)
  sq = g2 - 2.0 * cross(grid, data) + x2
  log_kernel_vals = -sq / (2.0 * bandwidth**2)
  log_pdf = (torch.logsumexp(log_kernel_vals, dim=-1)
             - math.log(data.shape[0]))
  return torch.softmax(log_pdf, dim=-1)


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
  """Discrete KL divergence."""
  return torch.sum(p * torch.log((p + 1e-10) / (q + 1e-10)))


def wasserstein_distance(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
  """1-D Wasserstein distance, Σ|cumsum(p) − cumsum(q)|."""
  return torch.sum(jax_abs(torch.cumsum(p, dim=-1) - torch.cumsum(q, dim=-1)))


def load_dataset_from_path(path):
  """(states, actions, next_states) numpy arrays from an npz file."""
  loaded = np.load(path, allow_pickle=True)
  return (
      np.array(loaded['states']),
      np.array(loaded['actions']),
      np.array(loaded['next_states']),
  )
