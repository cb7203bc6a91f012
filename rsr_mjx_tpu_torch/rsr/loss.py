"""The RSR transition-distribution penalty.

Counterpart of ``rsr_mjx_tpu/rsr/loss.py``.  The penalty is a fixed gain,
the KL divergence between the real and the previous-sim transition
densities, times the 1-D Wasserstein distance between the density of the
current-sim transitions augmented with the online policy transitions and
the density of the current-sim transitions alone; every density is a
Gaussian KDE evaluated on a grid (``rsr.distribution``).

What depends only on the fixed datasets is computed once, in
:func:`build_rsr_data`: the per-grid-point log-sum of the anchor kernels
and the target CDF.  A loss evaluation then computes only the (grid ×
batch) kernel block and merges it with one ``logaddexp``; the softmax is
shift-invariant, so the dropped −log(N) normalizer changes nothing.

The online actions must come from the policy being optimized (the mode
action of the current policy in the PPO loss): replayed actions make the
penalty constant in the policy parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rsr_mjx_tpu_torch.rsr import distribution as dp


@dataclasses.dataclass(frozen=True)
class RSRData:
  """Everything the penalty needs that does not depend on online data:
  tensors on one device, and three static values."""

  weight: torch.Tensor  # KL(real ‖ previous-sim): the fixed penalty gain
  grid: torch.Tensor  # (M, D) KDE evaluation points
  grid_sq: torch.Tensor  # (M,) ‖grid‖² rows
  anchor_logsum: torch.Tensor  # (M,) logsumexp of the anchor kernels
  target_cdf: torch.Tensor  # (M,) CDF of the current-sim anchor density
  n_anchors: int  # anchor count
  width: int  # transition width: obs + act + next obs
  bandwidth: float  # Gaussian kernel bandwidth

  def to(self, device=None, dtype=None) -> 'RSRData':
    """The same data with every tensor on ``device`` in ``dtype``."""
    return dataclasses.replace(self, **{
        f.name: getattr(self, f.name).to(device, dtype)
        for f in dataclasses.fields(self)
        if isinstance(getattr(self, f.name), torch.Tensor)})


def make_grid(num_samples: int, dimension: int, min_value: float = -3.0,
              max_value: float = 3.0, seed: int = 0,
              device='cuda') -> torch.Tensor:
  """A uniform float32 grid on [min_value, max_value)^dimension drawn from
  a CPU ``torch.Generator`` seeded with ``seed``, so that it is the same on
  every device, then moved to ``device``.  It differs from the JAX
  package's grid, which ``jax.random.PRNGKey(seed)`` draws; hand that one
  to ``build_rsr_data(grid=...)`` to reproduce a JAX penalty."""
  gen = torch.Generator().manual_seed(seed)
  u = torch.rand((num_samples, dimension), generator=gen)
  return (min_value + (max_value - min_value) * u).to(device)


def _log_kernel_block(grid: torch.Tensor, grid_sq: torch.Tensor,
                      points: torch.Tensor, bandwidth: float) -> torch.Tensor:
  """(M, B) Gaussian log-kernels between the grid rows and point rows."""
  pts_sq = torch.sum(points * points, dim=-1)
  sq = grid_sq[:, None] - 2.0 * dp.cross(grid, points) + pts_sq[None, :]
  return -0.5 * sq / (bandwidth * bandwidth)


def _require_matrix(name: str, arr: torch.Tensor,
                    like: Optional[torch.Tensor]) -> None:
  if arr.ndim != 2:
    raise ValueError(f'{name}: expected a (transitions, width) matrix, '
                     f'got shape {tuple(arr.shape)}')
  if like is not None and arr.shape != like.shape:
    raise ValueError(f'{name}: shape {tuple(arr.shape)} does not match the '
                     f'real dataset shape {tuple(like.shape)}')


def as_tensor(x, device) -> torch.Tensor:
  """A tensor as it is (moved to ``device``), anything else as float32 on
  ``device``, as ``jnp.asarray`` makes float32 of float64 data."""
  if isinstance(x, torch.Tensor):
    return x.to(device)
  return torch.tensor(np.asarray(x, np.float32), device=device)


def build_rsr_data(real_data, previous_sim_data, current_sim_data, *,
                   num_samples: int = 10, min_value: float = -3.0,
                   max_value: float = 3.0, bandwidth: float = 0.1,
                   seed: int = 0, grid=None, device=None) -> RSRData:
  """Precompute the penalty state from the three fixed transition sets.

  ``real_data`` / ``previous_sim_data`` fix the KL gain; the
  ``current_sim_data`` rows become the KDE anchors that the online
  transitions are merged into.  All three are (N, obs + act + next obs)
  matrices of one shape.  ``device`` defaults to that of ``real_data``
  when it is a tensor, else ``'cuda'``; the computation runs in the dtype
  of the data.  ``grid`` (M, D), when given, replaces ``make_grid``'s
  (``num_samples``, ``min_value``, ``max_value`` and ``seed`` then go
  unused).
  """
  if device is None:
    device = (real_data.device if isinstance(real_data, torch.Tensor)
              else 'cuda')
  real_data = as_tensor(real_data, device)
  previous_sim_data = as_tensor(previous_sim_data, device)
  current_sim_data = as_tensor(current_sim_data, device)
  _require_matrix('real_data', real_data, None)
  _require_matrix('previous_sim_data', previous_sim_data, real_data)
  _require_matrix('current_sim_data', current_sim_data, real_data)
  if num_samples <= 0:
    raise ValueError(f'num_samples must be positive, got {num_samples}')
  if bandwidth <= 0:
    raise ValueError(f'bandwidth must be positive, got {bandwidth}')

  n_anchors, width = current_sim_data.shape
  if grid is None:
    grid = make_grid(num_samples, width, min_value=min_value,
                     max_value=max_value, seed=seed, device=device)
  grid = as_tensor(grid, device).to(real_data.dtype)
  if grid.ndim != 2 or grid.shape[1] != width:
    raise ValueError(f'grid: expected (points, {width}), got shape '
                     f'{tuple(grid.shape)}')
  grid_sq = torch.sum(grid * grid, dim=-1)

  weight = dp.kl_divergence(
      dp.evaluate_kde(real_data, grid, bandwidth),
      dp.evaluate_kde(previous_sim_data, grid, bandwidth),
  )
  anchor_density = dp.evaluate_kde(current_sim_data, grid, bandwidth)
  anchor_logsum = torch.logsumexp(
      _log_kernel_block(grid, grid_sq, current_sim_data, bandwidth), dim=-1)
  return RSRData(
      weight=weight,
      grid=grid,
      grid_sq=grid_sq,
      anchor_logsum=anchor_logsum,
      target_cdf=torch.cumsum(anchor_density, dim=-1),
      n_anchors=int(n_anchors),
      width=int(width),
      bandwidth=bandwidth,
  )


def compute_rsr_loss(observations: torch.Tensor, policy_actions: torch.Tensor,
                     next_observations: torch.Tensor,
                     past_data: Optional[RSRData], *,
                     loss_scale: float = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Penalty = loss_scale · KL(real‖prev-sim) · W(anchors+online, anchors).

  The three online tensors may carry any leading batch/time dims; rows
  are flattened into one transition batch.  ``past_data=None`` or
  ``loss_scale == 0`` gives zeros, so trainers can keep the penalty as an
  always-present term.  Returns ``(scaled_loss, distribution_distance)``.
  """
  if past_data is None or loss_scale == 0.0:
    zero = torch.zeros((), dtype=observations.dtype,
                       device=observations.device)
    return zero, zero
  if not isinstance(past_data, RSRData):
    raise TypeError(
        f'past_data must be RSRData or None, got {type(past_data)!r}; '
        'build it with rsr.build_rsr_data / rsr.pipeline.build_policy_rsr_data'
    )

  online = torch.cat(
      [torch.reshape(x, (-1, x.shape[-1]))
       for x in (observations, policy_actions, next_observations)],
      dim=-1,
  )
  if online.shape[-1] != past_data.width:
    raise ValueError(
        f'online transitions are {online.shape[-1]}-wide but the RSR '
        f'anchors were built {past_data.width}-wide — the policy obs/act '
        'layout must match the datasets the penalty was built from'
    )

  online_logsum = torch.logsumexp(
      _log_kernel_block(past_data.grid, past_data.grid_sq, online,
                        past_data.bandwidth),
      dim=-1,
  )
  # density of the anchor ∪ online set on the grid; the softmax is
  # invariant to the dropped −log(n_anchors + B) normalizer
  density = torch.softmax(
      torch.logaddexp(past_data.anchor_logsum, online_logsum), dim=-1)
  distance = torch.sum(dp.jax_abs(torch.cumsum(density, dim=-1)
                                  - past_data.target_cdf))
  penalty = loss_scale * past_data.weight
  return penalty * distance, distance
