"""Shaped-reward utilities: dm_control-style ``tolerance``.

Counterpart of ``rsr_mjx_tpu/utils/reward.py``: eight sigmoid shapes, 1.0
inside the bounds, a sigmoid falloff outside parameterised by (margin,
value_at_margin).  The scales are computed in the dtype of ``x``, as the
JAX function computes them in float32.
"""

from __future__ import annotations

import math

import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _sigmoids(x: torch.Tensor, value_at_1: float, sigmoid: str):
  if sigmoid in ('cosine', 'linear', 'quadratic'):
    if not 0 <= value_at_1 < 1:
      raise ValueError(
          '`value_at_1` must be nonnegative and smaller than 1, got '
          f'{value_at_1}.'
      )
  else:
    if not 0 < value_at_1 < 1:
      raise ValueError(
          f'`value_at_1` must be strictly between 0 and 1, got '
          f'{value_at_1}.'
      )
  v = torch.tensor(value_at_1, dtype=x.dtype, device=x.device)
  zero = torch.zeros_like(x)
  if sigmoid == 'gaussian':
    scale = torch.sqrt(-2 * torch.log(v))
    return torch.exp(-0.5 * (x * scale) ** 2)
  if sigmoid == 'hyperbolic':
    scale = torch.acosh(1 / v)
    return 1 / torch.cosh(x * scale)
  if sigmoid == 'long_tail':
    scale = torch.sqrt(1 / v - 1)
    return 1 / ((x * scale) ** 2 + 1)
  if sigmoid == 'reciprocal':
    scale = 1 / v - 1
    return 1 / (torch.abs(x) * scale + 1)
  if sigmoid == 'cosine':
    scale = torch.arccos(2 * v - 1) / math.pi
    scaled_x = x * scale
    return torch.where(torch.abs(scaled_x) < 1,
                       (1 + torch.cos(math.pi * scaled_x)) / 2, zero)
  if sigmoid == 'linear':
    scaled_x = x * (1 - v)
    return torch.where(torch.abs(scaled_x) < 1, 1 - scaled_x, zero)
  if sigmoid == 'quadratic':
    scaled_x = x * torch.sqrt(1 - v)
    return torch.where(torch.abs(scaled_x) < 1, 1 - scaled_x**2, zero)
  if sigmoid == 'tanh_squared':
    scale = torch.arctanh(torch.sqrt(1 - v))
    return 1 - torch.tanh(x * scale) ** 2
  raise ValueError(f'Unknown sigmoid type {sigmoid!r}.')


def tolerance(
    x,
    bounds=(0.0, 0.0),
    margin: float = 0.0,
    sigmoid: str = 'gaussian',
    value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN,
) -> torch.Tensor:
  """1.0 inside ``bounds``, sigmoid falloff outside; ``x`` a tensor or a
  number (then float32)."""
  lower, upper = bounds
  if lower > upper:
    raise ValueError('Lower bound must be <= upper bound.')
  if margin < 0:
    raise ValueError('`margin` must be non-negative.')
  x = torch.as_tensor(x)
  if not x.is_floating_point():
    x = x.to(torch.float32)
  in_bounds = torch.logical_and(lower <= x, x <= upper)
  one = torch.ones_like(x)
  if margin == 0:
    return torch.where(in_bounds, one, torch.zeros_like(x))
  d = torch.where(x < lower, lower - x, x - upper) / margin
  return torch.where(in_bounds, one, _sigmoids(d, value_at_margin, sigmoid))
