"""Observation normalization statistics.

Counterpart of ``rsr_mjx_tpu/train/running_statistics.py``: the state that
a trained policy's pickle carries, its initial value, the batched Welford
update, ``normalize`` and ``denormalize``.  ``update`` takes the sum over
the processes that share the batch from its caller (the JAX
``pmap_axis_name``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass
class RunningStatisticsState:
  """count (), and mean / summed_variance / std shaped like one observation
  (numpy arrays as loaded, or tensors; for a dict observation, dicts of
  them with the observation's keys)."""

  count: Any
  mean: Any
  summed_variance: Any
  std: Any


def leaf_map(fn, *trees):
  """fn over the leaves of an array or a dict of arrays (same keys)."""
  if isinstance(trees[0], dict):
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
  return fn(*trees)


def map_state(fn, state: RunningStatisticsState) -> RunningStatisticsState:
  """fn over every array of the state (count included)."""
  return RunningStatisticsState(**{
      f.name: leaf_map(fn, getattr(state, f.name))
      for f in dataclasses.fields(state)})


def init_state(obs_size, device='cuda') -> RunningStatisticsState:
  """Zero count, mean and summed variance, unit std, float32 on ``device``;
  ``obs_size`` is an int, a shape whose last entry is the size, or a dict
  of them (a dict observation)."""

  def size(n):
    return n[-1] if isinstance(n, (tuple, list)) else n

  zeros = lambda n: torch.zeros(size(n), device=device)
  ones = lambda n: torch.ones(size(n), device=device)
  return RunningStatisticsState(
      count=torch.zeros((), device=device), mean=leaf_map(zeros, obs_size),
      summed_variance=leaf_map(zeros, obs_size),
      std=leaf_map(ones, obs_size))


def update(state: RunningStatisticsState, batch, psum=None,
           replicas: int = 1) -> RunningStatisticsState:
  """Welford update over all leading axes of every leaf of ``batch``, as the
  JAX ``update``: a float32 count, mean + Σ(x − m)/count, summed variance
  + Σ(x − m_old)(x − m_new) clamped at 0, std = sqrt(v / max(count, 1) +
  1e-6).  With ``psum`` (a sum over processes, in place) the batch is one
  process's part of one spread over ``replicas`` processes: the count
  grows by the local count times ``replicas`` and both sums go through
  ``psum`` (JAX's ``psum`` over ``pmap_axis_name``)."""
  first = next(iter(batch.values())) if isinstance(batch, dict) else batch
  local = math.prod(first.shape[:-1]) if first.ndim > 1 else 1
  psum = psum or (lambda x: x)
  count = state.count + torch.tensor(local * replicas, dtype=torch.float32,
                                     device=state.count.device)

  def mean_update(mean, x):
    return mean + psum(
        torch.sum(x.reshape(-1, x.shape[-1]) - mean, dim=0) / count)

  mean = leaf_map(mean_update, state.mean, batch)

  def var_update(var, old_mean, new_mean, x):
    flat = x.reshape(-1, x.shape[-1])
    return var + psum(torch.sum((flat - old_mean) * (flat - new_mean), dim=0))

  summed_variance = leaf_map(var_update, state.summed_variance, state.mean,
                             mean, batch)
  # Σ(x−m_old)(x−m_new) is >= 0 but can come out slightly negative in fp32
  # for a near-constant dimension; sqrt would then give NaN (the JAX
  # module's round-4 fix)
  summed_variance = leaf_map(lambda v: torch.clamp(v, min=0.0),
                             summed_variance)
  std = leaf_map(lambda v: torch.sqrt(v / torch.clamp(count, min=1.0) + 1e-6),
                 summed_variance)
  return RunningStatisticsState(count=count, mean=mean,
                                summed_variance=summed_variance, std=std)


def normalize(state: RunningStatisticsState, batch):
  """(batch − mean) / std, as the JAX ``normalize``, entry by entry for a
  dict observation."""
  return leaf_map(lambda x, m, s: (x - m) / s, batch, state.mean, state.std)


def denormalize(state: RunningStatisticsState, batch):
  """batch · std + mean."""
  return leaf_map(lambda x, m, s: x * s + m, batch, state.mean, state.std)


def to(state: RunningStatisticsState, device=None,
       dtype=None) -> RunningStatisticsState:
  """The state with every tensor moved to ``device`` / cast to ``dtype``."""
  return map_state(lambda t: t.to(device=device, dtype=dtype), state)
