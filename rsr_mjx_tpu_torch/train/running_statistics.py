"""Observation normalization statistics (inference side).

Counterpart of ``rsr_mjx_tpu/train/running_statistics.py``: the state that
a trained policy's pickle carries and ``normalize``.  The Welford update
comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class RunningStatisticsState:
  """count (), and mean / summed_variance / std shaped like one observation
  (numpy arrays as loaded, or tensors; for a dict observation, dicts of
  them with the observation's keys)."""

  count: Any
  mean: Any
  summed_variance: Any
  std: Any


def normalize(state: RunningStatisticsState, batch):
  """(batch − mean) / std, as the JAX ``normalize``, entry by entry for a
  dict observation; ``PPOPolicy`` applies the same to its buffers."""
  if isinstance(batch, dict):
    return {k: (v - state.mean[k]) / state.std[k] for k, v in batch.items()}
  return (batch - state.mean) / state.std
