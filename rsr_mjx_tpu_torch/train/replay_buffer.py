"""Uniform-sampling ring replay buffer on the trainer's device.

Counterpart of ``rsr_mjx_tpu/train/replay_buffer.py``: a tree (a
``Transition``, dicts, tuples) of ``(capacity, ...)`` tensors.  ``insert``
writes a batch at ``(insert_position + arange(B)) % capacity`` with one
``index_copy_`` per leaf, so a batch that straddles the end wraps;
``sample`` draws indices uniformly with replacement from the filled region
and ``gather`` reads them.  The position and size are Python ints: no
step copies anything to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from rsr_mjx_tpu_torch.envs.wrappers import tree_map


@dataclasses.dataclass
class ReplayBufferState:
  data: Any  # tree of (capacity, ...) tensors
  insert_position: int
  size: int

  @property
  def capacity(self) -> int:
    return _first_leaf(self.data).shape[0]


def _first_leaf(tree):
  leaves = []
  tree_map(lambda x: leaves.append(x), tree)
  return leaves[0]


def init(capacity: int, dummy_item: Any) -> ReplayBufferState:
  """Allocate a zeroed buffer shaped like ``dummy_item`` (one item, no
  leading axis), each leaf with the item's dtype and device."""
  data = tree_map(
      lambda x: torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                            device=x.device), dummy_item)
  return ReplayBufferState(data=data, insert_position=0, size=0)


def insert(state: ReplayBufferState, batch: Any) -> ReplayBufferState:
  """Write ``batch`` (leading axis B, the buffer's tree) circularly; the
  buffer's tensors are written in place."""
  capacity = state.capacity
  b = _first_leaf(batch).shape[0]
  idx = (state.insert_position + torch.arange(
      b, device=_first_leaf(state.data).device)) % capacity
  tree_map(lambda buf, x: buf.index_copy_(0, idx, x.to(buf.dtype)),
           state.data, batch)
  return ReplayBufferState(data=state.data,
                           insert_position=(state.insert_position + b)
                           % capacity,
                           size=min(state.size + b, capacity))


def gather(state: ReplayBufferState, idx: torch.Tensor) -> Any:
  """The items at ``idx`` (a 1-D index tensor on the buffer's device)."""
  return tree_map(lambda buf: buf.index_select(0, idx), state.data)


def sample(state: ReplayBufferState, num_samples: int,
           generator: torch.Generator) -> Any:
  """``num_samples`` items drawn uniformly with replacement from the
  filled region, indices from ``generator`` (on the buffer's device)."""
  idx = torch.randint(0, max(state.size, 1), (num_samples,),
                      generator=generator, device=generator.device)
  return gather(state, idx)
