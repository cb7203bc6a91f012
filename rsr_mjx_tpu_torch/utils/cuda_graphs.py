"""CUDA-graph plumbing shared by the graphed physics substep
(``physics/graphed``) and the graphed PPO minibatch step
(``train/graphed_sgd``): a side stream per device, memory pools, a capture
that leaves the allocator alone, and a keyed cache whose entries die with
the objects they belong to.

``side_stream(device)`` is the stream the first, eager call of a key and
every capture run on; ``on_stream(stream, fn)`` runs fn there, ordered
after the current stream's work and before its later work.
``capture(fn, pool, stream)`` captures fn into ``pool`` (a
``new_pool()``).  ``Cache`` holds {key: entry}, least recently used first
out; ``Cache.add`` ties an entry to its owners, held weakly.
"""

from __future__ import annotations

import collections
import weakref
from typing import Callable

import torch

_SIDE_STREAMS: dict = {}


def new_pool():
  return torch.cuda.graph_pool_handle()


def side_stream(device):
  s = _SIDE_STREAMS.get(device)
  if s is None:
    s = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
  return s


def on_stream(stream, fn: Callable):
  """fn() run on ``stream``, ordered after the current stream's work and
  before its later work."""
  main = torch.cuda.current_stream(stream.device)
  stream.wait_stream(main)
  with torch.cuda.stream(stream):
    out = fn()
  main.wait_stream(stream)
  return out


def capture(fn: Callable, pool, stream):
  """(graph, fn()'s outputs) of fn captured on ``stream`` into ``pool``.
  Unlike ``torch.cuda.graph`` it neither collects garbage nor empties the
  allocator's cache first: the pool takes what it needs."""
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.stream(stream):
    graph.capture_begin(pool=pool, capture_error_mode='thread_local')
    try:
      out = fn()
    finally:
      graph.capture_end()
  return graph, out


class Cache(collections.OrderedDict):
  """{key: entry}, least recently used first: a caller marks a use with
  ``move_to_end``, and ``add`` evicts beyond the size it is given.  An
  entry is dropped when one of its owners dies; an entry evicted frees
  what it holds (its graphs and their pool)."""

  def add(self, key, entry, owners, keep: int) -> tuple:
    """entry under key, the most recently used, with at most ``keep``
    entries left; returns weak references to ``owners``.  The entry keeps
    them: while it does, the first owner to die drops the key."""
    drop = lambda _, key=key, cache=self: cache.pop(key, None)
    refs = tuple(weakref.ref(o, drop) for o in owners)
    self[key] = entry
    self.move_to_end(key)
    while len(self) > keep:
      self.popitem(last=False)
    return refs
