"""What the port's CPU tests share (``tests/test_torch_*.py`` import it as
``torch_testing``).

``one_thread``: every port test file runs under it, through
``pytestmark = pytest.mark.usefixtures('one_thread')``.  ``child_env``:
the environment of a Python subprocess a port test starts, on one thread
as well.

The CPU stand-ins of ``utils/cuda_graphs``, for the tests of the two
graphed regions (``physics/graphed.py``, ``train/graphed_sgd.py``):
``emulate_cuda_graphs(monkeypatch, leaves)`` puts them in place; each
test file patches its own module's ``_on_card`` on top.  A capture runs
the function once, and a replay (``Rerun``) runs it again and writes its
outputs where the capture left them, as a graph's kernels do.
``HostOps`` records what a capture would refuse in an eager call.

This module imports no JAX, so the card tests of those files run where
there is a card and no JAX."""

import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rsr_mjx_tpu_torch.utils import cuda_graphs


@pytest.fixture(scope='module')
def one_thread():
  """One intra-op thread for a test file, the count restored after it, so
  that the JAX tests a worker runs next run as before.  At the tests'
  sizes torch's threads only spin, which costs little alone (on an 8-core
  CPU, a CPU training run took 14.3 s of CPU time on one thread, 44.7 s on
  eight, in the same wall time) but stalls the run under the suite's
  other workers."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def child_env(**extra) -> dict:
  """This process's environment for a Python subprocess, with
  ``OMP_NUM_THREADS=1`` (torch's intra-op threads, as ``one_thread``) and
  ``extra`` on top."""
  return dict(os.environ, OMP_NUM_THREADS='1', **extra)


class Rerun:
  """A CUDA graph's stand-in on the CPU: ``replay`` runs the captured
  function again and copies its outputs into the tensors the capture
  returned (``leaves`` of the outputs lists them)."""

  def __init__(self, fn, out, leaves):
    self.fn, self.out, self.leaves = fn, out, leaves

  def replay(self):
    for o, n in zip(self.leaves(self.out), self.leaves(self.fn())):
      if o is not n:
        o.copy_(n)


def emulate_cuda_graphs(monkeypatch, leaves=tuple):
  """``utils/cuda_graphs``' CUDA calls replaced by their CPU stand-ins: no
  pool, no side stream, and a capture that returns a ``Rerun``."""

  def capture(fn, pool, stream):
    out = fn()
    return Rerun(fn, out, leaves), out

  monkeypatch.setattr(cuda_graphs, 'new_pool', lambda: None)
  monkeypatch.setattr(cuda_graphs, 'side_stream', lambda device: None)
  monkeypatch.setattr(cuda_graphs, 'on_stream', lambda stream, fn: fn())
  monkeypatch.setattr(cuda_graphs, 'capture', capture)


_HOST = ('aten._local_scalar_dense.default', 'aten.nonzero.default',
         'aten.lift_fresh.default', 'aten.lift_fresh_copy.default')


class HostOps(TorchDispatchMode):
  """Records the operations that read a device value on the host or make a
  tensor of host data (on a card: a copy from pageable memory).  A 0-dim
  tensor of a Python number is left out: on a card it is a fill."""

  def __init__(self):
    super().__init__()
    self.seen = []

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    if str(func) in _HOST and not (str(func).startswith('aten.lift')
                                   and args[0].dim() == 0):
      self.seen.append(str(func))
    return out
