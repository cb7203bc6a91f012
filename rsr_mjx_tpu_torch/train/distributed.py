"""Training on several devices: one process per device, ``torch.distributed``.

Counterpart of the JAX trainers' device mesh (``shard_map`` over
``Mesh(('data',))``): each process steps ``num_envs // world`` envs and
holds a full copy of the networks; the gradients and the loss metrics are
averaged over the processes (JAX's ``pmean``) and the normalizer's counts
and sums are summed (``all_sum_``, which the trainers hand to
``running_statistics.update`` where JAX passes its ``pmap_axis_name``).
With no process group up, ``world()`` is (0, 1) and every helper leaves
its argument as it is, so a trainer runs as on one device.  With one up,
the helpers reduce whatever its size, so a group of one runs the reduction
path and gives the same bits as no group (a sum over one rank, a division
by 1).

The backend is NCCL for tensors on the card and gloo on the CPU
(``init``).  Each env's draws (its reset, its action noise and, on Go2,
every later draw of its episode) come from a ``core.RowStream`` over a
generator seeded alike on every process (``rows``), so they depend on the
env's index in the whole batch only.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Sequence, Tuple

import torch
from torch import distributed as dist

from rsr_mjx_tpu_torch.envs import core


# How long a collective waits for the other processes.  Process 0 alone
# evaluates (and checkpoints) while the others wait in the next
# collective: a full cube-push evaluation, 128 envs x 1200 steps, takes
# about 400 s on an H100 and the host's time spreads up to 1.8x, past
# NCCL's default of 10 minutes.
TIMEOUT = datetime.timedelta(hours=1)


def active() -> bool:
  """Whether a process group is up."""
  return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
  """(rank, world size) of the process group; (0, 1) when none is up."""
  if not active():
    return 0, 1
  return dist.get_rank(), dist.get_world_size()


def init(device: str = 'cuda', init_method: str = 'env://',
         rank: int | None = None, world_size: int | None = None) -> str:
  """Start the process group and return this process's device: NCCL and
  ``cuda:LOCAL_RANK`` for ``device`` 'cuda' (the card is also made the
  current one), gloo and 'cpu' for 'cpu'.  With the default
  ``init_method`` the rank, world size and address come from the
  environment ``torchrun`` sets (RANK, WORLD_SIZE, MASTER_ADDR,
  MASTER_PORT, LOCAL_RANK).  Collectives wait up to ``TIMEOUT``."""
  kind = torch.device(device).type
  if kind == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError('no CUDA device: pass --device cpu for gloo')
    device = f'cuda:{int(os.environ.get("LOCAL_RANK", 0))}'
    torch.cuda.set_device(device)
  kw = {} if rank is None else dict(rank=rank, world_size=world_size)
  dist.init_process_group('nccl' if kind == 'cuda' else 'gloo',
                          init_method=init_method, timeout=TIMEOUT, **kw)
  return device


def finish() -> None:
  """Wait for every process, then take the process group down."""
  if active():
    dist.barrier()
    dist.destroy_process_group()


def all_sum_(x: torch.Tensor) -> torch.Tensor:
  """``x`` summed over the processes, in place; returned."""
  if active():
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
  return x


def mean_grads_(grads: Sequence[torch.Tensor]) -> None:
  """Each gradient replaced by its mean over the processes (JAX's
  ``pmean`` of the gradient tree), in one all-reduce of their
  concatenation."""
  if not active():
    return
  flat = torch.cat([g.reshape(-1) for g in grads])
  dist.all_reduce(flat, op=dist.ReduceOp.SUM)
  flat /= dist.get_world_size()
  for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
    g.copy_(part.view_as(g))


def mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """A dict of 0-dim tensors averaged over the processes (JAX's ``pmean``
  of the epoch's loss metrics)."""
  if not active() or not metrics:
    return metrics
  keys = sorted(metrics)
  stacked = torch.stack([metrics[k].float() for k in keys])
  dist.all_reduce(stacked, op=dist.ReduceOp.SUM)
  stacked /= dist.get_world_size()
  return dict(zip(keys, stacked.unbind()))


def rows(generator: torch.Generator, local: int):
  """The stream of this process's ``local`` envs: ``generator`` itself
  when no process group is up, else a ``core.RowStream`` of rows
  ``[rank·local, (rank + 1)·local)`` of a batch of ``world·local``."""
  if not active():
    return generator
  rank, size = world()
  return core.RowStream(generator, rank * local, local, size * local)
