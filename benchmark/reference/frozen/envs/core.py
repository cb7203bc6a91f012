"""Environment substrate: batched ``State``, the ``Env`` base class,
``init`` and ``step``.

Counterpart of ``rsr_mjx_tpu/envs/core.py``.  An env here is batched from
the start: ``reset(generator, batch_size)`` makes ``batch_size`` envs and
every tensor of ``State`` carries that leading axis (the JAX package vmaps
a per-env env instead).  Reset noise comes from an explicit
``torch.Generator``, or from a ``RowStream``: one process's rows of the
draws made for a batch spread over several processes, so that each env's
draws depend on its index in the whole batch only (``rand``, ``randn``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, Optional

import torch

from benchmark.reference.frozen import physics
from benchmark.reference.frozen.physics.types import Data, Model


class RowStream:
  """Rows ``[start, start + rows)`` of every draw made from ``generator``
  for a batch of ``total`` envs.  Each process of a batch spread over
  several holds one, seeded alike: env i then draws what it would draw in
  one process of ``total`` envs (the JAX trainer's per-env keys).  The
  draws' leading axis is the env axis.  A plain class, so ``tree_map``
  passes it through a state's ``info`` as it does a generator."""

  def __init__(self, generator: torch.Generator, start: int, rows: int,
               total: int):
    if not 0 <= start and start + rows <= total:
      raise ValueError(f'rows [{start}, {start + rows}) outside {total}')
    self.generator, self.start, self.rows, self.total = (
        generator, start, rows, total)

  @property
  def device(self) -> torch.device:
    return self.generator.device

  def draw(self, fn, shape) -> torch.Tensor:
    shape = tuple(shape)
    if not shape or shape[0] != self.rows:
      raise ValueError(f'a draw of shape {shape} has no leading axis of '
                       f'{self.rows} envs')
    full = fn((self.total,) + shape[1:], generator=self.generator,
              device=self.device)
    return full[self.start:self.start + self.rows]


def rand(generator, shape) -> torch.Tensor:
  """U[0, 1) of ``shape`` on the generator's device, from a
  ``torch.Generator`` or a ``RowStream``."""
  if isinstance(generator, RowStream):
    return generator.draw(torch.rand, shape)
  return torch.rand(shape, generator=generator, device=generator.device)


def randn(generator, shape) -> torch.Tensor:
  """N(0, 1) of ``shape``, as ``rand``."""
  if isinstance(generator, RowStream):
    return generator.draw(torch.randn, shape)
  return torch.randn(shape, generator=generator, device=generator.device)


@dataclasses.dataclass
class State:
  """Batched environment state.  Per-env bookkeeping (commands, cached
  poses, episode counters added by wrappers) lives in ``info``."""

  data: Data
  obs: torch.Tensor
  reward: torch.Tensor
  done: torch.Tensor
  metrics: Dict[str, torch.Tensor]
  info: Dict[str, Any]

  def replace(self, **kw) -> 'State':
    return dataclasses.replace(self, **kw)


def init(m: Model, qpos: torch.Tensor, qvel: Optional[torch.Tensor] = None,
         ctrl: Optional[torch.Tensor] = None) -> Data:
  """Fresh batch of states with the given overrides, forward'd; the batch
  size is qpos's leading axis."""
  d = physics.make_data(m, qpos.shape[0])
  d = d.replace(qpos=qpos.to(d.qpos.dtype))
  if qvel is not None:
    d = d.replace(qvel=qvel.to(d.qvel.dtype))
  if ctrl is not None:
    d = d.replace(ctrl=ctrl.to(d.ctrl.dtype))
  return physics.forward(m, d)


def step(m: Model, d: Data, ctrl: torch.Tensor, n_substeps: int = 1) -> Data:
  """Advance every env ``n_substeps`` physics steps with ``ctrl`` held.
  Sensors are pure outputs, so only the last substep fills them."""
  ctrl = ctrl.to(d.qpos.dtype)
  for i in range(n_substeps):
    d = physics.step(m, d.replace(ctrl=ctrl), sensors=i == n_substeps - 1)
  return d


class Env(abc.ABC):
  """Batched environment."""

  @abc.abstractmethod
  def reset(self, generator: torch.Generator, batch_size: int) -> State:
    ...

  @abc.abstractmethod
  def step(self, state: State, action: torch.Tensor) -> State:
    ...

  @property
  @abc.abstractmethod
  def model(self) -> Model:
    ...

  @property
  @abc.abstractmethod
  def action_size(self) -> int:
    ...

  @property
  def observation_size(self) -> int:
    raise NotImplementedError

  @property
  def ctrl_dt(self) -> float:
    raise NotImplementedError

  @property
  def sim_dt(self) -> float:
    raise NotImplementedError

  @property
  def n_substeps(self) -> int:
    return int(round(self.ctrl_dt / self.sim_dt))

  @property
  def unwrapped(self) -> 'Env':
    return self


class Wrapper(Env):
  """Delegating base wrapper."""

  def __init__(self, env: Env):
    self.env = env

  def reset(self, generator: torch.Generator, *args) -> State:
    return self.env.reset(generator, *args)

  def step(self, state: State, action: torch.Tensor) -> State:
    return self.env.step(state, action)

  @property
  def model(self) -> Model:
    return self.env.model

  @property
  def action_size(self) -> int:
    return self.env.action_size

  @property
  def observation_size(self) -> int:
    return self.env.observation_size

  @property
  def ctrl_dt(self) -> float:
    return self.env.ctrl_dt

  @property
  def sim_dt(self) -> float:
    return self.env.sim_dt

  @property
  def unwrapped(self) -> Env:
    return self.env.unwrapped

  def __getattr__(self, name):
    if name.startswith('__') or name == 'env':
      raise AttributeError(name)
    return getattr(self.env, name)
