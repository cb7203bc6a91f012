"""The reference's step from a state the program reached: the program's
state (a ``core.State`` of the port, with its ``Data`` and the wrappers'
info) carried into the frozen copy's classes, cast to the reference's
precision, then one control step of the frozen training stack.

Where the env draws inside a step (the Go2 joystick's observation noise,
kicks and commands), the draws come from a generator on the same device
set to the state the program's generator had before that step, so both
sides draw the same numbers.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

_PORT = 'rsr_mjx_tpu_torch.'
_FROZEN = 'benchmark.reference.frozen.'


def _frozen_class(cls):
  mod = cls.__module__
  if not mod.startswith(_PORT):
    return cls
  return getattr(importlib.import_module(_FROZEN + mod[len(_PORT):]),
                 cls.__name__)


def carry(x, dtype: torch.dtype, rng_state=None):
  """``x`` with every dataclass of the port made the frozen copy's, every
  floating tensor a copy in ``dtype`` (other tensors copied as they are)
  and every generator a new one on its device in ``rng_state`` (its own
  state where None)."""
  if isinstance(x, torch.Tensor):
    return x.to(dtype=dtype) if x.is_floating_point() else x.clone()
  if isinstance(x, torch.Generator):
    g = torch.Generator(device=x.device)
    g.set_state(x.get_state() if rng_state is None else rng_state)
    return g
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    cls = _frozen_class(type(x))
    return cls(**{f.name: carry(getattr(x, f.name), dtype, rng_state)
                  for f in dataclasses.fields(x)})
  if isinstance(x, dict):
    return {k: carry(v, dtype, rng_state) for k, v in x.items()}
  if isinstance(x, tuple) and hasattr(x, '_fields'):
    return type(x)(*(carry(v, dtype, rng_state) for v in x))
  if isinstance(x, (tuple, list)):
    return type(x)(carry(v, dtype, rng_state) for v in x)
  return x


def generator_state(state):
  """The state of the generator a program's env state draws from (the
  Go2 joystick's ``info['rng']``), or None."""
  g = state.info.get('rng')
  return g.get_state() if isinstance(g, torch.Generator) else None


def training_stack(cfg: dict, device, dtype: torch.dtype, num_envs: int):
  """The frozen env of the configuration under the frozen
  ``wrap_for_training``."""
  from benchmark.reference.frozen import envs
  from benchmark.reference.frozen.envs import wrappers

  env0 = envs.load(cfg['env'], device=device, dtype=dtype,
                   **cfg['env_kwargs'])
  return env0, wrappers.wrap_for_training(
      env0, episode_length=cfg['episode_length'], num_envs=num_envs)


@torch.no_grad()
def step(env, state, action, dtype, rng_state=None, moved=None):
  """One control step of the frozen stack ``env`` from the program's
  ``state`` with the program's ``action``; ``moved``, a seed: from the
  state with its ``qpos`` and its solver's warm start ``qacc`` moved
  (``moved_qpos``)."""
  s = carry(state, dtype, rng_state)
  if moved is not None:
    s = s.replace(data=dataclasses.replace(
        s.data, qpos=moved_qpos(s.data.qpos, moved),
        qacc=moved_qpos(s.data.qacc, moved, WARM_SCALE)))
  return env.step(s, action.to(dtype))


# the witness that an env lies within rounding of a branch: the reference
# from the state with its qpos moved by up to a millionth of itself (about
# sixteen float32 roundings) and the warm start of its fixed-iteration
# Newton solve by up to 1e-5 (where a step's accept or reject turns on a
# cost change near nought), so many draws
WITNESS_SCALE = 1e-6
WARM_SCALE = 1e-5
WITNESS_TRIES = 12


def moved_qpos(x: torch.Tensor, seed: int,
               scale: float = WITNESS_SCALE) -> torch.Tensor:
  """``x`` with each entry moved by a draw in ±``scale`` of itself, from
  ``seed``."""
  g = torch.Generator(device=x.device).manual_seed(seed)
  u = torch.rand(x.shape, generator=g, device=x.device, dtype=x.dtype)
  return x * (1 + scale * (2 * u - 1))


def moved_init(init, seed: int):
  """Reset draws (a dict or a (qpos, ...) tuple) with ``qpos`` moved."""
  if isinstance(init, dict):
    return dict(init, qpos=moved_qpos(init['qpos'], seed))
  return (moved_qpos(init[0], seed),) + tuple(init[1:])


def reached(run, target, envs, tol: float) -> np.ndarray:
  """The envs of the mask ``envs`` whose ``target`` row (the program's
  outputs, (B, n)) some run of the reference, ``run(seed)`` for seeds
  0 … ``WITNESS_TRIES`` − 1, comes within ``tol`` of an entry of
  (``rel_gap``): those the program leaves the reference in where the
  reference's own outcome turns on rounding."""
  from benchmark.common import rel_gap

  hit = np.zeros(len(envs), bool)
  for seed in range(WITNESS_TRIES):
    if not (envs & ~hit).any():
      break
    hit |= rel_gap(target, run(seed)) <= tol
  return hit & envs


# the fields of a state's ``Data`` that the next step starts from
BF16_FIELDS = ('qpos', 'qvel', 'act', 'ctrl', 'qacc')


def bf16_physics(state):
  """``state`` with its physics state (``BF16_FIELDS``) rounded through
  bfloat16: what a physics step held in bfloat16 would start from."""
  data = state.data
  rounded = {f: getattr(data, f).to(torch.bfloat16).to(getattr(data, f).dtype)
             for f in BF16_FIELDS}
  return dataclasses.replace(state, data=dataclasses.replace(data, **rounded))


def flat_obs(obs) -> torch.Tensor:
  """The observation as (B, n): a dict's entries side by side, in key
  order."""
  if isinstance(obs, dict):
    return torch.cat([obs[k].reshape(obs[k].shape[0], -1)
                      for k in sorted(obs)], dim=1)
  return obs.reshape(obs.shape[0], -1)
