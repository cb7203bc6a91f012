"""Environment package: batched substrate, wrappers and registry.

Counterpart of ``rsr_mjx_tpu.envs``.  This slice registers the two Airbot
cube-push variants; the T-push and Go2 envs come with later slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from rsr_mjx_tpu_torch.envs import core, wrappers
from rsr_mjx_tpu_torch.envs.core import Env, State, Wrapper, init, step

_ENVS: Dict[str, Callable[..., Env]] = {}


def register_environment(name: str, ctor: Callable[..., Env]) -> None:
  _ENVS[name] = ctor


def load(name: str, **kwargs) -> Env:
  """Instantiate a registered env; ``device`` (default ``'cuda'``) is one
  of the keyword arguments."""
  if name not in _ENVS:
    raise ValueError(f'unknown env {name!r}; registered: {sorted(_ENVS)}')
  return _ENVS[name](**kwargs)


def registered_envs() -> Tuple[str, ...]:
  return tuple(sorted(_ENVS))


def _register_builtin():
  from rsr_mjx_tpu_torch.envs.airbot.cube_push import AirbotCubePush

  register_environment(
      'AirbotCubePush', lambda **kw: AirbotCubePush(variant='rsr', **kw)
  )
  register_environment(
      'AirbotCubePushTrain', lambda **kw: AirbotCubePush(variant='train', **kw)
  )


_register_builtin()

__all__ = [
    'Env', 'State', 'Wrapper', 'core', 'wrappers', 'init', 'step', 'load',
    'register_environment', 'registered_envs',
]
