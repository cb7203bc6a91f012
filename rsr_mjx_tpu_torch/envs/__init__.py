"""Environment package: batched substrate, wrappers and registry.

Counterpart of ``rsr_mjx_tpu.envs``.  Registered so far: the two Airbot
cube-push variants and the Go2 flat-terrain joystick task.  T-push, the
rough-terrain joystick, getup, handstand and footstand come with later
slices; ``load`` of them raises the unknown-env error.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from rsr_mjx_tpu_torch.envs import core, wrappers
from rsr_mjx_tpu_torch.envs.core import Env, State, Wrapper, init, step

_ENVS: Dict[str, Callable[..., Env]] = {}
_CONFIGS: Dict[str, Callable[[], Any]] = {}


def register_environment(name: str, ctor: Callable[..., Env],
                         config_fn: Optional[Callable[[], Any]] = None) -> None:
  _ENVS[name] = ctor
  if config_fn is not None:
    _CONFIGS[name] = config_fn


def load(name: str, config: Optional[Any] = None, **kwargs) -> Env:
  """Instantiate a registered env; ``device`` (default ``'cuda'``) is one
  of the keyword arguments."""
  if name not in _ENVS:
    raise ValueError(f'unknown env {name!r}; registered: {sorted(_ENVS)}')
  if config is not None:
    return _ENVS[name](config=config, **kwargs)
  return _ENVS[name](**kwargs)


def get_default_config(name: str):
  return _CONFIGS[name]()


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

  from rsr_mjx_tpu_torch.envs.go2.joystick import Joystick, default_config

  register_environment(
      'Go2JoystickFlatTerrain',
      lambda **kw: Joystick(task='flat_terrain', **kw),
      config_fn=default_config,
  )


_register_builtin()

__all__ = [
    'Env', 'State', 'Wrapper', 'core', 'wrappers', 'init', 'step', 'load',
    'register_environment', 'get_default_config', 'registered_envs',
]
