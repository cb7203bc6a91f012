"""Environment package: batched substrate, wrappers and registry.

Counterpart of ``rsr_mjx_tpu.envs``, with every env of its registry: the
two Airbot cube-push variants, Airbot T-push, and the Go2 joystick on flat
and on rough terrain, getup, handstand and footstand.

``get_domain_randomizer(name)`` hands out the env's randomiser, as the JAX
registry does (both cube-push variants and every Go2 task; T-push has
none), or None.  A randomiser here is ``fn(model, generator, batch_size)``
and returns one model per env (``Model.batched``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from rsr_mjx_tpu_torch.envs import core, wrappers
from rsr_mjx_tpu_torch.envs.core import Env, State, Wrapper, init, step

_ENVS: Dict[str, Callable[..., Env]] = {}
_CONFIGS: Dict[str, Callable[[], Any]] = {}
_RANDOMIZERS: Dict[str, Optional[Callable]] = {}


def register_environment(name: str, ctor: Callable[..., Env],
                         config_fn: Optional[Callable[[], Any]] = None,
                         randomizer: Optional[Callable] = None) -> None:
  _ENVS[name] = ctor
  if config_fn is not None:
    _CONFIGS[name] = config_fn
  _RANDOMIZERS[name] = randomizer


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


def get_domain_randomizer(name: str) -> Optional[Callable]:
  return _RANDOMIZERS.get(name)


def registered_envs() -> Tuple[str, ...]:
  return tuple(sorted(_ENVS))


def _register_builtin():
  from rsr_mjx_tpu_torch.envs.airbot import randomize as airbot_randomize
  from rsr_mjx_tpu_torch.envs.airbot.cube_push import AirbotCubePush
  from rsr_mjx_tpu_torch.envs.airbot.t_push import AirbotTPush

  register_environment(
      'AirbotCubePush', lambda **kw: AirbotCubePush(variant='rsr', **kw),
      randomizer=airbot_randomize.domain_randomize,
  )
  register_environment(
      'AirbotCubePushTrain',
      lambda **kw: AirbotCubePush(variant='train', **kw),
      randomizer=airbot_randomize.domain_randomize,
  )
  register_environment('AirbotTPush', AirbotTPush)

  from rsr_mjx_tpu_torch.envs.go2 import getup, handstand, joystick
  from rsr_mjx_tpu_torch.envs.go2 import randomize as go2_randomize

  go2 = (
      ('Go2JoystickFlatTerrain',
       lambda **kw: joystick.Joystick(task='flat_terrain', **kw),
       joystick.default_config),
      ('Go2JoystickRoughTerrain',
       lambda **kw: joystick.Joystick(task='rough_terrain', **kw),
       joystick.default_config),
      ('Go2Getup', getup.Getup, getup.default_config),
      ('Go2Handstand', handstand.Handstand, handstand.default_config),
      ('Go2Footstand', handstand.Footstand, handstand.default_config),
  )
  for name, ctor, config_fn in go2:
    register_environment(name, ctor, config_fn=config_fn,
                         randomizer=go2_randomize.domain_randomize)


_register_builtin()

__all__ = [
    'Env', 'State', 'Wrapper', 'core', 'wrappers', 'init', 'step', 'load',
    'register_environment', 'get_default_config', 'get_domain_randomizer',
    'registered_envs',
]
