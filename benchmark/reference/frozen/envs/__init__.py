"""The two envs of the benchmark's configurations (frozen copy of the
port's registry, trimmed)."""

from benchmark.reference.frozen.envs import core, wrappers


def load(name: str, **kwargs):
  """``AirbotCubePushTrain`` or ``Go2JoystickFlatTerrain``; ``device`` and
  ``dtype`` are keyword arguments."""
  if name == 'AirbotCubePushTrain':
    from benchmark.reference.frozen.envs.airbot.cube_push import AirbotCubePush
    return AirbotCubePush(variant='train', **kwargs)
  if name == 'Go2JoystickFlatTerrain':
    from benchmark.reference.frozen.envs.go2 import joystick
    return joystick.Joystick(task='flat_terrain', **kwargs)
  raise ValueError(f'the frozen reference has no env {name!r}')


__all__ = ['core', 'load', 'wrappers']
