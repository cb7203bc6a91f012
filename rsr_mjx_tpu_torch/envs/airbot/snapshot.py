"""Committed model snapshots of the Airbot scenes: both cube-push variants
and T-push.

The machine that runs the port on the card has no ``mujoco``, so the env
constructors read the compiled model from ``rsr_mjx_tpu_torch/assets/``
with numpy alone (``physics.io.load_model_npz``).  This module rebuilds
those files from the MJCF of ``scene.py`` through ``physics.io.put_model``,
which needs ``mujoco``:

    python -m rsr_mjx_tpu_torch.envs.airbot.snapshot

Run it after any change to the scene builder or to ``put_model``; the
tests hold the committed files against a fresh build.
"""

from __future__ import annotations

import os

from rsr_mjx_tpu_torch.envs.airbot.scene import (
    build_cube_scene, build_tshape_scene)
from rsr_mjx_tpu_torch.physics import io

# the two cube-push variants: (table friction, cube friction)
FRICTIONS = {'rsr': (0.4, 1.22), 'train': (1.0, 1.0)}
# contact slots the solver sees (Model.ncon_sel) in the stored models:
# cube-push's and T-push's defaults (t_push.py keeps the JAX env's 32)
MAX_CONTACTS = 24
T_PUSH_MAX_CONTACTS = 32
VARIANTS = tuple(FRICTIONS) + ('t_push',)


def path(variant: str) -> str:
  """The snapshot of cube-push ``variant`` ('rsr', 'train') or of
  ``'t_push'``."""
  name = 'airbot_t_push' if variant == 't_push' else (
      f'airbot_cube_push_{variant}')
  return os.path.join(io.ASSETS, f'{name}.npz')


def xml(variant: str) -> str:
  """The MJCF of ``variant``."""
  if variant == 't_push':
    return build_tshape_scene()
  table, cube = FRICTIONS[variant]
  return build_cube_scene(table_friction=table, cube_friction=cube)


def build(variant: str, device='cpu'):
  """Compile the scene of ``variant`` with C MuJoCo."""
  return io.load_model_from_xml(
      xml(variant), device=device,
      max_contacts=T_PUSH_MAX_CONTACTS if variant == 't_push' else (
          MAX_CONTACTS))


def main() -> None:
  os.makedirs(io.ASSETS, exist_ok=True)
  for variant in VARIANTS:
    io.save_model_npz(build(variant), path(variant))
    print('wrote', path(variant))


if __name__ == '__main__':
  main()
