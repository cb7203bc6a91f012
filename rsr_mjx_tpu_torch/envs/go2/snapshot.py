"""Committed model snapshots of the Go2 scenes.

The machine that runs the port on the card has no ``mujoco``, so the Go2
envs read the compiled model from ``rsr_mjx_tpu_torch/assets/`` with numpy
alone (``physics.io.load_model_npz``).  This module rebuilds that file from
the MJCF of ``scene.py`` through ``physics.io.put_model``, which needs
``mujoco``:

    python -m rsr_mjx_tpu_torch.envs.go2.snapshot

A snapshot holds its scene as compiled (timestep 0.004, kp 35, damping
0.5); the env applies its config (``sim_dt``, ``Kp``, ``Kd``) to the loaded
model.  The rough-terrain snapshot also holds the reference's 256 × 256
heights (``scene.reference_heightfield``), written into the compiled model
as the JAX Go2 env writes them.  Run it after any change to ``scene.py`` or
to ``put_model``; the tests hold the committed files against a fresh
build.
"""

from __future__ import annotations

import os

from rsr_mjx_tpu_torch.envs.go2 import scene
from rsr_mjx_tpu_torch.physics import io

# task name → (snapshot file, function that writes the MJCF)
TASKS = {
    'flat_terrain': ('go2_joystick_flat.npz', scene.build_flat_scene),
    'rough_terrain': ('go2_joystick_rough.npz', scene.build_rough_scene),
    'full_flat': ('go2_full_flat.npz', scene.build_full_scene),
}


def path(task: str) -> str:
  return os.path.join(io.ASSETS, TASKS[task][0])


def build(task: str, device='cpu'):
  """Compile the Go2 scene of ``task`` with C MuJoCo; a heightfield gets
  the reference's heights."""
  import mujoco

  mjm = mujoco.MjModel.from_xml_string(TASKS[task][1]())
  if mjm.nhfield:
    mjm.hfield_data[:] = scene.reference_heightfield()
  return io.put_model(mjm, device=device)


def main() -> None:
  os.makedirs(io.ASSETS, exist_ok=True)
  for task in TASKS:
    io.save_model_npz(build(task), path(task))
    print('wrote', path(task))


if __name__ == '__main__':
  main()
