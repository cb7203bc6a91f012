"""PyTorch / CUDA port of rsr_mjx_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX package ``rsr_mjx_tpu``, which stays the
reference: the same subpackage and module names (``physics/``, ``envs/``,
``train/``), PyTorch inside.  It imports ``torch`` and never ``jax`` or
anything of ``rsr_mjx_tpu``.  The TPU kernels of the JAX package are
hand-written CUDA C++ kernels here (``csrc/``), each beside a plain PyTorch
version that CPU tensors take.
"""

import os as _os

# Headless rendering: C MuJoCo fixes its GL backend at the first
# ``import mujoco`` (its package imports the renderer's GL context), so the
# EGL default is set here, before any module of the port imports mujoco;
# ``utils/rendering.py`` would be too late where an env module imported it
# first.  A user with a display, or another backend, sets MUJOCO_GL first.
if 'MUJOCO_GL' not in _os.environ and 'DISPLAY' not in _os.environ:
  _os.environ['MUJOCO_GL'] = 'egl'
del _os
