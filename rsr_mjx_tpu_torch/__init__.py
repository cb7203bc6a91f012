"""PyTorch / CUDA port of rsr_mjx_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX package ``rsr_mjx_tpu``, which stays the
reference: the same subpackage and module names (``physics/``, ``envs/``,
``train/``), PyTorch inside.  It imports ``torch`` and never ``jax`` or
anything of ``rsr_mjx_tpu``.  The TPU kernels of the JAX package are
hand-written CUDA C++ kernels here (``csrc/``), each beside a plain PyTorch
version that CPU tensors take.
"""
