"""Batched rigid-body physics with MuJoCo semantics, in PyTorch.

Counterpart of ``rsr_mjx_tpu.physics``.  Every state tensor carries a
leading env axis; the step runs the fused lanes-layout chain and the
Hopper kernels of ``linalg_kernels``.
"""

from rsr_mjx_tpu_torch.physics.forward import forward, make_data, step
from rsr_mjx_tpu_torch.physics.io import (
    load_model_npz,
    name2id,
    put_model,
    save_model_npz,
)
from rsr_mjx_tpu_torch.physics.types import Contact, Data, Model, Option

__all__ = [
    'Contact', 'Data', 'Model', 'Option', 'forward', 'load_model_npz',
    'make_data', 'name2id', 'put_model', 'save_model_npz', 'step',
]
