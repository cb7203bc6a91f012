"""Batched rigid-body physics with MuJoCo semantics, in PyTorch.

Counterpart of ``rsr_mjx_tpu.physics``.  Every state tensor carries a
leading env axis; the step runs the fused lanes-layout chain and the
plain versions of the port's kernels in ``linalg_kernels``.
"""

from benchmark.reference.frozen.physics.forward import forward, make_data, step
from benchmark.reference.frozen.physics.io import load_model_npz, name2id
from benchmark.reference.frozen.physics.types import Contact, Data, Model, Option

__all__ = [
    'Contact', 'Data', 'Model', 'Option', 'forward', 'load_model_npz',
    'make_data', 'name2id', 'step',
]
