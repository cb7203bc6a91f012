"""RSR: the distribution-matching penalty, its precompute, the six-file
dataset and RSR policy training (``rsr.pipeline``, ``python -m
rsr_mjx_tpu_torch.rsr.cli``).  Counterpart of ``rsr_mjx_tpu.rsr``."""

from rsr_mjx_tpu_torch.rsr import distribution
from rsr_mjx_tpu_torch.rsr.loss import (
    RSRData,
    build_rsr_data,
    compute_rsr_loss,
    make_grid,
)

__all__ = [
    'RSRData',
    'build_rsr_data',
    'compute_rsr_loss',
    'distribution',
    'make_grid',
]
