"""Shared utilities: shaped rewards, gait profiles, offscreen rendering.

``rendering`` is imported on its own (``from rsr_mjx_tpu_torch.utils
import rendering``), as in the JAX package.
"""

from rsr_mjx_tpu_torch.utils import gait, reward

__all__ = ['gait', 'reward', 'rendering']
