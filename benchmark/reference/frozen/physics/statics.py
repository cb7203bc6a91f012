"""Device copies of a model's static tables, made once per model.

The fused step indexes, masks and contracts with small numpy tables that
depend on the model's topology alone: body and geom ids, ancestor masks,
pair slots, row kinds.  Copying one to the device each substep is a copy
from pageable host memory on the hot path.  ``table`` builds and copies
each table at its first use and hands the same tensor back afterwards.

The cache lives on the ``Model`` object.  ``Model.replace`` of numeric
leaves alone (a tuned friction, a bound model) hands the cache on; any
other copy starts with an empty one.  The tensors are shared: no caller
writes into them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from benchmark.reference.frozen.physics.types import Model


def table(m: Model, name: str, build: Callable[[], np.ndarray], device,
          dtype: torch.dtype | None = None) -> torch.Tensor:
  """Model ``m``'s static table ``name`` on ``device`` (in ``dtype``, else
  the numpy dtype's counterpart); ``build()`` returns it as numpy and runs
  once per (name, device, dtype)."""
  cache = m.__dict__.setdefault('_device_tables', {})
  key = (name, torch.device(device), dtype)
  t = cache.get(key)
  if t is None:
    t = torch.tensor(np.asarray(build()), device=device, dtype=dtype)
    cache[key] = t
  return t
