"""The model snapshot (frozen copy): every field of the port's ``Model``
as plain numpy in one ``.npz`` under ``assets/``, read with numpy alone.

Counterpart of ``rsr_mjx_tpu/physics/io.py``.  The port's conversion from
a compiled ``mujoco.MjModel`` (``put_model``), which wrote these files, is
left out of this copy; ``benchmark/tests/test_bench_jax_fixtures.py``
holds the envs built on them to the JAX package's.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark.reference.frozen.physics.types import (
    NUMERIC_FIELDS,
    OPT_STATIC_FIELDS,
    OPT_TENSOR_FIELDS,
    SIZE_FIELDS,
    STATIC_FIELDS,
    Model,
    Option,
)

# contacts emitted per pair, keyed by collision-function group (every
# candidate probe is a slot: plane_box = 8 corners, box_box = 8+8 probes)
GROUP_NCON = {
    'plane_sphere': 1,
    'plane_capsule': 2,
    'plane_box': 8,
    'hfield_sphere': 1,
    'sphere_sphere': 1,
    'sphere_capsule': 1,
    'sphere_box': 1,
    'capsule_capsule': 1,
    'capsule_box': 2,
    'box_box': 16,
}

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'assets')


def name2id(m: Model, kind: str, name: str) -> int:
  return m.names[kind][name]


def _apply_max_contacts(m: Model, max_contacts: int) -> Model:
  """Validate and set Model.ncon_sel (top-k active-contact selection)."""
  if not max_contacts:
    return m
  max_contacts = int(max_contacts)
  if max_contacts < 0:
    raise ValueError(f'max_contacts must be >= 0, got {max_contacts}')
  if max_contacts >= m.ncon:
    return m.replace(ncon_sel=0)
  from benchmark.reference.frozen.physics import constraint as _constraint

  condims = set(_constraint.contact_condims(m))
  if len(condims) > 1:
    raise ValueError(
        'max_contacts (top-k contact selection) requires uniform contact '
        f'condim across all pairs; model has condims {sorted(condims)}'
    )
  return m.replace(ncon_sel=max_contacts)


def load_model_npz(path: str, device='cuda') -> Model:
  """Read a snapshot with numpy alone (no mujoco)."""
  with np.load(path, allow_pickle=False) as z:
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    opt = Option(
        **{f: f32(z[f'opt.{f}']) for f in OPT_TENSOR_FIELDS},
        **{f: z[f'opt.{f}'].item() for f in OPT_STATIC_FIELDS},
    )
    numeric = {
        f: f32(z[f'num.{f}']) if f'num.{f}' in z.files else None
        for f in NUMERIC_FIELDS
    }
    static = {f: z[f'static.{f}'] for f in STATIC_FIELDS}
    pairs = tuple(
        (k.split('.', 2)[2], z[k])
        for k in sorted(k for k in z.files if k.startswith('pairs.'))
    )
    names = json.loads(str(z['names']))
    return Model(
        **{f: int(z[f'size.{f}']) for f in SIZE_FIELDS},
        opt=opt, numeric=numeric, static=static, pairs=pairs,
        ncon=int(z['ncon']), ncon_sel=int(z['ncon_sel']), names=names,
    )
