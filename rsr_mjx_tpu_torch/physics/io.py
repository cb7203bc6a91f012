"""Host-side model conversion and the model snapshot.

Counterpart of ``rsr_mjx_tpu/physics/io.py``.  ``put_model`` turns a
compiled ``mujoco.MjModel`` into the port's ``Model`` and builds the static
collision pair table.  ``mujoco`` is imported lazily, inside the functions
that compile MJCF, because the machine that runs the port on the card has
no ``mujoco``: there the env constructors read a snapshot written by
``save_model_npz`` (every Model field, plain numpy) with numpy alone.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from rsr_mjx_tpu_torch.physics.types import (
    NUMERIC_FIELDS,
    OPT_STATIC_FIELDS,
    OPT_TENSOR_FIELDS,
    SIZE_FIELDS,
    STATIC_FIELDS,
    GeomType,
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

_TYPE_TO_NAME = {
    GeomType.PLANE: 'plane',
    GeomType.HFIELD: 'hfield',
    GeomType.SPHERE: 'sphere',
    GeomType.CAPSULE: 'capsule',
    GeomType.BOX: 'box',
}

_GROUPS = {
    ('plane', 'sphere'): 'plane_sphere',
    ('plane', 'capsule'): 'plane_capsule',
    ('plane', 'box'): 'plane_box',
    ('hfield', 'sphere'): 'hfield_sphere',
    ('sphere', 'sphere'): 'sphere_sphere',
    ('sphere', 'capsule'): 'sphere_capsule',
    ('sphere', 'box'): 'sphere_box',
    ('capsule', 'capsule'): 'capsule_capsule',
    ('capsule', 'box'): 'capsule_box',
    ('box', 'box'): 'box_box',
}

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'assets')


def _pair_group(t1: int, t2: int):
  """(group_name, swap) for a geom type pair, or None."""
  n1 = _TYPE_TO_NAME.get(t1)
  n2 = _TYPE_TO_NAME.get(t2)
  if n1 is None or n2 is None:
    return None
  for (a, b), name in _GROUPS.items():
    if (n1, n2) == (a, b):
      return name, False
    if (n1, n2) == (b, a):
      return name, True
  return None


def _collision_pairs(mjm):
  """Enumerate geom pairs following MuJoCo's filtering rules
  (contype/conaffinity masks, weld/parent filters, <exclude> list)."""
  exclude = set()
  for i in range(mjm.nexclude):
    sig = int(mjm.exclude_signature[i])
    exclude.add((sig >> 16, sig & 0xFFFF))

  groups: dict = {name: [] for name in GROUP_NCON}
  weld = mjm.body_weldid
  weld_parent = np.array(
      [mjm.body_weldid[mjm.body_parentid[weld[b]]] for b in range(mjm.nbody)]
  )

  for g1 in range(mjm.ngeom):
    for g2 in range(g1 + 1, mjm.ngeom):
      b1, b2 = int(mjm.geom_bodyid[g1]), int(mjm.geom_bodyid[g2])
      ok = (mjm.geom_contype[g1] & mjm.geom_conaffinity[g2]) or (
          mjm.geom_contype[g2] & mjm.geom_conaffinity[g1]
      )
      if not ok:
        continue
      w1, w2 = int(weld[b1]), int(weld[b2])
      if w1 == w2:
        continue
      if weld_parent[b2] == w1 and w1 != 0:
        continue
      if weld_parent[b1] == w2 and w2 != 0:
        continue
      if (w1, w2) in exclude or (w2, w1) in exclude:
        continue
      t1, t2 = int(mjm.geom_type[g1]), int(mjm.geom_type[g2])
      if t1 == GeomType.PLANE and t2 == GeomType.PLANE:
        continue
      got = _pair_group(t1, t2)
      if got is None:
        raise NotImplementedError(
            f'unsupported geom type pair ({t1},{t2}) for geoms {g1},{g2}'
        )
      name, swap = got
      a, b = (g2, g1) if swap else (g1, g2)
      p1, p2 = int(mjm.geom_priority[g1]), int(mjm.geom_priority[g2])
      if p1 > p2:
        condim = int(mjm.geom_condim[g1])
      elif p2 > p1:
        condim = int(mjm.geom_condim[g2])
      else:
        condim = max(int(mjm.geom_condim[g1]), int(mjm.geom_condim[g2]))
      groups[name].append((a, b, condim))

  # explicit <pair> entries: only pair_dim (condim) is honored, as in the
  # JAX package
  for i in range(mjm.npair):
    g1, g2 = int(mjm.pair_geom1[i]), int(mjm.pair_geom2[i])
    t1, t2 = int(mjm.geom_type[g1]), int(mjm.geom_type[g2])
    got = _pair_group(t1, t2)
    if got is None:
      raise NotImplementedError(
          f'unsupported geom type pair ({t1},{t2}) in explicit <pair> '
          f'for geoms {g1},{g2}'
      )
    name, swap = got
    a, b = (g2, g1) if swap else (g1, g2)
    groups[name].append((a, b, int(mjm.pair_dim[i])))

  return tuple(
      (name, np.array(groups[name], dtype=np.int32).reshape(-1, 3))
      for name in GROUP_NCON
  )


def _ancestor_masks(mjm):
  """anc_mask[b, j] = 1 iff dof j actuates an ancestor chain of body b;
  dof_anc[i] = anc_mask[body of dof i]."""
  nb, nv = mjm.nbody, mjm.nv
  anc = np.zeros((nb, nv), dtype=np.float32)
  for b in range(1, nb):
    cur = b
    while cur != 0:
      adr, num = int(mjm.body_dofadr[cur]), int(mjm.body_dofnum[cur])
      if num > 0:
        anc[b, adr : adr + num] = 1.0
      cur = int(mjm.body_parentid[cur])
  dof_anc = np.zeros((nv, nv), dtype=np.float32)
  for i in range(nv):
    dof_anc[i] = anc[int(mjm.dof_bodyid[i])]
  return anc, dof_anc


def put_model(mjm, device='cuda') -> Model:
  """Convert a compiled mujoco.MjModel into the port's Model."""
  f32 = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
  pairs = _collision_pairs(mjm)
  ncon = sum(GROUP_NCON[name] * len(tbl) for name, tbl in pairs)
  anc_mask, dof_anc = _ancestor_masks(mjm)
  names = {
      'body': {mjm.body(i).name: i for i in range(mjm.nbody)},
      'joint': {mjm.joint(i).name: i for i in range(mjm.njnt)},
      'geom': {mjm.geom(i).name: i for i in range(mjm.ngeom)},
      'site': {mjm.site(i).name: i for i in range(mjm.nsite)},
      'sensor': {mjm.sensor(i).name: i for i in range(mjm.nsensor)},
      'actuator': {mjm.actuator(i).name: i for i in range(mjm.nu)},
      # keyframes by name: the envs read key_qpos/key_ctrl rows, since the
      # compiled MjModel is not at hand where the snapshot is loaded
      'key': {mjm.key(i).name: i for i in range(mjm.nkey)},
  }
  opt = Option(
      timestep=f32(mjm.opt.timestep),
      gravity=f32(mjm.opt.gravity),
      integrator=int(mjm.opt.integrator),
      iterations=int(mjm.opt.iterations),
      ls_iterations=int(mjm.opt.ls_iterations),
      tolerance=float(mjm.opt.tolerance),
      cone=int(mjm.opt.cone),
      impratio=float(mjm.opt.impratio),
      disableflags=int(mjm.opt.disableflags),
  )
  numeric = {}
  for f in NUMERIC_FIELDS:
    if f in ('eq_data', 'eq_solref', 'eq_solimp') and not mjm.neq:
      width = {'eq_data': 11, 'eq_solref': 2, 'eq_solimp': 5}[f]
      numeric[f] = f32(np.zeros((0, width)))
    elif f == 'hfield_data' and not mjm.nhfield:
      numeric[f] = None
    elif f in ('key_qpos', 'key_ctrl') and not mjm.nkey:
      numeric[f] = None
    else:
      numeric[f] = f32(getattr(mjm, f))
  static = {f: np.array(getattr(mjm, f)) for f in STATIC_FIELDS
            if f not in ('anc_mask', 'dof_anc')}
  static['anc_mask'] = anc_mask
  static['dof_anc'] = dof_anc
  sizes = {f: int(getattr(mjm, f)) for f in SIZE_FIELDS}
  return Model(
      **sizes, opt=opt, numeric=numeric, static=static, pairs=pairs,
      ncon=ncon, ncon_sel=0, names=names,
  )


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
  from rsr_mjx_tpu_torch.physics import constraint as _constraint

  condims = set(_constraint.contact_condims(m))
  if len(condims) > 1:
    raise ValueError(
        'max_contacts (top-k contact selection) requires uniform contact '
        f'condim across all pairs; model has condims {sorted(condims)}'
    )
  return m.replace(ncon_sel=max_contacts)


def load_model_from_xml(xml: str, max_contacts: int = 0, device='cuda'):
  """Compile MJCF with C MuJoCo (imported here, lazily) and convert."""
  import mujoco

  mjm = mujoco.MjModel.from_xml_string(xml)
  return _apply_max_contacts(put_model(mjm, device=device), max_contacts)


# ---------------------------------------------------------------------------
# Snapshot: every Model field as plain numpy in one .npz.
# ---------------------------------------------------------------------------


def save_model_npz(m: Model, path: str) -> None:
  arrs = {f'size.{f}': np.int64(getattr(m, f)) for f in SIZE_FIELDS}
  for f in OPT_TENSOR_FIELDS:
    arrs[f'opt.{f}'] = getattr(m.opt, f).cpu().numpy()
  for f in OPT_STATIC_FIELDS:
    arrs[f'opt.{f}'] = np.asarray(getattr(m.opt, f))
  for f in NUMERIC_FIELDS:
    if m.numeric[f] is not None:
      arrs[f'num.{f}'] = m.numeric[f].cpu().numpy()
  for f in STATIC_FIELDS:
    arrs[f'static.{f}'] = m.static[f]
  for i, (name, tbl) in enumerate(m.pairs):
    arrs[f'pairs.{i:02d}.{name}'] = tbl
  arrs['ncon'] = np.int64(m.ncon)
  arrs['ncon_sel'] = np.int64(m.ncon_sel)
  arrs['names'] = np.array(json.dumps(m.names, sort_keys=True))
  np.savez_compressed(path, **arrs)


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
