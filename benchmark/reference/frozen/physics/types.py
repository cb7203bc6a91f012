"""Model / Data / Contact / Option of the PyTorch physics engine.

Counterpart of ``rsr_mjx_tpu/physics/types.py``.  ``Model`` keeps the same
split: *static* topology (numpy arrays and python ints, read by python
control flow) and *numeric leaves* (float32 tensors on the model's device).
``Data`` holds a whole batch of simulation states: every tensor carries a
leading env axis ``B`` (the JAX package vmaps a per-env ``Data``; the port
writes the batch axis out).  A domain-randomised ``Model`` is one model per
env: the leaves named in ``Model.batched`` carry a leading env axis
``(B, ...)``, as the JAX randomisers' batched models do, and the physics
reads every leaf through ``Model.lanes``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


class JointType:
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType:
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class IntegratorType:
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class TrnType:
  JOINT = 0
  JOINTINPARENT = 1
  SITE = 4


class GainType:
  FIXED = 0
  AFFINE = 1


class BiasType:
  NONE = 0
  AFFINE = 1


class EqType:
  CONNECT = 0
  WELD = 1
  JOINT = 2


class ConeType:
  PYRAMIDAL = 0
  ELLIPTIC = 1


class SensorType:
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FRAMEPOS = 26
  FRAMEQUAT = 27
  FRAMEXAXIS = 28
  FRAMEYAXIS = 29
  FRAMEZAXIS = 30
  FRAMELINVEL = 31
  FRAMEANGVEL = 32
  SUBTREELINVEL = 36


@dataclasses.dataclass
class Option:
  """Simulation options (mjOption subset)."""

  timestep: torch.Tensor  # ()
  gravity: torch.Tensor  # (3,)
  integrator: int = IntegratorType.EULER
  iterations: int = 8
  ls_iterations: int = 8
  tolerance: float = 1e-8
  cone: int = ConeType.PYRAMIDAL
  impratio: float = 1.0
  disableflags: int = 0


SIZE_FIELDS = (
    'nq', 'nv', 'nu', 'na', 'nbody', 'njnt', 'ngeom', 'nsite', 'neq',
    'nsensor', 'nsensordata',
)
OPT_TENSOR_FIELDS = ('timestep', 'gravity')
OPT_STATIC_FIELDS = (
    'integrator', 'iterations', 'ls_iterations', 'tolerance', 'cone',
    'impratio', 'disableflags',
)
# float32 tensors; the three optional ones may be None
NUMERIC_FIELDS = (
    'qpos0', 'body_pos', 'body_quat', 'body_ipos', 'body_iquat', 'body_mass',
    'body_inertia', 'body_invweight0', 'jnt_axis', 'jnt_pos', 'jnt_range',
    'jnt_solref', 'jnt_solimp', 'jnt_stiffness', 'jnt_margin',
    'dof_armature', 'dof_damping', 'dof_frictionloss', 'dof_invweight0',
    'dof_solref', 'dof_solimp', 'geom_pos', 'geom_quat', 'geom_size',
    'geom_friction', 'geom_solref', 'geom_solimp', 'geom_solmix',
    'geom_margin', 'geom_gap', 'site_pos', 'site_quat', 'eq_data',
    'eq_solref', 'eq_solimp', 'actuator_gainprm', 'actuator_biasprm',
    'actuator_ctrlrange', 'actuator_forcerange', 'actuator_gear',
    'hfield_data', 'key_qpos', 'key_ctrl',
)
# numpy topology arrays
STATIC_FIELDS = (
    'body_parentid', 'body_rootid', 'body_jntadr', 'body_jntnum',
    'body_dofadr', 'body_dofnum', 'jnt_type', 'jnt_qposadr', 'jnt_dofadr',
    'jnt_bodyid', 'jnt_limited', 'jnt_actfrclimited', 'jnt_actfrcrange',
    'dof_bodyid', 'dof_jntid', 'geom_type', 'geom_bodyid', 'geom_condim',
    'geom_priority', 'geom_dataid', 'site_bodyid', 'eq_type', 'eq_obj1id',
    'eq_obj2id', 'eq_active0', 'actuator_trntype', 'actuator_trnid',
    'actuator_gaintype', 'actuator_biastype', 'actuator_dyntype',
    'actuator_ctrllimited', 'actuator_forcelimited', 'sensor_type',
    'sensor_objid', 'sensor_objtype', 'sensor_reftype', 'sensor_refid',
    'sensor_adr', 'sensor_dim', 'anc_mask', 'dof_anc', 'hfield_nrow',
    'hfield_ncol', 'hfield_size', 'hfield_adr',
)


@dataclasses.dataclass
class Model:
  """Physics model: sizes, options, numeric leaves, static topology.

  ``pairs`` is the static collision pair table: a tuple of
  ``(group_name, int32 array (n, 3) of [geom1, geom2, condim])``.
  ``names`` maps kind → {name: id}.  ``batched`` names the numeric leaves
  that carry a leading env axis (a domain-randomised model, ``with_batched``);
  every other leaf is shared by all envs.
  """

  nq: int
  nv: int
  nu: int
  na: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  neq: int
  nsensor: int
  nsensordata: int
  opt: Option
  numeric: dict  # field -> tensor or None
  static: dict  # field -> numpy array
  pairs: tuple
  ncon: int = 0
  ncon_sel: int = 0
  names: Any = None
  batched: frozenset = frozenset()

  def __getattr__(self, name):
    # flat field access (m.body_mass, m.jnt_type) like the JAX Model
    d = self.__dict__
    if name in NUMERIC_FIELDS:
      return d['numeric'][name]
    if name in STATIC_FIELDS:
      return d['static'][name]
    raise AttributeError(name)

  @property
  def device(self) -> torch.device:
    return self.qpos0.device

  @property
  def batch_size(self) -> Optional[int]:
    """The number of envs of a domain-randomised model, else None."""
    if not self.batched:
      return None
    return self.numeric[min(self.batched)].shape[0]

  def lanes(self, name: str) -> torch.Tensor:
    """Numeric leaf ``name`` with the batch in the trailing axis, as the
    lanes stages read it: a batched leaf (B, ...) moved to (..., B), a
    shared one given a trailing axis of 1."""
    x = self.numeric[name]
    return x.movedim(0, -1) if name in self.batched else x[..., None]

  def replace(self, **kw) -> 'Model':
    """A copy with the given fields replaced.  Numeric leaves are named
    flat (``m.replace(geom_friction=f)``, as on the JAX Model) and are
    shared by all envs unless ``batched`` says otherwise; a copy that
    changes numeric leaves only keeps this model's device tables
    (``statics``), which depend on the topology alone."""
    numeric = {k: kw.pop(k) for k in list(kw) if k in NUMERIC_FIELDS}
    if numeric:
      kw['numeric'] = {**self.numeric, **numeric}
      kw.setdefault('batched', self.batched - set(numeric))
    out = dataclasses.replace(self, **kw)
    if set(kw) <= {'numeric', 'batched'} and '_device_tables' in self.__dict__:
      out.__dict__['_device_tables'] = self.__dict__['_device_tables']
    return out

  def with_batched(self, **leaves) -> 'Model':
    """One model per env: a copy whose given numeric leaves are replaced
    by arrays with a leading env axis (B, ...), the same B for all.  They
    may be numpy arrays (the fields a JAX randomiser batches, carried
    across), and land on this model's device in its dtype."""
    leaves = {k: torch.as_tensor(v if torch.is_tensor(v) else np.array(v),
                                 dtype=self.numeric[k].dtype,
                                 device=self.device)
              for k, v in leaves.items()}
    sizes = {self.batch_size} - {None}
    sizes |= {int(v.shape[0]) for v in leaves.values()}
    if len(sizes) != 1:
      raise ValueError(f'batched leaves disagree on the env count: {sizes}')
    for k, v in leaves.items():
      shape = self.numeric[k].shape[1 if k in self.batched else 0:]
      if tuple(v.shape[1:]) != tuple(shape):
        raise ValueError(f'{k}: batched shape {tuple(v.shape)} does not '
                         f'extend {tuple(shape)}')
    return self.replace(**leaves, batched=self.batched | frozenset(leaves))

  def to(self, device, dtype: Optional[torch.dtype] = None) -> 'Model':
    """Copy with every numeric leaf on ``device`` (and in ``dtype``: float64
    makes the CPU path a float64 reference of the float32 physics)."""
    mv = lambda x: None if x is None else x.to(device, dtype)
    opt = dataclasses.replace(
        self.opt, timestep=mv(self.opt.timestep), gravity=mv(self.opt.gravity)
    )
    return dataclasses.replace(
        self, opt=opt, numeric={k: mv(v) for k, v in self.numeric.items()}
    )


@dataclasses.dataclass
class Contact:
  """All potential contacts of a batch, static shape (B, ncon).

  Only ``dist`` is dynamic on the fused step path (the JAX package's slim
  hot-path Contact); geom1/geom2/condim are static slot metadata.
  """

  dist: torch.Tensor  # (B, ncon)
  geom1: Optional[np.ndarray] = None
  geom2: Optional[np.ndarray] = None
  condim: Optional[np.ndarray] = None


DATA_FIELDS = (
    'qpos', 'qvel', 'ctrl', 'act', 'time', 'xfrc_applied', 'xpos', 'xquat',
    'xmat', 'xipos', 'ximat', 'geom_xpos', 'geom_xmat', 'site_xpos',
    'site_xmat', 'subtree_com', 'cdof', 'cdof_anchor', 'cvel', 'qM', 'qLD',
    'qfrc_bias', 'qfrc_passive', 'qfrc_actuator', 'qfrc_applied',
    'actuator_force', 'qfrc_smooth', 'qacc_smooth', 'qfrc_constraint', 'qacc',
    'efc_force', 'sensordata',
)


@dataclasses.dataclass
class Data:
  """A batch of simulation states plus forward products; every tensor has
  a leading env axis B (shapes below are per env)."""

  qpos: torch.Tensor  # (nq,)
  qvel: torch.Tensor  # (nv,)
  ctrl: torch.Tensor  # (nu,)
  act: torch.Tensor  # (na,)
  time: torch.Tensor  # ()
  xfrc_applied: torch.Tensor  # (nbody, 6)
  xpos: torch.Tensor  # (nbody, 3)
  xquat: torch.Tensor  # (nbody, 4)
  xmat: torch.Tensor  # (nbody, 3, 3)
  xipos: torch.Tensor  # (nbody, 3)
  ximat: torch.Tensor  # (nbody, 3, 3)
  geom_xpos: torch.Tensor  # (ngeom, 3)
  geom_xmat: torch.Tensor  # (ngeom, 3, 3)
  site_xpos: torch.Tensor  # (nsite, 3)
  site_xmat: torch.Tensor  # (nsite, 3, 3)
  subtree_com: torch.Tensor  # (nbody, 3)
  cdof: torch.Tensor  # (nv, 6)
  cdof_anchor: torch.Tensor  # (nv, 3)
  cvel: torch.Tensor  # (nbody, 6)
  qM: torch.Tensor  # (nv, nv)
  qLD: torch.Tensor  # (nv, nv)
  qfrc_bias: torch.Tensor  # (nv,)
  qfrc_passive: torch.Tensor  # (nv,)
  qfrc_actuator: torch.Tensor  # (nv,)
  qfrc_applied: torch.Tensor  # (nv,)
  actuator_force: torch.Tensor  # (nu,)
  qfrc_smooth: torch.Tensor  # (nv,)
  qacc_smooth: torch.Tensor  # (nv,)
  qfrc_constraint: torch.Tensor  # (nv,)
  qacc: torch.Tensor  # (nv,)
  efc_force: torch.Tensor  # (nefc,)
  sensordata: torch.Tensor  # (nsensordata,)
  contact: Contact

  def replace(self, **kw) -> 'Data':
    return dataclasses.replace(self, **kw)

  @property
  def batch_size(self) -> int:
    return self.qpos.shape[0]

  def map(self, fn) -> 'Data':
    """Apply ``fn`` to every dynamic tensor (static contact ids kept)."""
    out = {f: fn(getattr(self, f)) for f in DATA_FIELDS}
    out['contact'] = dataclasses.replace(
        self.contact, dist=fn(self.contact.dist)
    )
    return Data(**out)
