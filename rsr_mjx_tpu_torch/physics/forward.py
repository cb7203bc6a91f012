"""Forward dynamics and the physics step over a batch of envs.

Counterpart of ``rsr_mjx_tpu/physics/forward.py``.  ``step(m, d)`` runs the
fused chain of ``fwd_fused`` (kinematics → smooth dynamics → narrow phase
→ assembly → Newton solve → implicit solve), fills the sensors and
integrates; ``forward`` runs the same chain without the implicit solve, for
``envs.core.init``.  Sensors are pure outputs, read from the state before
integration and from the raw constrained acceleration; ``sensors=False``
skips them (a control step of several substeps needs them on its last one
only).

Precision: the JAX physics runs under matmul precision 'highest' (true
fp32; bf16 matmuls corrupted its contact geometry).  The port keeps fp32
everywhere and switches TF32 off for CUDA matmuls and cuDNN on every call
of ``forward`` and ``step``.
"""

from __future__ import annotations

import torch

from rsr_mjx_tpu_torch.physics import collision as _collision
from rsr_mjx_tpu_torch.physics import constraint as _constraint
from rsr_mjx_tpu_torch.physics import fwd_fused as _ff
from rsr_mjx_tpu_torch.physics import lie
from rsr_mjx_tpu_torch.physics import sensors as _sensors
from rsr_mjx_tpu_torch.physics.types import Contact, Data, JointType, Model
from rsr_mjx_tpu_torch.utils import tracing


def _fp32() -> None:
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


def make_data(m: Model, batch_size: int) -> Data:
  """A batch of fresh states at qpos0 with zero velocity, on m's device and
  in its dtype."""
  B = batch_size
  dev, dtype = m.device, m.qpos0.dtype
  z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=dev)
  nefc = _constraint.layout_cached(m).nefc
  g1, g2, cd = _collision.contact_static_ids(m)
  return Data(
      qpos=m.qpos0.expand(B, m.nq).clone(),
      qvel=z(m.nv), ctrl=z(m.nu), act=z(m.na), time=z(),
      xfrc_applied=z(m.nbody, 6),
      xpos=z(m.nbody, 3), xquat=z(m.nbody, 4), xmat=z(m.nbody, 3, 3),
      xipos=z(m.nbody, 3), ximat=z(m.nbody, 3, 3),
      geom_xpos=z(m.ngeom, 3), geom_xmat=z(m.ngeom, 3, 3),
      site_xpos=z(m.nsite, 3), site_xmat=z(m.nsite, 3, 3),
      subtree_com=z(m.nbody, 3), cdof=z(m.nv, 6), cdof_anchor=z(m.nv, 3),
      cvel=z(m.nbody, 6), qM=z(m.nv, m.nv), qLD=z(m.nv, m.nv),
      qfrc_bias=z(m.nv), qfrc_passive=z(m.nv), qfrc_actuator=z(m.nv),
      qfrc_applied=z(m.nv), actuator_force=z(m.nu), qfrc_smooth=z(m.nv),
      qacc_smooth=z(m.nv), qfrc_constraint=z(m.nv), qacc=z(m.nv),
      efc_force=z(nefc), sensordata=z(m.nsensordata),
      contact=Contact(dist=torch.full((B, m.ncon), 1e10, dtype=dtype,
                                      device=dev),
                      geom1=g1, geom2=g2, condim=cd),
  )


def forward(m: Model, d: Data, sensors: bool = True) -> Data:
  """Forward dynamics: fills qacc and every product before it, and
  ``sensordata`` unless ``sensors`` is False."""
  _fp32()
  d, _ = _ff.forward_lanes(m, d, implicit=False)
  return _sensors.sensordata(m, d) if sensors else d


def _integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt):
  """Integrate qpos (B, nq) by qvel (B, nv); free and ball joint
  quaternions stay on the unit sphere."""
  out = qpos.clone()
  for ji in range(m.njnt):
    jt = int(m.jnt_type[ji])
    qadr, vadr = int(m.jnt_qposadr[ji]), int(m.jnt_dofadr[ji])
    if jt == JointType.FREE:
      out[:, qadr : qadr + 3] = qpos[:, qadr : qadr + 3] + dt * qvel[:, vadr : vadr + 3]
      out[:, qadr + 3 : qadr + 7] = lie.quat_integrate(
          qpos[:, qadr + 3 : qadr + 7], qvel[:, vadr + 3 : vadr + 6], dt)
    elif jt == JointType.BALL:
      out[:, qadr : qadr + 4] = lie.quat_integrate(
          qpos[:, qadr : qadr + 4], qvel[:, vadr : vadr + 3], dt)
    else:
      out[:, qadr] = qpos[:, qadr] + dt * qvel[:, vadr]
  return out


@tracing.span('physics.step')
def step(m: Model, d: Data, sensors: bool = True) -> Data:
  """One physics step of every env in the batch: the fused forward chain
  and the implicit-damping solve, the sensors (unless ``sensors`` is
  False), then semi-implicit Euler integration.  Span ``physics.step``
  (the chain's stages nest in it), counter ``physics.substeps``."""
  tracing.count('physics.substeps')
  _fp32()
  d, qacc_i = _ff.forward_lanes(m, d, implicit=True)
  if sensors:
    with tracing.span('physics.sensors'):
      d = _sensors.sensordata(m, d)
  with tracing.span('physics.integrate'):
    h = m.opt.timestep
    qvel = d.qvel + h * qacc_i
    qpos = _integrate_pos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, qacc=qacc_i, time=d.time + h)
