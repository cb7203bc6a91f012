"""Kernel K5 (``linalg_kernels.assemble_rows``): the generic route's contact
rows of the constraint assembly.

On the CPU the assembly takes K5's plain version.  These tests hold that
route to the assembly as it was before K5 (the benchmark's frozen copy of
the port, ``benchmark/reference/frozen``), bit for bit in float32 and
float64: the Go2 joystick (4 slots, 58 rows), the Go2 full-collision scene
of getup (156 slots at condim 1 and 3, 366 rows), that scene under the Go2
domain randomiser (a per-env floor friction, so per-env contact
parameters beside shared ones) and cube-push's generic route (K2's 24
selected contacts: per-env parameters and dof masks).  Also the static row
table against ``constraint.layout``, the input checks of the wrapper, and
the gradient of ``AssembleRows`` (the tuning recomputation's route)
against autograd through the former assembly.  The card test holds the
kernel to the plain version on the card: J bit for bit (up to the sign of
a zero), D within 4 ulp (``powf`` of another CUDA toolkit than torch's),
aref within the rounding of the nv-term sum J·qvel, which the kernel adds
in dof order and torch in its own (``chip_smoke.k5_aref_tolerance``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark.reference.frozen.physics import lanes_assembly as frozen
from rsr_mjx_tpu_torch import envs
from rsr_mjx_tpu_torch.envs import wrappers
from rsr_mjx_tpu_torch.envs.go2 import randomize as go2_randomize
from rsr_mjx_tpu_torch.physics import constraint as C
from rsr_mjx_tpu_torch.physics import lanes_assembly as A
from rsr_mjx_tpu_torch.physics import lanes_kinematics as K
from rsr_mjx_tpu_torch.physics import linalg_kernels as lk
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

B = 4
CASES = ('joystick', 'getup', 'getup_dr', 'cube_push')
ENVS = {'joystick': 'Go2JoystickFlatTerrain', 'getup': 'Go2Getup',
        'getup_dr': 'Go2Getup', 'cube_push': 'AirbotCubePushTrain'}


def _model(case, dtype, device='cpu'):
  m = envs.load(ENVS[case], device=device, dtype=dtype).model
  if case == 'getup_dr':
    gen = torch.Generator(device=device).manual_seed(7)
    m = go2_randomize.domain_randomize(m, gen, B)
  return m


def _state(case, m, dtype, device='cpu', n=B):
  """(qpos, qvel) lanes (nq, n), (nv, n).  Go2: the base dropped to 5-30 cm
  with the joints bent at random, so that feet, shins and the body touch
  the floor; cube-push: a reset (the cube on the table) with random
  joint velocities."""
  g = np.random.default_rng(3)
  if case == 'cube_push':
    env = wrappers.wrap_for_training(
        envs.load(ENVS[case], device=device, dtype=dtype), num_envs=n)
    d = env.reset(torch.Generator(device=device).manual_seed(5)).data
    qpos = d.qpos.t().contiguous()
  else:
    q = np.tile(m.qpos0.cpu().numpy().astype(np.float64).reshape(-1, m.nq)[0],
                (n, 1))
    q[:, 2] = g.uniform(0.05, 0.3, n)
    q[:, 7:] += g.normal(0.0, 0.5, (n, m.nq - 7))
    qpos = torch.tensor(q.T, dtype=dtype, device=device).contiguous()
  qvel = torch.tensor(g.normal(0.0, 1.0, (m.nv, n)), dtype=dtype,
                      device=device)
  return qpos, qvel


def _leaves(m, qpos, qvel):
  kout = K.kinematics_lanes(m, K.gather_kin(m, qpos))
  return C.gather_leaves(m, qpos, qvel, kout.cdof, kout.cdof_anchor,
                         kout.geom_xpos, kout.geom_xmat)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['float32', 'float64'])
@pytest.mark.parametrize('case', CASES)
def test_plain_rows_match_the_former_assembly(case, dtype):
  """assemble_lanes(basis=False), its contact rows from K5's plain version,
  against the assembly before K5 on the same leaves: every output equal."""
  m, m_old = _model(case, dtype), _model(case, dtype)
  lv = _leaves(m, *_state(case, m, dtype))
  new = A.assemble_lanes(m, lv, basis=False)
  old = frozen.assemble_lanes(m_old, lv, basis=False)
  lay = C.layout_cached(m)
  assert new[0].shape == (m.nv, lay.nefc, B)
  for name, a, b in zip(('J', 'aref', 'D', 'floss', 'dist'), new, old):
    assert a.dtype == b.dtype and torch.equal(a, b), name
  # contacts in touch, and per-env parameters where the case has them
  assert (new[4] < 0).sum() >= B
  if case == 'getup_dr':
    assert lv.con_friction.shape[-1] == B and lv.con_solref.shape[-1] == 1


@pytest.mark.parametrize('case', ('joystick', 'getup', 'cube_push'))
def test_row_table_follows_the_layout(case):
  """contact_row_table: the condim groups in ascending order, each
  contact's rows after the previous contact's, 1 row at condim 1 and
  2 (condim - 1) above, n_con rows in all; the slots of all contacts (or
  the nsel selected ones) once each."""
  m = _model(case, torch.float32)
  lay = C.layout_cached(m)
  tab = A.contact_row_table(m)
  slots, first, cds = tab.T
  nsel = C._selection_size(m)
  condims = C._condims_static(m)
  rows = np.where(cds == 1, 1, 2 * (cds - 1))
  assert tab.dtype == np.int32
  assert np.all(np.diff(cds) >= 0)
  np.testing.assert_array_equal(first, np.concatenate([[0],
                                                       np.cumsum(rows)[:-1]]))
  assert rows.sum() == lay.n_con
  assert np.all(lay.kind[lay.nefc - lay.n_con:] == C.CONTACT)
  assert lay.nefc - lay.n_con == lay.n_eq + lay.n_fri + lay.n_lim
  if nsel:
    np.testing.assert_array_equal(slots, np.arange(nsel))
  else:
    np.testing.assert_array_equal(np.sort(slots), np.arange(m.ncon))
    np.testing.assert_array_equal(cds, condims[slots])
  expect = {'joystick': (4, 16, {3}), 'getup': (156, 324, {1, 3}),
            'cube_push': (24, 144, {4})}[case]
  assert (len(tab), lay.n_con, set(cds.tolist())) == expect


def _recorded_rows(m, lv):
  """The arguments the assembly hands ``linalg_kernels.contact_rows``."""
  calls = []
  real = lk.contact_rows
  lk.contact_rows = lambda *a: (calls.append(a), real(*a))[1]
  try:
    A.assemble_lanes(m, lv, basis=False)
  finally:
    lk.contact_rows = real
  assert len(calls) == 1
  return calls[0]


def test_wrapper_checks_its_inputs():
  """Shapes, the trailing env axis (1 or B), dtype and nv are checked
  before either route runs."""
  m = _model('getup', torch.float32)
  lv = _leaves(m, *_state('getup', m, torch.float32))
  spec, imp, *args = _recorded_rows(m, lv)
  lk.assemble_rows(spec, imp, *args)  # the recorded call itself passes
  bad = list(args)
  bad[6] = args[6].expand(-1, -1, 3).contiguous()  # friction over 3 envs
  with pytest.raises(ValueError, match='friction: trailing axis 3'):
    lk.assemble_rows(spec, imp, *bad)
  bad = list(args)
  bad[3] = args[3][:-1]  # one slot short
  with pytest.raises(ValueError, match='pos: shape'):
    lk.assemble_rows(spec, imp, *bad)
  bad = [a.half() for a in args]
  with pytest.raises(TypeError):
    lk.assemble_rows(spec, imp, *bad)
  lk.check_assemble_rows_fits(64)
  with pytest.raises(ValueError, match='nv <= 64'):
    lk.check_assemble_rows_fits(65)


@pytest.mark.parametrize('case', ('getup', 'cube_push'))
def test_gradient_matches_the_former_assembly(case):
  """With grad on, the contact rows go through AssembleRows (forward K5 or
  its plain version, backward the VJP of the plain version): the
  gradient of the whole generic assembly with respect to the dynamic
  leaves and the contact parameters equals autograd through the assembly
  before K5, in float64 at B 2."""
  dtype, n = torch.float64, 2
  m, m_old = _model(case, dtype), _model(case, dtype)
  qpos, qvel = _state(case, m, dtype, n=n)
  base = _leaves(m, qpos, qvel)
  names = ('qvel', 'cdof', 'cdof_anchor', 'geom_xpos', 'geom_xmat',
           'con_friction', 'con_solref', 'con_solimp', 'con_invweight')
  g = torch.Generator().manual_seed(11)
  outs = {}
  for tag, mm, fn in (('new', m, A.assemble_lanes),
                      ('old', m_old, frozen.assemble_lanes)):
    ins = {k: getattr(base, k).detach().clone().requires_grad_(True)
           for k in names}
    lv = base._replace(**ins)
    with torch.enable_grad():
      J, aref, D = fn(mm, lv, basis=False)[:3]
    g.manual_seed(11)
    cts = [torch.randn(x.shape, generator=g, dtype=dtype) for x in (J, aref, D)]
    loss = sum((c * x).sum() for c, x in zip(cts, (J, aref, D)))
    outs[tag] = torch.autograd.grad(loss, [ins[k] for k in names],
                                    allow_unused=True)
  for k, a, b in zip(names, outs['new'], outs['old']):
    if b is None:
      assert a is None or not a.any(), k
      continue
    torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=k)
  assert any(o is not None and o.abs().sum() > 0 for o in outs['new'][5:])


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_kernel_matches_plain_on_card(case):
  """K5 against its plain version on the card at B 2048: J bit for bit,
  D within 4 ulp, aref within the rounding of J·qvel's sum."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  n = 2048
  m = _model(case, torch.float32, 'cuda') if case != 'getup_dr' else (
      _model('getup', torch.float32, 'cuda'))
  if case == 'getup_dr':
    m = go2_randomize.domain_randomize(
        m, torch.Generator(device='cuda').manual_seed(7), n)
  lv = _leaves(m, *_state(case, m, torch.float32, 'cuda', n))
  spec, imp, *args = _recorded_rows(m, lv)
  ins = args[:11]
  kern = lk._fresh_rows(spec, ins[0])
  plain = lk._fresh_rows(spec, ins[0])
  lk.assemble_rows(spec, imp, *ins, *kern)
  lk.assemble_rows_plain(spec, imp, *ins, *plain)
  assert torch.equal(kern[0], plain[0]) and torch.equal(kern[3], plain[3])
  u = 2.0**-24
  assert bool(((kern[2] - plain[2]).abs() <= 4 * u * plain[2].abs()).all())
  tol = chip_smoke.k5_aref_tolerance(torch, spec, ins, plain[0], plain[1])
  assert bool(((kern[1] - plain[1]).abs() <= tol).all())

