"""The port's Go2 getup rollout on the full-collision scene against the
benchmark's frozen copy of it, through the cell itself
(``go2_getup.rollout``: ``benchmark/generators/rollout_getup.py``, its
checks and limits) at 4 envs on the CPU: the reset drawn from a seed
(drops and the 125 settle substeps), then the served policy's checked
control steps, the port in float32 and in float64, each held to the
frozen stack in float64 and float32.  On the CPU both run the same plain
code, so no env leaves the reference in the port's own precision.  Also
every benchmark configuration's kernel calls, as one substep of its env
makes them, against the shapes and counts its ``kernels`` entry states."""

import functools

import pytest
import torch

import chip_smoke
from benchmark import common, run
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

CELL = 'go2_getup.rollout'
SEED = 2**31 + 4242
SIZES = {'serve_envs': 4, 'checked_to': 4, 'warmup_steps': 1}


@pytest.fixture(autouse=True, scope='module')
def own_tmpdir(tmp_path_factory):
  import tempfile

  old = tempfile.tempdir
  tempfile.tempdir = str(tmp_path_factory.mktemp('bench'))
  yield
  tempfile.tempdir = old


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['float32', 'float64'])
def test_getup_rollout_matches_the_frozen_copy(dtype, monkeypatch):
  """The port's physics in ``dtype`` (the policy, as served, in float32)."""
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.train import networks

  make_policy = networks.make_policy

  def in_float32(*args, **kwargs):
    act = make_policy(*args, **kwargs)
    return lambda obs: act({k: v.float() for k, v in obs.items()})

  monkeypatch.setattr(envs, 'load', functools.partial(envs.load, dtype=dtype))
  monkeypatch.setattr(networks, 'make_policy', in_float32)
  ctx = run.context(CELL, SEED, 0.0, False, device='cpu', sizes=SIZES)
  line = run.execute(ctx, t_start=0.0)
  assert line['correct'], line['checks']
  checks = {k: c['value'] for k, c in line['checks'].items()}
  assert checks['envs_off'] == 0.0 and checks['done_mismatch'] == 0.0
  assert checks['action_gap'] < 1e-5


B = 3  # envs of the recorded substep
_SUBSTEPS = {}


def _substep_calls(config):
  """The model and the kernel wrappers' calls (``chip_smoke.record_calls``)
  of one eager CPU substep of the configuration's env at B envs."""
  if config not in _SUBSTEPS:
    from rsr_mjx_tpu_torch import envs, physics
    from rsr_mjx_tpu_torch.physics import linalg_kernels as lk

    cfg = common.load_json('configs', config)
    m = envs.load(cfg['env'], device='cpu', **cfg['env_kwargs']).model
    d = physics.make_data(m, B)
    with torch.no_grad():
      calls = chip_smoke.record_calls(lk, lambda: physics.step(m, d))
    _SUBSTEPS[config] = m, calls
  return _SUBSTEPS[config]


@pytest.mark.parametrize('config, kernel', [
    ('cube_push', 'K1'), ('cube_push', 'K2'), ('cube_push', 'K3'),
    ('go2_joystick', 'K1'), ('go2_joystick', 'K4'),
    ('go2_getup', 'K1'), ('go2_getup', 'K4')])
def test_scene_sizes_match_the_configuration(config, kernel):
  """Each kernel a configuration names, as one substep of its env calls
  it: the number of calls and each call's shape, mapped by
  ``chip_smoke.call_shape`` (which ``chip_smoke.py``'s bounds read) to the
  ``shape`` of ``benchmark/roofline`` (which ``kernel_roofline.*`` reads),
  against the configuration's ``kernels`` entry; no other kernel is
  called but K5, once a substep where the rows are generic.  For the Go2
  configurations also the contact slots and
  constraint rows from the model's static layout: the full-collision
  scene's five pair groups (4 + 2 × 26 + 6 + 24 + 70 slots; 56 at condim
  3 × 4 pyramid rows, 100 at condim 1, 18 friction-loss rows, 24 limit
  rows) and the joystick's four feet."""
  from rsr_mjx_tpu_torch.physics import constraint

  cfg = common.load_json('configs', config)
  k = cfg['kernels']
  m, calls = _substep_calls(config)
  called = {chip_smoke.KERNELS[name][0]: (name, c)
            for name, c in calls.items() if c}
  # K5 (the generic contact rows) replaces no TPU kernel and has no
  # roofline: once a substep on the generic route (the Go2
  # configurations), never on cube-push's basis route
  assert len(called.pop('K5', (None, []))[1]) == (0 if 'K3' in k else 1)
  assert set(called) == set(k)
  wrapper, kernel_calls = called[kernel]
  shape = {n: v for n, v in k[kernel].items() if n != 'calls_per_substep'}
  assert len(kernel_calls) == k[kernel]['calls_per_substep']
  for args in kernel_calls:
    assert chip_smoke.call_shape(wrapper, args) == (kernel, shape, B)
  assert m.ncon == {'cube_push': 480, 'go2_getup': 156,
                    'go2_joystick': 4}[config]
  if 'K4' in k:
    assert m.nv == k['K1']['n'] == k['K4']['nv']
    assert constraint.layout_cached(m).nefc == k['K4']['R']
  if 'scene' in cfg:
    assert (m.ncon, m.nv) == (cfg['scene']['contact_slots'],
                              cfg['scene']['nv'])
    assert cfg['scene']['efc_rows'] == k['K4']['R']
