"""The port's Go2 getup rollout on the full-collision scene against the
benchmark's frozen copy of it, through the cell itself
(``go2_getup.rollout``: ``benchmark/generators/rollout_getup.py``, its
checks and limits) at 4 envs on the CPU: the reset drawn from a seed
(drops and the 125 settle substeps), then the served policy's checked
control steps, the port in float32 and in float64, each held to the
frozen stack in float64 and float32.  On the CPU both run the same plain
code, so no env leaves the reference in the port's own precision.  Also
the scene's sizes as the port lays them out against the kernel shapes
the Go2 configurations state."""

import functools

import pytest
import torch

from benchmark import common, run

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


@pytest.mark.parametrize('config, env', [
    ('go2_getup', 'Go2Getup'), ('go2_joystick', 'Go2JoystickFlatTerrain')])
def test_scene_sizes_match_the_configuration(config, env):
  """The contact slots and constraint rows a substep carries, from the
  model's static layout, and the K1 / K4 shapes the configuration names:
  the full-collision scene's five pair groups (4 + 2 × 26 + 6 + 24 + 70
  slots; 56 at condim 3 × 4 pyramid rows, 100 at condim 1, 18
  friction-loss rows, 24 limit rows) and the joystick's four feet."""
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.physics import constraint

  cfg = common.load_json('configs', config)
  m = envs.load(env, device='cpu').model
  k = cfg['kernels']
  assert m.nv == k['K1']['n'] == k['K4']['nv']
  assert constraint.layout_cached(m).nefc == k['K4']['R']
  assert m.ncon == {'go2_getup': 156, 'go2_joystick': 4}[config]
  if 'scene' in cfg:
    assert (m.ncon, m.nv) == (cfg['scene']['contact_slots'],
                              cfg['scene']['nv'])
    assert cfg['scene']['efc_rows'] == k['K4']['R']
