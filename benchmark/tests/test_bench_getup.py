"""The Go2 getup cell (``go2_getup.rollout``) on the CPU:

- the frozen getup env held to what the JAX package computed
  (``benchmark/reference/jax_fixtures/go2_getup.npz``, made on the CPU by
  the script stored in it: 16 envs from JAX's reset of seeded keys, its
  draws before the settle and the 125 settle substeps, then three control
  steps of seeded actions, the observation noise off), as
  ``test_bench_jax_fixtures.py`` holds the other two: the reset from
  JAX's draws and each control step from the JAX state before it, every
  env within ``common.SPLIT`` of an entry of JAX's outputs where the
  frozen stack in float64 and float32 agree within it, or where the
  float64 stack from the state (for the reset, the draws) with its qpos
  moved by a millionth reaches them; dones equal.  A settle of 125
  substeps from a drop parts the two precisions themselves in some envs
  (the test's draws: 3 of 16, by up to 1.1 of an entry);
- the cell run tiny (4 envs, checked steps drawn from 1-3) through the
  harness: ``correct``, and the two faults planted under the timed path
  (a step that returns its state, half the envs unstepped) turning it
  false;
- the probe's attribution of device time to the spans open at each
  launch;
- the reference's physics step replayed from CUDA graphs
  (``FrozenGraphs``): the tables its graphs read held while they live,
  and on a card the replays equal to the eager step bit for bit.
"""

import gc
import math
import types

import numpy as np
import pytest
import torch

from benchmark import common, run
from benchmark.generators import rollout_getup
from benchmark.reference import follow
from benchmark.tests.test_bench_jax_fixtures import from_jax, outputs

CELL = 'go2_getup.rollout'
SEED = 2**31 + 12345
TINY = {'serve_envs': 4, 'checked_to': 4, 'warmup_steps': 1}


def frozen_stack(dtype, init):
  from benchmark.reference.frozen.envs import wrappers
  from benchmark.reference.frozen.envs.go2 import getup

  cfg = common.load_json('configs', 'go2_getup')
  env0 = getup.Getup(device='cpu', dtype=dtype,
                     config_overrides={'noise_config.level': 0.0})
  env0.sample_init = lambda generator, batch: {k: v.to(dtype)
                                               for k, v in init.items()}
  return wrappers.wrap_for_training(
      env0, episode_length=cfg['episode_length'],
      num_envs=init['qpos'].shape[0])


def held(jax_out, out, run64):
  """The envs off JAX's outputs by the cells' rule that no witness
  explains."""
  off = common.off_envs(jax_out, out[torch.float64], out[torch.float32])
  return off & ~follow.reached(run64, jax_out, off, common.SPLIT)


def test_getup_agrees_with_jax():
  from benchmark.reference.jax_fixtures import inputs

  fx = dict(np.load(inputs.path('go2_getup')))
  init = {k: torch.from_numpy(fx[f'init_{k}']) for k in ('qpos', 'qvel')}
  f64, f32 = torch.float64, torch.float32
  stacks = {dt: frozen_stack(dt, init) for dt in (f64, f32)}
  g = lambda: torch.Generator().manual_seed(0)
  with torch.no_grad():
    states = {dt: env.reset(g()) for dt, env in stacks.items()}

    def moved_reset(seed):
      env = frozen_stack(f64, follow.moved_init(
          {k: v.double() for k, v in init.items()}, seed))
      return follow.flat_obs(env.reset(g()).obs).numpy()

  flat = {dt: follow.flat_obs(s.obs).double().numpy()
          for dt, s in states.items()}
  assert not held(fx['obs'][0], flat, moved_reset).any()
  for k in range(fx['actions'].shape[0]):
    out, start = {}, {}
    action = torch.from_numpy(fx['actions'][k])
    for dt, env in stacks.items():
      start[dt] = from_jax(states[dt], fx, '', k)
      with torch.no_grad():
        n = env.step(start[dt], action.to(dt))
      out[dt] = outputs(n)
      np.testing.assert_array_equal(n.done.numpy() > 0.5,
                                    fx['done'][k] > 0.5)
      states[dt] = n
    jax_out = np.concatenate([fx['obs'][k + 1], fx['reward'][k][:, None]],
                             axis=1)
    off = held(jax_out, out, lambda seed: outputs(follow.step(
        stacks[f64], start[f64], action, f64, moved=seed)))
    assert not off.any(), (k, np.nonzero(off)[0])


@pytest.fixture(autouse=True, scope='module')
def own_tmpdir(tmp_path_factory):
  import tempfile

  old = tempfile.tempdir
  tempfile.tempdir = str(tmp_path_factory.mktemp('bench'))
  yield
  tempfile.tempdir = old


def tiny_run(limits=None, trace=False):
  ctx = run.context(CELL, SEED, 1.0, trace, device='cpu', sizes=TINY)
  if limits is not None:
    ctx.limits = limits
  return run.execute(ctx, t_start=0.0)


@pytest.fixture(scope='module')
def sound():
  return tiny_run()


def test_tiny_run_is_correct(sound):
  spec = common.manifest()
  names = {m['name'] for m in common.metrics_of(spec, 'end_to_end', CELL)}
  assert set(sound['metrics']) == names
  assert all(math.isfinite(m['value']) for m in sound['metrics'].values())
  assert sound['attempted'] > 0 and sound['failed'] == 0
  assert sound['correct'], sound['checks']


def _unchanged(monkeypatch):
  from rsr_mjx_tpu_torch.envs.go2 import getup

  monkeypatch.setattr(getup.Getup, 'step', lambda self, s, a: s)


def _half(monkeypatch):
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.envs.go2 import getup

  real = getup.Getup.step

  def half(self, s, a):
    n = real(self, s, a)
    keep = torch.arange(a.shape[0]) >= a.shape[0] // 2
    pick = lambda x, y: (wrappers._where(keep.to(x.device), y, x)
                         if x.shape[:1] == keep.shape else x)
    return n.replace(data=wrappers.tree_map(pick, n.data, s.data),
                     obs=wrappers.tree_map(pick, n.obs, s.obs))

  monkeypatch.setattr(getup.Getup, 'step', half)


@pytest.mark.parametrize('fault', [_unchanged, _half])
def test_planted_faults_fail(fault, sound, monkeypatch):
  """Limits ten times what the sound tiny run reads (the cell's own are
  set at its full size), so that a fault has something to fail."""
  limits = {k: max(10 * c['value'], 1e-9)
            for k, c in sound['checks'].items()}
  fault(monkeypatch)
  line = tiny_run(limits)
  assert not line['correct'], line['checks']


def _host(name, start, end, id_=0):
  return types.SimpleNamespace(
      name=name, id=id_, device_type=torch.autograd.DeviceType.CPU,
      time_range=types.SimpleNamespace(start=start, end=end))


def _device(name, id_, us, annotation=False):
  return types.SimpleNamespace(
      name=name, id=id_, device_type=torch.autograd.DeviceType.CUDA,
      is_user_annotation=annotation,
      time_range=types.SimpleNamespace(start=1000, end=1000 + us))


def test_stage_attribution():
  """A device operation counts in every span open on the host at its
  launch (found by its correlation id), once each, and in the substep's
  whole; spans drawn on the device's timeline are no work; the probe's
  ms are per substep."""
  events = [
      _host('physics.assembly', 0, 100), _host('physics.collision', 10, 50),
      _host('aten::mul', 12, 20), _host('cudaLaunchKernel', 14, 15, 1),
      _host('cudaLaunchKernel', 30, 31, 2),   # a library's, no ATen op
      _host('cudaLaunchKernel', 60, 61, 3),   # the assembly's own
      _host('physics.solve', 110, 200),
      _host('cudaLaunchKernelExC', 120, 121, 4),
      _host('cudaMemsetAsync', 300, 301, 5),  # outside every span
      _device('mul_kernel', 1, 30.0),
      _device('newton_generic_kernel', 2, 10.0),
      _device('add_kernel', 3, 20.0),
      _device('newton_generic_kernel', 4, 100.0),
      _device('Memset', 5, 4.0), _device('physics.solve', 6, 90.0, True),
  ]
  got = rollout_getup.stage_ms(events, 2)
  assert got == pytest.approx({
      'physics.collision': 0.02, 'physics.assembly': 0.03,
      'physics.solve': 0.05, 'substep': 0.082})
  assert rollout_getup.stage_ms(events[:9], 2) is None
  # off a card the probe reads nothing, and the readers give None
  ctx = types.SimpleNamespace(device='cpu')
  assert rollout_getup.probe(ctx, None, None) is None
  for name in ('collision_device_ms_per_substep.getup',
               'assembly_device_ms_per_substep.getup'):
    out = common.Outcome({}, [], 1, 0, 0, context={'trace': {
        'busy_s': 0.0, 'stages': None}})
    reader = common.load_file('metrics', name)
    assert reader.read(types.SimpleNamespace(cfg=common.load_json(
        'configs', 'go2_getup')), out) is None


def test_graph_tables_held_while_bound():
  """Within ``getup_reference`` the frozen kernels' tables that a graph
  reads sit in unbounded caches; after it the module's own are back."""
  from benchmark.reference.frozen.physics import linalg_kernels as ref_lk

  own = {k: getattr(ref_lk, k) for k in rollout_getup.TABLES}
  with rollout_getup.getup_reference():
    for k in rollout_getup.TABLES:
      assert getattr(ref_lk, k) is not own[k]
      assert getattr(ref_lk, k).cache_info().maxsize is None
  assert {k: getattr(ref_lk, k) for k in rollout_getup.TABLES} == own


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA card')
  return 'cuda'


def card_rollout(after=lambda k: None):
  """The frozen getup stack in float32 at 64 envs on the card: the reset
  (its drops and 125 settle substeps) and 4 control steps of seeded
  actions, ``after(k)`` called after step ``k``; [(obs, reward, qpos,
  qvel)] of each state."""
  from benchmark.reference.frozen.envs import wrappers
  from benchmark.reference.frozen.envs.go2 import getup

  env0 = getup.Getup(device='cuda', dtype=torch.float32)
  env = wrappers.wrap_for_training(env0, episode_length=300, num_envs=64)
  g = torch.Generator(device='cuda').manual_seed(SEED)
  actions = torch.rand((4, 64, env0.action_size), generator=g,
                       device='cuda') * 2 - 1
  keep = lambda s: (follow.flat_obs(s.obs).cpu(), s.reward.cpu(),
                    s.data.qpos.cpu(), s.data.qvel.cpu())
  with torch.no_grad():
    state = env.reset(g)
    out = [keep(state)]
    for k, a in enumerate(actions):
      state = env.step(state, a)
      out.append(keep(state))
      after(k)
  return out


@pytest.mark.cuda
def test_card_replay_equals_eager(cuda_device):
  """Replayed from ``FrozenGraphs``, the reset and the control steps give
  the eager step's numbers bit for bit, though between control steps 2
  and 3, whose substeps replay graphs captured before, the tables of 40
  other layouts are made, the garbage collected and the allocator's small
  blocks filled with NaN."""
  from benchmark.reference.frozen import physics as ref_physics
  from benchmark.reference.frozen.physics import linalg_kernels as ref_lk

  eager = card_rollout()
  junk, captured = [], []

  def churn(k):
    if k != 1:
      return
    captured.append(len(ref_physics.step.graphs))
    for i in range(2000, 2040):
      ref_lk._row_masks((i % 3,) * (i - 1900), torch.device('cuda'),
                        torch.float32)
      ref_lk._slot_pair(((i - 1900, 4, 0),), torch.device('cuda'))
    gc.collect()
    junk.extend(torch.full((n,), float('nan'), device='cuda')
                for n in (64, 128, 256, 512, 1024) for _ in range(2000))

  with rollout_getup.getup_reference():
    replayed = card_rollout(churn)
    # steps 2 and 3 captured nothing: every substep of theirs replayed
    assert captured == [len(ref_physics.step.graphs)] and junk
  for a, b in zip(eager, replayed):
    for x, y in zip(a, b):
      assert torch.equal(x, y)
