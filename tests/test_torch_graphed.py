"""The physics substep replayed from a CUDA graph (``physics/graphed.py``).

On the CPU the step runs eagerly; the tests here emulate a graph with
``torch_testing.Rerun``, which runs the captured function again at each
replay and writes its outputs where the capture left them, as a graph's
kernels do.  That
reaches the whole of the module but the CUDA calls: the eligibility rule,
the cache and its keys, the static inputs, the plan that passes inputs
through and copies outputs out, and the counters.  Two more CPU tests hold
the eager substep to what a capture needs: after its first call it reads no
device value on the host and copies no host data in, and it reads no Data
field but ``graphed.INPUTS``.

The tests marked ``cuda`` run on the card: replay bit-equal to the eager
substep over 4 control steps (cube-push at 64 envs: K1 twice, K2, K3;
the Go2 joystick at 64: K4), a held state unchanged by later steps,
``AutoResetWrapper`` across a forced done, and replay after the kernels'
tables of many other layouts were made.  This file imports no JAX, so that
they run where there is a card:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_graphed.py``.
"""

import dataclasses
import gc
import importlib
import weakref

import pytest
import torch

from rsr_mjx_tpu_torch import envs
from rsr_mjx_tpu_torch.envs import wrappers
from rsr_mjx_tpu_torch.physics import graphed
from rsr_mjx_tpu_torch.physics import linalg_kernels as lk
from rsr_mjx_tpu_torch.physics.types import IntegratorType
from rsr_mjx_tpu_torch.utils import cuda_graphs
from rsr_mjx_tpu_torch.utils import tracing
import torch_testing
from torch_testing import one_thread  # noqa: F401  (a fixture)

forward = importlib.import_module('rsr_mjx_tpu_torch.physics.forward')
physics = importlib.import_module('rsr_mjx_tpu_torch.physics')

CUBE, GO2 = 'AirbotCubePushTrain', 'Go2JoystickFlatTerrain'

pytestmark = pytest.mark.usefixtures('one_thread')


@pytest.fixture
def emulated(monkeypatch):
  """The CUDA calls of graphed (``utils/cuda_graphs``) replaced by their
  CPU stand-ins."""
  monkeypatch.setattr(graphed, '_on_card', lambda d: True)
  torch_testing.emulate_cuda_graphs(monkeypatch, graphed._leaves)
  graphed.clear()
  yield
  graphed.clear()


_ENVS = {}


def _env(name):
  if name not in _ENVS:
    _ENVS[name] = envs.load(name, device='cpu')
  return _ENVS[name]


def _state(name, B=2, seed=0):
  env = _env(name)
  return env, env.reset(torch.Generator().manual_seed(seed), B)


def _ctrl(env, B, seed):
  g = torch.Generator().manual_seed(seed)
  return 0.3 * torch.randn((B, env.model.nu), generator=g)


def _substeps(m, d, ctrl, n):
  """n substeps through ``physics.step`` with sensors on the last."""
  for i in range(n):
    d = physics.step(m, d.replace(ctrl=ctrl), sensors=i == n - 1)
  return d


def _assert_same(a, b):
  for x, y in zip(graphed._leaves(a), graphed._leaves(b)):
    assert x.shape == y.shape and torch.equal(x, y)


# ---------------------------------------------------------------------------
# When a substep replays


def _rk4(m):
  return m.replace(opt=dataclasses.replace(m.opt,
                                           integrator=IntegratorType.RK4))


@pytest.mark.parametrize('case, want', [
    ('cpu', 'device'), ('grad', 'grad'), ('uncovered', 'uncovered'),
    ('covered', None)])
def test_eager_reason(case, want, monkeypatch):
  """The CPU, grad mode with a state requiring grad (``FusedRegion``) and
  a model the fused chain does not cover run eagerly; a covered model's
  state on a card replays."""
  env, st = _state(CUBE)
  m, d = env.model, st.data
  if case != 'cpu':
    monkeypatch.setattr(graphed, '_on_card', lambda d: True)
  if case == 'uncovered':
    m = _rk4(m)
  with torch.set_grad_enabled(case == 'grad'):
    if case == 'grad':
      d = d.replace(qvel=d.qvel.clone().requires_grad_(True))
    assert graphed.eager_reason(m, d) == want


def test_grad_mode_alone_replays(monkeypatch):
  """Grad mode with nothing requiring grad replays: the chain would not
  run as ``FusedRegion`` there either."""
  env, st = _state(CUBE)
  monkeypatch.setattr(graphed, '_on_card', lambda d: True)
  with torch.enable_grad():
    assert graphed.eager_reason(env.model, st.data) is None
    p = env.model.numeric['geom_friction']
    m = env.model.replace(geom_friction=p.clone().requires_grad_(True))
    assert graphed.eager_reason(m, st.data) == 'grad'


@pytest.mark.parametrize('case', ['cpu', 'grad', 'uncovered'])
def test_eager_paths_capture_nothing(case, emulated, monkeypatch):
  """Each eager case runs the eager substep: nothing is captured, and the
  uncovered model raises as the eager step does."""
  env, st = _state(CUBE)
  m, d = env.model, st.data
  if case == 'cpu':
    monkeypatch.setattr(graphed, '_on_card', lambda d: False)
  tracing.reset()
  if case == 'uncovered':
    with pytest.raises(NotImplementedError):
      physics.step(_rk4(m), d)
  elif case == 'grad':
    with torch.enable_grad():
      qvel = d.qvel.clone().requires_grad_(True)
      out = physics.step(m, d.replace(qvel=qvel))
    assert out.qvel.requires_grad
  else:
    physics.step(m, d)
  c = tracing.snapshot()['counters']
  assert c['physics.graph_captures'] == c['physics.graph_replays'] == 0
  assert not graphed._CACHE


# ---------------------------------------------------------------------------
# Replay against the eager substep, through the emulated graph


@pytest.mark.parametrize('name', [CUBE, GO2])
def test_replay_equals_eager(name, emulated, monkeypatch):
  """Two control steps replayed equal the eager ones bit for bit, field by
  field; fields the substep passes through are the caller's tensors."""
  env, st = _state(name)
  n = 3
  m, d0 = env.model, st.data
  with torch.no_grad():
    d, e = d0, d0
    for k in range(2):
      ctrl = _ctrl(env, 2, k)
      d = _substeps(m, d, ctrl, n)
      monkeypatch.setattr(graphed, '_on_card', lambda d: False)
      e = _substeps(m, e, ctrl, n)
      monkeypatch.setattr(graphed, '_on_card', lambda d: True)
      _assert_same(d, e)
  # the ctrl handed in comes back as it is, as in the eager step
  out = physics.step(m, d.replace(ctrl=ctrl), sensors=False)
  assert out.ctrl is ctrl and out.sensordata is d.sensordata
  assert out.qpos is not d.qpos


def test_held_state_unchanged(emulated):
  """A state returned by a replay is a copy: later replays leave it as it
  was."""
  env, st = _state(CUBE)
  m, d = env.model, st.data
  with torch.no_grad():
    for k in range(2):
      d = _substeps(m, d, _ctrl(env, 2, k), 2)
    held = d
    kept = [t.clone() for t in graphed._leaves(held)]
    for k in range(2, 5):
      d = _substeps(m, d, _ctrl(env, 2, k), 2)
  for t, c in zip(graphed._leaves(held), kept):
    assert torch.equal(t, c)
  outs = {id(t) for g in graphed._CACHE.values() for gr in g.graphs.values()
          for t in gr.outputs}
  assert not outs & {id(t) for t in graphed._leaves(d)}


# ---------------------------------------------------------------------------
# The cache


def _changed(case, m, d):
  """(model, state, sensors) with one part of the key changed."""
  if case == 'model':
    return m.replace(geom_friction=m.numeric['geom_friction'].clone()), d, True
  if case == 'batch':
    return m, _state(CUBE, B=3)[1].data, True
  if case == 'dtype':
    return (m.to('cpu', torch.float64),
            d.map(lambda x: x.to(torch.float64)), True)
  if case == 'sensors':
    return m, d, False
  if case == 'strides':
    return m, d.replace(qvel=d.qvel.t().contiguous().t()), True
  return m, d, True


@pytest.mark.parametrize('case, groups, graphs', [
    ('same', 1, 1), ('model', 2, 2), ('batch', 2, 2), ('dtype', 2, 2),
    ('sensors', 1, 2), ('strides', 1, 2)])
def test_cache_key(case, groups, graphs, emulated):
  """A model, batch, dtype, sensors or input-layout change makes a new
  entry; the same key replays."""
  env, st = _state(CUBE)
  m, d = env.model, st.data
  tracing.reset()
  with torch.no_grad():
    physics.step(m, d)
    m2, d2, sensors = _changed(case, m, d)
    physics.step(m2, d2, sensors=sensors)
  assert len(graphed._CACHE) == groups
  assert sum(len(g.graphs) for g in graphed._CACHE.values()) == graphs
  c = tracing.snapshot()['counters']
  assert c['physics.graph_captures'] == graphs
  assert c['physics.graph_replays'] == 2 - graphs


def test_lru_frees_old_groups(emulated, monkeypatch):
  """Beyond MAX_GROUPS the least recently used group goes, and its graphs
  with it."""
  monkeypatch.setattr(graphed, 'MAX_GROUPS', 2)
  env, st = _state(CUBE)
  d = st.data
  models = [env.model.replace(
      geom_friction=env.model.numeric['geom_friction'].clone())
            for _ in range(3)]
  refs = []
  with torch.no_grad():
    for m in models[:2]:
      physics.step(m, d)
      refs.append([weakref.ref(g.graph) for gr in graphed._CACHE.values()
                   for g in gr.graphs.values()][-1])
    physics.step(models[0], d)  # the first is now the more recent
    physics.step(models[2], d)
  gc.collect()
  assert len(graphed._CACHE) == 2
  assert refs[0]() is not None and refs[1]() is None
  kept = {id(g.model()) for g in graphed._CACHE.values()}
  assert kept == {id(models[0]), id(models[2])}


def test_lru_frees_old_graphs(emulated, monkeypatch):
  """Beyond MAX_GRAPHS in a group the least recently used graph goes, and
  a key seen again is captured anew: no key runs eagerly."""
  monkeypatch.setattr(graphed, 'MAX_GRAPHS', 2)
  env, st = _state(CUBE)
  m, d = env.model, st.data
  strided = d.replace(qvel=d.qvel.t().contiguous().t())
  tracing.reset()
  with torch.no_grad():
    physics.step(m, d, sensors=False)
    first = [weakref.ref(g.graph) for g in
             next(iter(graphed._CACHE.values())).graphs.values()][0]
    physics.step(m, d, sensors=True)
    physics.step(m, d, sensors=False)  # the first is now the more recent
    physics.step(m, strided, sensors=False)
    (group,) = graphed._CACHE.values()
    assert list(group.graphs) == [graphed.graph_key(d, False),
                                  graphed.graph_key(strided, False)]
    physics.step(m, d, sensors=True)
  gc.collect()
  assert list(group.graphs) == [graphed.graph_key(strided, False),
                                graphed.graph_key(d, True)]
  assert first() is None
  c = tracing.snapshot()['counters']
  assert c['physics.graph_captures'] == 4
  assert c['physics.graph_replays'] == 1


@pytest.mark.parametrize('table', ['row_masks', 'slot_pair'])
def test_kernel_tables_never_evicted(table):
  """The kernels' row masks and slot maps, which a graph reads at their
  addresses, stay the same tensors however many other layouts come."""
  cpu = torch.device('cpu')
  make = {'row_masks': lambda i: lk._row_masks((i % 3,) * i, cpu,
                                               torch.float32),
          'slot_pair': lambda i: lk._slot_pair(((i, 2, 0),), cpu)}[table]
  first = make(1000)
  for i in range(1001, 1041):
    make(i)
  assert make(1000) is first


def test_group_dies_with_its_model(emulated, monkeypatch):
  """The cache holds its model weakly (here with a stand-in that keeps
  no function, as a CUDA graph keeps none)."""
  monkeypatch.setattr(cuda_graphs, 'capture',
                      lambda fn, pool, stream: (object(), fn()))
  env, st = _state(CUBE)
  m = env.model.replace(
      geom_friction=env.model.numeric['geom_friction'].clone())
  with torch.no_grad():
    physics.step(m, st.data)
  assert len(graphed._CACHE) == 1
  del m
  gc.collect()
  assert not graphed._CACHE


def test_counters_in_snapshot(emulated):
  """``physics.graph_captures`` and ``.graph_replays`` in the snapshot:
  two captures a control step's shape, every other substep a replay."""
  env, st = _state(GO2)
  tracing.reset()
  m, d = env.model, st.data
  with torch.no_grad():
    for k in range(3):
      d = _substeps(m, d, _ctrl(env, 2, k), 3)
  c = tracing.snapshot()['counters']
  assert c['physics.substeps'] == 9
  assert c['physics.graph_captures'] == 2
  assert c['physics.graph_replays'] == 7
  assert tracing.snapshot()['spans']['physics.step']['calls'] == 9


# ---------------------------------------------------------------------------
# What a capture needs of the eager substep

@pytest.mark.parametrize('name, randomized', [
    (n, r) for n in (CUBE, GO2, 'Go2Getup', 'Go2JoystickRoughTerrain')
    for r in (False, True)] + [('AirbotTPush', False)])
def test_substep_is_capturable(name, randomized):
  """After its first call the eager substep, with sensors and without,
  reads no device value on the host and copies no host data in: nothing a
  capture would refuse (each path of the fused chain: K2 + K3 at two
  widths, K4 on the flat, full and rough scenes, per-env leaves)."""
  m = _env(name).model
  if randomized:
    m = envs.get_domain_randomizer(name)(
        m, generator=torch.Generator().manual_seed(1), batch_size=2)
  d = physics.make_data(m, 2)
  with torch.no_grad():
    for sensors in (False, True):
      forward._step(m, d, sensors)
      rec = torch_testing.HostOps()
      with rec:
        forward._step(m, d, sensors)
      assert rec.seen == [], sensors


@pytest.mark.parametrize('name', [CUBE, GO2])
def test_substep_reads_only_inputs(name):
  """Every Data field outside ``graphed.INPUTS`` may hold anything: the
  substep's outputs do not change (so a graph needs no other static
  input)."""
  env, st = _state(name)
  m, d = env.model, st.data
  with torch.no_grad():
    d = _substeps(m, d, _ctrl(env, 2, 0), 2)
    other = {f: torch.full_like(getattr(d, f), float('nan'))
             for f in physics.types.DATA_FIELDS if f not in graphed.INPUTS}
    junk = d.replace(**other, contact=dataclasses.replace(
        d.contact, dist=torch.full_like(d.contact.dist, float('nan'))))
    for sensors in (False, True):
      a = forward._step(m, d, sensors)
      b = forward._step(m, junk, sensors)
      for f in physics.types.DATA_FIELDS:
        if getattr(a, f) is getattr(d, f):
          assert getattr(b, f) is getattr(junk, f), f
        else:
          assert torch.equal(getattr(a, f), getattr(b, f)), f
      assert torch.equal(a.contact.dist, b.contact.dist)


# ---------------------------------------------------------------------------
# On the card


def _card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  return torch.device('cuda')


def _eager_mode(monkeypatch, eager: bool):
  monkeypatch.setattr(graphed, '_on_card', (lambda d: False) if eager else
                      (lambda d: d.qpos.is_cuda))


def _card_rollout(name, B, steps, monkeypatch, eager, episode_length=1000,
                  hold=None, after=None):
  """``steps`` control steps of the training stack from one reset, random
  actions from a seeded CPU generator; the states, and ``hold``'s state
  cloned at its step.  ``after(k)``, if given, runs after step k."""
  dev = _card()
  env = wrappers.wrap_for_training(envs.load(name, device=dev),
                                   episode_length=episode_length,
                                   num_envs=B)
  _eager_mode(monkeypatch, eager)
  g = torch.Generator(device=dev).manual_seed(7)
  ga = torch.Generator().manual_seed(8)
  states, held = [], None
  with torch.no_grad():
    state = env.reset(g)
    for k in range(steps):
      a = torch.rand((B, env.action_size), generator=ga) * 2 - 1
      state = env.step(state, a.to(dev))
      states.append(state)
      if k == hold:
        held = wrappers.tree_map(lambda x: x.clone(), state)
      if after is not None:
        after(k)
  torch.cuda.synchronize()
  _eager_mode(monkeypatch, False)
  return states, held


def _flat(state):
  out = []
  wrappers.tree_map(lambda x: out.append(x), state)
  return out


@pytest.mark.cuda
@pytest.mark.parametrize('name', [CUBE, GO2, 'AirbotTPush', 'Go2Getup'])
def test_card_replay_bit_equal(name, monkeypatch):
  """4 control steps at 64 envs, replayed and eager: every tensor of every
  state equal bit for bit; the kernels' launch counts equal; two captures,
  the other substeps replays.  T-push: K3 at width 14; getup: K4 at 366
  rows, and the settle of its reset replayed too."""
  graphed.clear()
  lk.LAUNCHES.update(dict.fromkeys(lk.LAUNCHES, 0))
  eager, _ = _card_rollout(name, 64, 4, monkeypatch, eager=True)
  launches = dict(lk.LAUNCHES)
  lk.LAUNCHES.update(dict.fromkeys(lk.LAUNCHES, 0))
  tracing.reset()
  graph, _ = _card_rollout(name, 64, 4, monkeypatch, eager=False)
  assert dict(lk.LAUNCHES) == launches
  c = tracing.snapshot()['counters']
  caps = c['physics.graph_captures']
  # the settle's first substep may start from another layout: one more
  assert caps == 2 or (name == 'Go2Getup' and caps <= graphed.MAX_GRAPHS)
  assert (c['physics.graph_replays']
          == c['physics.substeps'] - c['physics.graph_captures'])
  for a, b in zip(eager, graph):
    for x, y in zip(_flat(a), _flat(b)):
      assert torch.equal(x, y)


@pytest.mark.cuda
def test_card_held_state_unchanged(monkeypatch):
  """A state held from step 1 is unchanged after steps 2-4."""
  graphed.clear()
  states, held = _card_rollout(CUBE, 64, 5, monkeypatch, eager=False, hold=1)
  for x, y in zip(_flat(states[1]), _flat(held)):
    assert torch.equal(x, y)


@pytest.mark.cuda
def test_card_auto_reset_bit_equal(monkeypatch):
  """Episodes of 2 steps: ``AutoResetWrapper`` restores the first state at
  each done, replayed as eager."""
  graphed.clear()
  eager, _ = _card_rollout(GO2, 64, 5, monkeypatch, eager=True,
                           episode_length=2)
  graph, _ = _card_rollout(GO2, 64, 5, monkeypatch, eager=False,
                           episode_length=2)
  assert bool((graph[1].done > 0).all())
  for a, b in zip(eager, graph):
    for x, y in zip(_flat(a), _flat(b)):
      assert torch.equal(x, y)


@pytest.mark.cuda
def test_card_tables_outlive_other_layouts(monkeypatch):
  """Between steps 2 and 3, the kernels' row masks and slot maps of 40
  other layouts are made, the garbage collected and the allocator's small
  blocks filled with NaN: the replayed states still equal the eager ones
  bit for bit, since nothing a graph reads has been freed."""
  graphed.clear()
  eager, _ = _card_rollout(CUBE, 64, 4, monkeypatch, eager=True)
  junk = []

  def churn(k):
    if k != 1:
      return
    dev = torch.device('cuda')
    for i in range(2000, 2040):
      lk._row_masks((i % 3,) * (i - 1900), dev, torch.float32)
      lk._slot_pair(((i - 1900, 4, 0),), dev)
    gc.collect()
    junk.extend(torch.full((n,), float('nan'), device=dev)
                for n in (64, 128, 256, 512, 1024) for _ in range(2000))

  graph, _ = _card_rollout(CUBE, 64, 4, monkeypatch, eager=False,
                           after=churn)
  assert junk
  for a, b in zip(eager, graph):
    for x, y in zip(_flat(a), _flat(b)):
      assert torch.equal(x, y)
