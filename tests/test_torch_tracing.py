"""The port's spans and counters (``rsr_mjx_tpu_torch.utils.tracing``) on
the CPU: nesting and self time, the ring's medians with calls under the
profiler left out, the span on the profiler's clock and off it,
``linalg_kernels.LAUNCHES`` as the registry's counter group, the
spans of one training-stack control step of cube-push, of the served
policy and of ``get_action``, and the narrow phase's span inside the
assembly's."""

import os
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.utils import tracing
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PPO = os.path.join(ROOT, 'logs', 'cube_ppo_15M_r4', 'final_params.pkl')
STAGES = ('physics.kinematics', 'physics.smooth', 'physics.assembly',
          'physics.solve', 'physics.implicit', 'physics.integrate')


@pytest.fixture(autouse=True)
def fresh():
  tracing.reset()
  yield
  tracing.reset()


def fake_clock(monkeypatch, ticks_ms):
  """perf_counter_ns reading ``ticks_ms``, one a read (a span reads the
  clock as it opens and as it closes)."""
  it = iter([int(t * 1e6) for t in ticks_ms])
  monkeypatch.setattr(tracing, 'time',
                      types.SimpleNamespace(perf_counter_ns=lambda: next(it)))


def back_to_back(durations_ms):
  """The clock's reads for spans of ``durations_ms`` one after another."""
  ticks, t = [], 0
  for d in durations_ms:
    ticks += [t, t + d]
    t += d + 1
  return ticks


def test_nesting_and_self_time(monkeypatch):
  # outer 0..100 ms holds inner 10..40 and a decorated call 50..70
  fake_clock(monkeypatch, [0, 10, 40, 50, 70, 100])
  leaf = tracing.span('t.leaf')(lambda x: x + 1)
  with tracing.span('t.outer'):
    with tracing.span('t.inner'):
      pass
    assert leaf(1) == 2
  s = tracing.snapshot()['spans']
  assert s['t.outer']['total_s'] == pytest.approx(0.1)
  assert s['t.outer']['self_s'] == pytest.approx(0.05)
  assert s['t.inner']['self_s'] == s['t.inner']['total_s'] == (
      pytest.approx(0.03))
  assert s['t.leaf']['median_self_ms'] == pytest.approx(20.0)
  assert s['t.outer']['calls'] == s['t.leaf']['calls'] == 1


def test_threads_keep_their_own_stack():
  """A span in another thread is no child of a span open in this one."""
  def work():
    with tracing.span('t.thread'):
      pass

  with tracing.span('t.main'):
    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=30)
  assert not th.is_alive()
  s = tracing.snapshot()['spans']
  assert s['t.main']['self_s'] == s['t.main']['total_s']
  assert s['t.thread']['calls'] == 1


def test_ring_median_leaves_out_profiled_calls(monkeypatch):
  """300 calls of 1..300 ms, then 5 of 10 s under the profiler (each
  beside a span called only there): the ring keeps the newest 256, of
  which 251 unprofiled (50..300 ms)."""
  fake_clock(monkeypatch, back_to_back(list(range(1, 301))
                                       + [10_000, 1] * 5))
  for _ in range(300):
    with tracing.span('t.ring'):
      pass
  with profile(activities=[ProfilerActivity.CPU]):
    for _ in range(5):
      with tracing.span('t.ring'):
        pass
      with tracing.span('t.only_profiled'):
        pass
  s = tracing.snapshot()['spans']
  assert s['t.ring']['calls'] == 305 and s['t.ring']['profiled'] == 5
  assert s['t.ring']['median_ms'] == pytest.approx(175.0)
  assert s['t.ring']['median_self_ms'] == pytest.approx(175.0)
  assert s['t.ring']['total_s'] == pytest.approx(45.15 + 50.0)
  assert s['t.only_profiled']['median_ms'] is None


def test_span_lands_on_the_profiler_clock():
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    with tracing.span('t.on_clock'):
      torch.ones(3).add_(1)
  assert 't.on_clock' in {e.name for e in prof.events()}


def test_no_record_function_off_the_profiler(monkeypatch):
  entered = []
  monkeypatch.setattr(torch.profiler, 'record_function',
                      lambda name: entered.append(name))
  with tracing.span('t.off'):
    pass
  tracing.span('t.off')(lambda: None)()
  assert not torch.autograd._profiler_enabled()
  assert entered == [] and tracing.snapshot()['spans']['t.off']['calls'] == 2


def test_launches_is_the_registry_counter_group():
  assert plk.LAUNCHES is tracing.group('launches')
  plk.LAUNCHES['spd_solve_lanes'] += 3
  tracing.count('launches.newton_lanes_pyr_t', 2)
  c = tracing.snapshot()['counters']
  assert c['launches.spd_solve_lanes'] == 3
  assert plk.LAUNCHES['newton_lanes_pyr_t'] == 2
  plk.LAUNCHES.update(dict.fromkeys(plk.LAUNCHES, 0))
  assert not any(v for k, v in tracing.snapshot()['counters'].items()
                 if k.startswith('launches.'))
  tracing.count('launches.spd_solve_lanes')
  tracing.reset()
  assert plk.LAUNCHES is tracing.group('launches')
  assert set(plk.LAUNCHES) == {'spd_solve_lanes', 'contact_select_lanes',
                               'newton_lanes_pyr_t', '_newton_lanes_core'}
  assert not any(plk.LAUNCHES.values())


def test_cube_push_step_spans():
  """One ``wrap_for_training`` control step of cube-push at B 2 (4
  substeps) and the served policy on its observation."""
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.train import networks

  env0 = envs.load('AirbotCubePushTrain', device='cpu', max_contacts=24)
  env = wrappers.wrap_for_training(env0, episode_length=10, num_envs=2)
  policy = networks.make_policy(*networks.load_ppo_params(PPO), 'cpu')
  with torch.no_grad():
    state = env.reset(torch.Generator().manual_seed(0))
    tracing.reset()
    state = env.step(state, policy(state.obs))
  snap = tracing.snapshot()
  s, c = snap['spans'], snap['counters']
  assert s['env.step']['calls'] == 1 and 'env.reset' not in s
  assert s['policy.act']['calls'] == 1
  assert s['physics.step']['calls'] == c['physics.substeps'] == 4
  for name in STAGES:
    assert s[name]['calls'] == 4, name
  assert s['physics.sensors']['calls'] == 1  # the last substep's
  assert 0 < s['env.step']['self_s'] == pytest.approx(
      s['env.step']['total_s'] - s['physics.step']['total_s'])
  stages = sum(s[n]['total_s'] for n in STAGES + ('physics.sensors',))
  assert s['physics.step']['self_s'] == pytest.approx(
      s['physics.step']['total_s'] - stages)
  # CPU tensors: the plain versions, no kernel launched
  assert not any(v for k, v in c.items() if k.startswith('launches.'))


def test_get_action_span_and_the_loop_log():
  from rsr_mjx_tpu_torch import deploy, envs
  from rsr_mjx_tpu_torch.deploy import control_loop

  pi = deploy.PolicyInference(
      PPO, envs.load('AirbotCubePushTrain', device='cpu'),
      action_log_path=None, device='cpu')
  for _ in range(3):
    pi.get_action(np.zeros(23, np.float32))
  assert tracing.snapshot()['spans']['deploy.get_action']['calls'] == 3
  logged = []
  control_loop.log_policy_time(logged.append)
  assert len(logged) == 1 and logged[0].startswith('deploy.get_action: calls 3')


def test_collision_span_nests_in_assembly():
  """On the full-collision scene: ``physics.collision`` (the narrow
  phase) opens once a substep inside ``physics.assembly``, on the clock
  and on the profiler's."""
  from rsr_mjx_tpu_torch import envs, physics

  env = envs.load('Go2Getup', device='cpu')
  d = physics.make_data(env.model, 2)
  qpos = torch.tensor(env.keyframe_qpos('home'), dtype=d.qpos.dtype)
  d = d.replace(qpos=qpos.expand(2, -1).clone())
  with torch.no_grad():
    d = physics.step(env.model, d, sensors=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
      physics.step(env.model, d, sensors=False)
  s = tracing.snapshot()['spans']
  assert s['physics.collision']['calls'] == s['physics.assembly']['calls'] == 2
  assert s['physics.assembly']['self_s'] == pytest.approx(
      s['physics.assembly']['total_s'] - s['physics.collision']['total_s'])
  ev = [e for e in prof.events() if e.name == 'physics.collision']
  assert len(ev) == 1
  parents, p = [], ev[0].cpu_parent
  while p is not None:
    parents.append(p.name)
    p = p.cpu_parent
  assert parents[:1] == ['physics.assembly'] and 'physics.step' in parents

