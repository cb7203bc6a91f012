"""Each traffic generator at a tiny size on the CPU, through the kernels' plain
versions: the result line's keys, the precision control failing the
check, and the faults planted under the timed path turning ``correct``
false."""

import math

import pytest
import torch

from benchmark import common, control, run

SEED = 2**31 + 12345
TINY = {
    'cube_push.rollout': {'serve_envs': 4, 'checked_to': 4,
                          'warmup_steps': 1},
    'go2_joystick.train': {'num_envs': 4, 'batch_size': 4,
                           'num_minibatches': 4, 'unroll_length': 3,
                           'num_updates_per_batch': 2,
                           'profiled_minibatches': 2,
                           'sized_at_env_steps_per_s': 48},
}


@pytest.fixture(autouse=True, scope='module')
def own_tmpdir(tmp_path_factory):
  """The action log and the starting checkpoint live under the temporary
  folder; test processes running side by side each get their own."""
  import tempfile

  old = tempfile.tempdir
  tempfile.tempdir = str(tmp_path_factory.mktemp('bench'))
  yield
  tempfile.tempdir = old


def tiny_run(cell, trace=False, limits=None, seconds=1.0):
  ctx = run.context(cell, SEED, seconds, trace, device='cpu',
                    sizes=TINY[cell])
  if limits is not None:
    ctx.limits = limits
  return run.execute(ctx, t_start=0.0)


def check_line(line, spec_metrics, trace):
  assert list(line)[-1] == 'checks'
  assert {'correct', 'attempted', 'failed', 'metrics', 'device'} <= set(line)
  assert line['device']['platform'] == 'gpu'
  assert line['attempted'] > 0 and line['failed'] == 0
  for name, m in line['metrics'].items():
    assert name in spec_metrics and math.isfinite(m['value']), name
  if trace:
    assert {'busy_s', 'window_s'} <= set(line['device'])
  for c in line['checks'].values():
    assert set(c) == {'value', 'limit'}


@pytest.mark.parametrize('cell', sorted(TINY))
def test_tiny_run(cell):
  spec = common.manifest()
  names = {m['name'] for m in common.metrics_of(spec, 'end_to_end', cell)}
  line = tiny_run(cell, trace=False)
  check_line(line, names, False)
  assert set(line['metrics']) == names
  if cell == 'go2_joystick.train':
    # its limits hold at the table's size (a minibatch of 5120 rows); a
    # loss over 12 rows sits near 0, so its relative gaps read higher
    assert all(math.isfinite(c['value']) for c in line['checks'].values())
  else:
    assert line['correct'], line['checks']


def test_tiny_traced_run():
  spec = common.manifest()
  cell = 'cube_push.rollout'
  names = {m['name'] for m in common.metrics_of(spec, 'per_layer', cell)}
  line = tiny_run(cell, trace=True)
  check_line(line, names, True)
  # on the CPU no operation runs on a device: the device metrics are
  # silent, not 0
  assert not line['metrics']


@pytest.mark.parametrize('cell', ['cube_push.rollout'])
def test_lower_precision_fails(cell):
  """The reference in TF32 (its matmul inputs rounded to TF32's mantissa)
  in the program's place fails the cell's limits; the program passes."""
  limits = common.load_json('limits', cell)
  out = control.readings(cell, [SEED], 1.0, 'cpu', TINY[cell])
  assert all(out['program'][k] <= v for k, v in limits.items()), out
  assert any(out['control'][k] > v for k, v in limits.items()), out


@pytest.mark.cuda
def test_lower_precision_fails_training(cuda_device):
  """The SGD steps in TF32 on the card fail the train cell's limits."""
  cell = 'go2_joystick.train'
  limits = common.load_json('limits', cell)
  out = control.readings(cell, [SEED], 1.0, cuda_device,
                         dict(TINY[cell], num_envs=256, batch_size=256,
                              num_minibatches=4, unroll_length=20))
  assert any(out['control'][k] > v for k, v in limits.items()), out


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA card')
  return 'cuda'


# -- faults planted under the timed path -----------------------------------


def tiny_limits(cell):
  """Limits ten times what a sound tiny run reads (the cell's own limits
  are set at its full size), so that a fault has something to fail."""
  line = tiny_run(cell)
  return {k: max(10 * c['value'], 1e-9) for k, c in line['checks'].items()}


@pytest.fixture(scope='module')
def rollout_limits():
  return tiny_limits('cube_push.rollout')


@pytest.fixture(scope='module')
def train_limits():
  return tiny_limits('go2_joystick.train')


def _unchanged(monkeypatch):
  from rsr_mjx_tpu_torch.envs.airbot import cube_push

  monkeypatch.setattr(cube_push.AirbotCubePush, 'step', lambda self, s, a: s)


def _half(monkeypatch):
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.envs.airbot import cube_push

  real = cube_push.AirbotCubePush.step

  def half(self, s, a):
    n = real(self, s, a)
    keep = torch.arange(a.shape[0]) >= a.shape[0] // 2
    pick = lambda x, y: (wrappers._where(keep.to(x.device), y, x)
                         if x.shape[:1] == keep.shape else x)
    return n.replace(data=wrappers.tree_map(pick, n.data, s.data),
                     obs=wrappers.tree_map(pick, n.obs, s.obs))

  monkeypatch.setattr(cube_push.AirbotCubePush, 'step', half)


def _one_env(change):
  """A fault in the step of one env of the batch, the last."""

  def plant(monkeypatch):
    from rsr_mjx_tpu_torch.envs.airbot import cube_push

    real = cube_push.AirbotCubePush.step

    def step(self, s, a):
      return change(real(self, s, a), s)

    monkeypatch.setattr(cube_push.AirbotCubePush, 'step', step)

  plant.__name__ = change.__name__
  return plant


def _one_env_unstepped(n, s):
  last = lambda x, y: torch.cat([x[:-1], y[-1:]])
  return n.replace(obs=last(n.obs, s.obs), reward=last(n.reward, s.reward))


def _one_env_done_flipped(n, s):
  done = n.done.clone()
  done[-1] = 1 - done[-1]
  return n.replace(done=done)


def _altered_action(monkeypatch):
  from rsr_mjx_tpu_torch.train import networks

  real = networks.make_policy

  def make(*args, **kwargs):
    act = real(*args, **kwargs)
    return lambda obs: act(obs) * 0.999
  monkeypatch.setattr(networks, 'make_policy', make)


@pytest.mark.parametrize('fault', [_unchanged, _half, _altered_action,
                                   _one_env(_one_env_unstepped),
                                   _one_env(_one_env_done_flipped)])
def test_rollout_faults(fault, rollout_limits, monkeypatch):
  fault(monkeypatch)
  line = tiny_run('cube_push.rollout', limits=rollout_limits)
  assert not line['correct'], line['checks']


def _adam_leaves_parameters(monkeypatch):
  from rsr_mjx_tpu_torch.train import ppo

  real = ppo.make_optimizer

  def make(params, lr):
    opt = real(params, lr)
    opt.step = lambda *a, **k: None
    return opt
  monkeypatch.setattr(ppo, 'make_optimizer', make)


def _loss_over_half(monkeypatch):
  from rsr_mjx_tpu_torch.envs.wrappers import tree_map
  from rsr_mjx_tpu_torch.train import losses

  real = losses.compute_ppo_loss

  def half(networks, normalizer, data, noise, **kw):
    m = noise.shape[1] // 2
    return real(networks, normalizer, tree_map(lambda x: x[:m], data),
                noise[:, :m], **kw)
  monkeypatch.setattr(losses, 'compute_ppo_loss', half)


def _altered_gradient(monkeypatch):
  from rsr_mjx_tpu_torch.train import ppo

  real = ppo.clip_by_global_norm_

  def clip(grads, max_norm):
    real(grads, max_norm)
    for g in grads:
      g.mul_(1.5)
  monkeypatch.setattr(ppo, 'clip_by_global_norm_', clip)


@pytest.mark.parametrize('fault', [_adam_leaves_parameters, _loss_over_half,
                                   _altered_gradient])
def test_train_faults(fault, train_limits, monkeypatch):
  fault(monkeypatch)
  line = tiny_run('go2_joystick.train', limits=train_limits)
  assert not line['correct'], line['checks']
