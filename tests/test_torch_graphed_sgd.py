"""The PPO minibatch step replayed from a CUDA graph (``train/graphed_sgd.py``).

On the CPU the step runs eagerly; the tests here emulate a graph with
``torch_testing.Rerun``, which runs the captured function again at each
replay and writes its outputs where the capture left them, as a graph's
kernels do.  That
reaches the whole of the module but the CUDA calls: the eligibility rule,
the cache and its keys, the static inputs, the copies out, the gradients
left in ``.grad``, the device-side Adam (``ppo.adam_step_``) and the
counters.  One more CPU test holds the eager step to what a capture needs:
after its first call it reads no device value on the host and copies no
host data in.

Every case takes a small minibatch (4 sequences of 5 steps) of the Go2
joystick's networks: 512-256-128 policy and value, dict observations.  The
tests marked ``cuda`` run on the card at the benchmark's minibatch, 256 x
20: replay bit-equal to the eager step with the same Adam over 4
minibatches, with the RSR penalty and without, the weights within 1e-6
of those ``torch.optim.Adam`` makes of the same gradients, and the
replays counted.  This file imports no JAX, so that they run where there
is a card: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_graphed_sgd.py``.
"""

import gc
import weakref

import pytest
import torch

from rsr_mjx_tpu_torch.envs.wrappers import tree_map
from rsr_mjx_tpu_torch.rsr.loss import RSRData
from rsr_mjx_tpu_torch.train import distributed
from rsr_mjx_tpu_torch.train import graphed_sgd
from rsr_mjx_tpu_torch.train import networks as pn
from rsr_mjx_tpu_torch.train import ppo
from rsr_mjx_tpu_torch.train import running_statistics
from rsr_mjx_tpu_torch.train.losses import Transition
from rsr_mjx_tpu_torch.train.running_statistics import RunningStatisticsState
from rsr_mjx_tpu_torch.utils import cuda_graphs
from rsr_mjx_tpu_torch.utils import tracing
import torch_testing
from torch_testing import one_thread  # noqa: F401  (a fixture)

OBS = {'state': 48, 'privileged_state': 123}
ACT = 12
LR = 3e-4
KW = dict(past_data=None, entropy_cost=0.01, discounting=0.97,
          reward_scaling=1.0, gae_lambda=0.95, clipping_epsilon=0.3,
          normalize_advantage=True, rsr_loss_scale=1.0)

pytestmark = pytest.mark.usefixtures('one_thread')


def _nets(device='cpu'):
  net = pn.make_ppo_networks(OBS, ACT, (512, 256, 128), (512, 256, 128),
                             policy_obs_key='state',
                             value_obs_key='privileged_state')
  return net.init(torch.Generator().manual_seed(0)).to(device)


def _batch(seed, B=4, T=5, device='cpu'):
  """A [B, T] minibatch as the trainer hands one over."""
  g = torch.Generator().manual_seed(seed)
  r = lambda *s: torch.randn(s, generator=g)
  obs = lambda: {k: r(B, T, n) for k, n in OBS.items()}
  raw = r(B, T, ACT)
  data = Transition(
      observation=obs(), action=torch.tanh(raw), reward=r(B, T),
      discount=(torch.rand((B, T), generator=g) > 0.1).float(),
      next_observation=obs(),
      extras={'state_extras': {
                  'truncation': (torch.rand((B, T), generator=g)
                                 > 0.9).float()},
              'policy_extras': {'log_prob': r(B, T) - 10.0,
                                'raw_action': raw}})
  noise = r(T, B, ACT)
  return (tree_map(lambda x: x.to(device), data),
          noise.to(device))


def _normalizer(seed, device='cpu'):
  """A normalizer state of fresh tensors (the trainer makes new ones every
  training step)."""
  g = torch.Generator().manual_seed(100 + seed)
  mean = {k: 0.1 * torch.randn(n, generator=g) for k, n in OBS.items()}
  std = {k: 0.5 + torch.rand(n, generator=g) for k, n in OBS.items()}
  state = RunningStatisticsState(
      count=torch.tensor(float(seed + 1)), mean=mean,
      summed_variance={k: v * v for k, v in std.items()}, std=std)
  return running_statistics.to(state, device)


def _rsr_data(device='cpu'):
  """A penalty state of the policy's transition width (obs + act + next
  obs) on 16 grid points, bandwidth 2."""
  g = torch.Generator().manual_seed(5)
  width = 2 * OBS['state'] + ACT
  grid = torch.randn((16, width), generator=g)
  cdf = torch.cumsum(torch.softmax(torch.randn(16, generator=g), 0), 0)
  return RSRData(weight=torch.tensor(0.7), grid=grid,
                 grid_sq=(grid * grid).sum(-1),
                 anchor_logsum=torch.randn(16, generator=g), target_cdf=cdf,
                 n_anchors=16, width=width, bandwidth=2.0).to(device)


class _Inert:
  """A graph's stand-in that keeps no function and replays nothing."""

  def replay(self):
    pass


def _written(networks, optimizer):
  """What a step writes in place: the weights and Adam's state."""
  return list(networks.parameters()) + [
      t for st in optimizer.state.values() for t in st.values()]


def _dry_capture_graph(real):
  """``_capture_graph`` whose emulated capture leaves the weights and
  Adam's state as they were: a capture runs nothing."""

  def capture_graph(eager, networks, optimizer, *rest):
    kept = [t.clone() for t in _written(networks, optimizer)]
    g = real(eager, networks, optimizer, *rest)
    with torch.no_grad():
      for t, k in zip(_written(networks, optimizer), kept):
        t.copy_(k)
    return g

  return capture_graph


@pytest.fixture
def emulated(monkeypatch):
  """graphed_sgd's CUDA calls replaced by their CPU stand-ins."""
  monkeypatch.setattr(graphed_sgd, '_capture_graph',
                      _dry_capture_graph(graphed_sgd._capture_graph))
  monkeypatch.setattr(graphed_sgd, '_on_card', lambda t: True)
  monkeypatch.setattr(graphed_sgd, '_capturing', lambda: False)
  torch_testing.emulate_cuda_graphs(monkeypatch)
  graphed_sgd.clear()
  tracing.reset()
  yield
  graphed_sgd.clear()


def _step(net, opt, seed, norm_seed=None, kw=KW, clip=1.0, B=4, eager=False):
  """One minibatch step through ``ppo.minibatch_step``, or (``eager``)
  through its eager body."""
  data, noise = _batch(seed, B=B)
  norm = _normalizer(seed if norm_seed is None else norm_seed)
  step = ppo._minibatch_step if eager else ppo.minibatch_step
  return step(net, opt, norm, data, noise, kw, clip)


def _counters():
  c = tracing.snapshot()['counters']
  return c['ppo.sgd_graph_captures'], c['ppo.sgd_graph_replays']


# ---------------------------------------------------------------------------
# What a capture needs of the eager step


@pytest.mark.parametrize('clip', [None, 1.0])
@pytest.mark.parametrize('rsr', [False, True])
def test_step_is_capturable(clip, rsr):
  """After its first call the eager step with the device-side Adam, with
  the clip and without, with the RSR penalty and without, reads no device
  value on the host and copies no host data in."""
  net = _nets()
  opt = ppo.make_optimizer(net.parameters(), LR)
  kw = dict(KW, past_data=_rsr_data() if rsr else None)
  _step(net, opt, 0, kw=kw, clip=clip, eager=True)
  rec = torch_testing.HostOps()
  with rec:
    metrics = _step(net, opt, 1, kw=kw, clip=clip, eager=True)
  assert rec.seen == []
  assert (metrics['sim2real_loss'] != 0) == rsr


# ---------------------------------------------------------------------------
# Replay against the eager step, through the emulated graph


def _adam_state(opt):
  return [t for p in opt.param_groups[0]['params']
          for t in opt.state[p].values()]


@pytest.mark.parametrize('rsr', [False, True])
def test_replay_equals_eager(rsr, emulated):
  """Three calls (eager, capture and replay, replay), each with a new
  normalizer, equal three eager steps with the same Adam bit for bit:
  metrics, clipped gradients, weights and Adam's moments and step."""
  kw = dict(KW, past_data=_rsr_data() if rsr else None)
  net_g, net_e = _nets(), _nets()
  opt_g = ppo.make_optimizer(net_g.parameters(), LR)
  opt_e = ppo.make_optimizer(net_e.parameters(), LR)
  for k in range(3):
    mg = _step(net_g, opt_g, k, kw=kw)
    me = _step(net_e, opt_e, k, kw=kw, eager=True)
    assert mg.keys() == me.keys()
    for name in me:
      assert torch.equal(mg[name], me[name]), (k, name)
    for pg, pe in zip(net_g.parameters(), net_e.parameters()):
      assert torch.equal(pg.grad, pe.grad) and torch.equal(pg, pe), k
    for a, b in zip(_adam_state(opt_g), _adam_state(opt_e)):
      assert torch.equal(a, b), k
  assert _counters() == (1, 2)


def test_metrics_are_copies(emulated):
  """Three calls give three distinct losses, each left as it was by the
  later replays."""
  net = _nets()
  opt = ppo.make_optimizer(net.parameters(), LR)
  held = []
  for k in range(3):
    m = _step(net, opt, k)
    held.append((m, {n: v.clone() for n, v in m.items()}))
  assert len({m['total_loss'].item() for m, _ in held}) == 3
  for m, kept in held:
    for n in m:
      assert torch.equal(m[n], kept[n])


def test_stale_normalizer_would_show(emulated):
  """The same minibatch under two normalizers gives two losses: a replay
  that read the captured normalizer's addresses would not."""
  net = _nets()
  opt = ppo.make_optimizer(net.parameters(), LR)
  _step(net, opt, 0)
  _step(net, opt, 0)
  a = _step(net, opt, 1, norm_seed=1)['total_loss']
  b = _step(net, opt, 1, norm_seed=2)['total_loss']
  assert _counters() == (1, 3)
  assert not torch.equal(a, b)


def _torch_adam_on(grads_by_step, device='cpu'):
  """The networks' initial weights after ``torch.optim.Adam`` took the
  given steps' gradients."""
  net = _nets(device)
  opt = ppo.make_optimizer(net.parameters(), LR)
  for grads in grads_by_step:
    for p, g in zip(net.parameters(), grads):
      p.grad = g.clone()
    opt.step()
  return net


def _assert_close_to(net, ref):
  """Each leaf within 1e-6 of ``ref``'s, relative to the leaf's scale."""
  for a, b in zip(net.parameters(), ref.parameters()):
    assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()


def test_adam_as_torch_adam():
  """Four device-side Adam steps leave the weights within 1e-6 of those
  ``torch.optim.Adam`` makes of the same gradients, relative to each
  leaf's scale; its state saves and loads into a new Adam, which steps on
  from it."""
  net = _nets()
  opt = ppo.make_optimizer(net.parameters(), LR)
  grads = []
  for k in range(4):
    _step(net, opt, k, eager=True)
    grads.append([p.grad.clone() for p in net.parameters()])
  _assert_close_to(net, _torch_adam_on(grads))
  assert all(opt.state[p]['step'].item() == 4 for p in net.parameters())
  loaded = ppo.make_optimizer(net.parameters(), LR)
  loaded.load_state_dict(opt.state_dict())
  _step(net, loaded, 4)
  assert all(loaded.state[p]['step'].item() == 5 for p in net.parameters())


# ---------------------------------------------------------------------------
# When a step stays eager


def _spoof_two_processes(monkeypatch):
  monkeypatch.setattr(distributed, 'active', lambda: True)
  monkeypatch.setattr(distributed.dist, 'get_world_size', lambda: 2)
  monkeypatch.setattr(distributed.dist, 'all_reduce', lambda x, op=None: x)


@pytest.mark.parametrize('case, want', [
    ('cpu', 'device'), ('distributed', 'distributed'),
    ('capturing', 'capturing'), ('card', None)])
def test_eager_paths(case, want, monkeypatch):
  """The CPU, a process group of two and an ongoing capture run ``eager``
  as it is, with the same Adam: nothing is captured; tensors on a card
  replay."""
  if case != 'cpu':
    monkeypatch.setattr(graphed_sgd, '_on_card', lambda t: True)
  if case == 'distributed':
    _spoof_two_processes(monkeypatch)
  monkeypatch.setattr(graphed_sgd, '_capturing', lambda: case == 'capturing')
  net = _nets()
  opt = ppo.make_optimizer(net.parameters(), LR)
  data, noise = _batch(0)
  norm = _normalizer(0)
  leaves = graphed_sgd._tensors((norm, data, noise))
  assert graphed_sgd.eager_reason(net, leaves) == want
  if want is None:
    return
  graphed_sgd.clear()
  tracing.reset()
  ref = _nets()
  ref_opt = ppo.make_optimizer(ref.parameters(), LR)
  for _ in range(2):
    ppo.minibatch_step(net, opt, norm, data, noise, KW, 1.0)
    ppo._minibatch_step(ref, ref_opt, norm, data, noise, KW, 1.0)
  assert _counters() == (0, 0) and not graphed_sgd._CACHE
  for a, b in zip(net.parameters(), ref.parameters()):
    assert torch.equal(a, b)
  assert all(opt.state[p]['step'] == 2 for p in net.parameters())


@pytest.mark.parametrize('kw', [dict(weight_decay=0.1), dict(amsgrad=True)])
def test_adam_other_than_plain_raises(kw):
  """An Adam with weight decay or AMSGrad is not the update ``adam_step_``
  makes: the step refuses it rather than ignore the option."""
  net = _nets()
  opt = torch.optim.Adam(net.parameters(), LR, **kw)
  with pytest.raises(ValueError, match='plain torch.optim.Adam'):
    _step(net, opt, 0)


# ---------------------------------------------------------------------------
# The cache


@pytest.mark.parametrize('case, entries', [
    ('same', 1), ('shape', 2), ('max_grad_norm', 2), ('past_data', 2)])
def test_cache_key(case, entries, emulated):
  """A minibatch of another shape, another clip or another penalty state
  makes a new key, whose first call is eager again; the same key
  replays."""
  net = _nets()
  opt = ppo.make_optimizer(net.parameters(), LR)
  _step(net, opt, 0)
  _step(net, opt, 1)
  other = dict(kw=dict(KW, past_data=_rsr_data())) if case == 'past_data' \
      else dict(B=3) if case == 'shape' \
      else dict(clip=0.5) if case == 'max_grad_norm' else {}
  _step(net, opt, 2, **other)
  _step(net, opt, 3, **other)
  assert len(graphed_sgd._CACHE) == entries
  assert _counters() == (entries, 4 - entries)


def test_graph_dies_with_its_networks(emulated, monkeypatch):
  """The cache holds its networks weakly (here with a stand-in that keeps
  no function, as a CUDA graph keeps none)."""
  monkeypatch.setattr(cuda_graphs, 'capture',
                      lambda fn, pool, stream: (_Inert(), fn()))
  net = _nets()
  opt = ppo.make_optimizer(net.parameters(), LR)
  _step(net, opt, 0)
  _step(net, opt, 1)
  assert len(graphed_sgd._CACHE) == 1
  del net
  gc.collect()
  assert not graphed_sgd._CACHE


def test_lru_frees_what_it_drops(emulated, monkeypatch):
  """Beyond MAX_GRAPHS the least recently used graph goes; the networks
  used again is now the more recent and stays."""
  monkeypatch.setattr(graphed_sgd, 'MAX_GRAPHS', 2)
  nets = [_nets() for _ in range(3)]
  opts = [ppo.make_optimizer(n.parameters(), LR) for n in nets]
  refs = []
  for n, o in zip(nets[:2], opts):
    _step(n, o, 0)
    _step(n, o, 1)
    refs.append(weakref.ref(
        list(graphed_sgd._CACHE.values())[-1].graph.graph))
  _step(nets[0], opts[0], 2)
  _step(nets[2], opts[2], 0)
  gc.collect()
  assert len(graphed_sgd._CACHE) == 2
  assert refs[0]() is not None and refs[1]() is None
  kept = {id(e.networks()) for e in graphed_sgd._CACHE.values()}
  assert kept == {id(nets[0]), id(nets[2])}


# ---------------------------------------------------------------------------
# On the card


def _card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  return torch.device('cuda')


def _card_steps(n, graph, rsr=False):
  """n minibatch steps at 256 x 20 on the card (``rsr``: with the RSR
  penalty); the networks afterwards and each step's metrics and clipped
  gradients."""
  dev = _card()
  net = _nets(dev)
  opt = ppo.make_optimizer(net.parameters(), LR)
  kw = dict(KW, past_data=_rsr_data(dev) if rsr else None)
  out = []
  for k in range(n):
    data, noise = _batch(k, B=256, T=20, device=dev)
    norm = _normalizer(k, dev)
    if graph:
      m = ppo.minibatch_step(net, opt, norm, data, noise, kw, 1.0)
    else:
      m = ppo._minibatch_step(net, opt, norm, data, noise, kw, 1.0)
    out.append((m, [p.grad.clone() for p in net.parameters()]))
  torch.cuda.synchronize()
  return net, out


@pytest.mark.cuda
@pytest.mark.parametrize('rsr', [False, True])
def test_card_replay_bit_equal(rsr):
  """4 minibatches, replayed and eager with the same Adam, with the RSR
  penalty and without: metrics, clipped gradients and weights equal bit
  for bit; one capture, three replays counted."""
  graphed_sgd.clear()
  tracing.reset()
  net_g, out_g = _card_steps(4, graph=True, rsr=rsr)
  assert _counters() == (1, 3)
  net_e, out_e = _card_steps(4, graph=False, rsr=rsr)
  for (mg, gg), (me, ge) in zip(out_g, out_e):
    for name in me:
      assert torch.equal(mg[name], me[name]), name
    for a, b in zip(gg, ge):
      assert torch.equal(a, b)
  for a, b in zip(net_g.parameters(), net_e.parameters()):
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_weights_as_torch_adam():
  """The replayed weights after 4 minibatches lie within 1e-6 of those
  ``torch.optim.Adam`` makes of the same clipped gradients, relative to
  each leaf's scale."""
  graphed_sgd.clear()
  net, out = _card_steps(4, graph=True)
  _assert_close_to(net, _torch_adam_on([g for _, g in out], 'cuda'))
