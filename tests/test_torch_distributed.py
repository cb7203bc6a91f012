"""Training on several processes through ``torch.distributed`` (gloo, CPU).

The port's counterpart of ``__graft_entry__.dryrun_multichip`` and
``tests/test_multihost_spoof.py``: each run is a set of real OS processes,
one per rank, forming a gloo group over TCP on localhost
(``train.distributed.init``), on JAX's tiny PPO workload (cube-push, 4
envs, unroll 2, one minibatch, one update, the normalizer on) and one SAC
training step.  Each process records its first unroll, the inputs of its
first SGD step and the gradients its optimizers then see (after the
all-reduce).

(a) A 2-rank PPO run twice gives the same bits, and both ranks hold the
    same parameters.
(b) A 2-rank PPO run against the 1-process run.  The ranks' unrolls,
    side by side, are the 1-process unroll: each env's reset and action
    noise are the same rows of the whole batch's draws, but the plain
    versions sum in other orders at 2 and 4 envs and one of these
    random-action cube-push envs is chaotic in fp32 (its observation can
    part by 4e-4 in one control step), so they are held to 1e-3 of their
    scale (at this seed they part by 6.4e-7 of it).
    The gradient both ranks step with is the mean of the two ranks' PPO
    loss gradients, each on its own minibatch and entropy noise
    (recomputed here, in one process, to 1e-5 of the largest entry; the
    advantage is normalised per process, as under JAX's ``shard_map``).
    The parameters and the normalizer are within JAX's own tolerance of
    the 1-process run, rtol 1e-2 and atol 1e-2
    (``__graft_entry__.py:84-93``), the count exactly.  After one Adam
    step at learning rate 1e-4 the parameters cannot part by more than
    about 2e-4, so that tolerance holds little: the unroll and the
    gradient checks are the ones that see a fault of the distributed SGD.
(c) SAC at one training step after a one-step prefill: each rank draws
    ``batch_size // 2`` transitions from its own ring, and the gradients
    of the temperature, the critics and the actor that both ranks step
    with are those of one process's ``sac.sgd_step`` on the two ranks'
    transitions and noise side by side (the global batch of
    ``batch_size``), to 1e-5 of the largest entry; the rest as (b).
(d) The normalizer updated on two ranks' halves of a batch equals the
    single process's update on the whole batch, to 1e-6.
(e) A group of one gives the bits of no group (the reduction path runs).
Plus, in this process: ``RowStream`` draws are rows of the whole batch's,
and two row streams reset the envs of the whole batch to the bit.
"""

import copy
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import sys
    mode, rank, world, port, out, root = sys.argv[1:7]
    rank, world = int(rank), int(world)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from rsr_mjx_tpu_torch import envs
    from rsr_mjx_tpu_torch.train import acting, distributed, ppo
    from rsr_mjx_tpu_torch.train import running_statistics, sac
    if world:
      distributed.init('cpu', init_method='tcp://localhost:' + port,
                       rank=rank, world_size=world)
    kw = dict(episode_length=4, num_envs=4, num_eval_envs=4, num_evals=1,
              normalize_observations=True, seed=0, device='cpu')
    rec = {}

    def keep(prefix, x):
      # tensors, dicts, named tuples and the normalizer, flattened to
      # 'prefix.field.key' arrays
      if x is None:
        return
      if isinstance(x, torch.Tensor):
        rec[prefix] = x.detach().numpy().copy()
      elif isinstance(x, dict):
        for k, v in x.items():
          keep(prefix + '.' + k, v)
      elif isinstance(x, (list, tuple)) and not hasattr(x, '_fields'):
        for i, v in enumerate(x):
          keep(prefix + '.' + str(i), v)
      else:
        fields = getattr(x, '_fields', None) or vars(x)
        for k in fields:
          keep(prefix + '.' + k, getattr(x, k))

    def record_first(module, name, before, after=None):
      # wrap module.name: before(args) ahead of its first call, after()
      # behind it
      fn = getattr(module, name)
      def wrapped(*args, **kwargs):
        first = name not in rec
        rec.setdefault(name, True)
        if first:
          before(*args)
        out = fn(*args, **kwargs)
        if first and after:
          after(out)
        return out
      setattr(module, name, wrapped)

    grads = []
    mean_grads = distributed.mean_grads_
    def mean_grads_(gs):
      mean_grads(gs)
      grads.append([g.clone() for g in gs])
    distributed.mean_grads_ = mean_grads_
    record_first(acting, 'generate_unroll', lambda *a: None,
                 lambda out: keep('unroll', out[1]))

    if mode == 'norm':
      x = torch.from_numpy(np.random.default_rng(0).normal(
          3.0, 2.0, (2, 6, 5, 7)).astype(np.float32))
      state = running_statistics.init_state(7, 'cpu')
      for batch in x:
        part = batch if not world else batch.chunk(world)[rank]
        state = running_statistics.update(state, part, distributed.all_sum_,
                                          distributed.world()[1])
      arrays = {f: getattr(state, f).numpy()
                for f in ('count', 'mean', 'summed_variance', 'std')}
    elif mode == 'ppo':
      def before(net, opt, normalizer, data, noise, loss_kwargs, clip):
        keep('params', net.state_dict())
        keep('norm', normalizer)
        keep('data', data)
        keep('noise', noise)
        keep('kw', {k: torch.tensor(v) for k, v in loss_kwargs.items()
                    if v is not None})
      record_first(ppo, 'minibatch_step', before)
      env = envs.load('AirbotCubePush', device='cpu')
      _, (norm, net), metrics = ppo.train(
          env, num_timesteps=8, unroll_length=2, batch_size=4,
          num_minibatches=1, num_updates_per_batch=1, **kw)
      arrays = {k: v.numpy() for k, v in net.state_dict().items()}
    else:
      def before(ts, losses, transitions, noise, tau, clip=None):
        keep('params', ts.networks.state_dict())
        keep('target', ts.target_q.state_dict())
        keep('log_alpha', ts.log_alpha)
        keep('norm', ts.normalizer_params)
        keep('data', transitions)
        keep('noise', noise)
      record_first(sac, 'sgd_step', before)
      env = envs.load('AirbotCubePush', device='cpu')
      _, (norm, net), metrics = sac.train(
          env, num_timesteps=8, batch_size=4, min_replay_size=4,
          max_replay_size=16, grad_updates_per_step=1, **kw)
      arrays = {k: v.numpy() for k, v in net.state_dict().items()}
    if mode != 'norm':
      # the first SGD step's gradients (PPO: one list; SAC: α, critics,
      # actor)
      keep('grads', grads[:1 if mode == 'ppo' else 3])
      arrays.update({'rec.' + k: v for k, v in rec.items()
                     if isinstance(v, np.ndarray)})
      arrays.update({'norm_' + f: getattr(norm, f).numpy()
                     for f in ('count', 'mean', 'std')})
      arrays.update({'metric_' + k: np.float64(v)
                     for k, v in metrics.items() if k.startswith('training/')
                     and k not in ('training/sps', 'training/walltime')})
    np.savez(out, **arrays)
    distributed.finish()
    print('RANK%d_OK' % rank, flush=True)
""")


def _free_port() -> str:
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return str(s.getsockname()[1])


def _launch(mode, world, tmp, tag):
  """Start the processes of one run (``world`` 0: one process, no group);
  return (process, output path) per rank."""
  port = _free_port()
  jobs = []
  for rank in range(max(world, 1)):
    out = os.path.join(tmp, f'{tag}_{rank}.npz')
    jobs.append((subprocess.Popen(
        [sys.executable, '-c', _WORKER, mode, str(rank), str(world), port,
         out, ROOT], stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                 out))
  return jobs


def _collect(jobs):
  """Wait for a run's processes; each rank's arrays."""
  results = []
  try:
    for rank, (p, out) in enumerate(jobs):
      log, _ = p.communicate(timeout=400)
      log = log.decode(errors='replace')
      assert p.returncode == 0, f'rank {rank} failed:\n{log[-3000:]}'
      assert f'RANK{rank}_OK' in log, log[-3000:]
      results.append(dict(np.load(out)))
  finally:
    for p, _ in jobs:
      if p.poll() is None:
        p.kill()
  return results


def _runs(tmp, spec):
  """Launch every run of ``spec`` {tag: (mode, world)} at once, then
  collect them all."""
  jobs = {tag: _launch(mode, world, str(tmp), tag)
          for tag, (mode, world) in spec.items()}
  return {tag: _collect(j) for tag, j in jobs.items()}


@pytest.fixture(scope='module')
def ppo_runs(tmp_path_factory):
  return _runs(tmp_path_factory.mktemp('ppo'), {
      'two': ('ppo', 2), 'two_again': ('ppo', 2), 'one': ('ppo', 0),
      'group_of_one': ('ppo', 1)})


def _assert_same_bits(a, b, what):
  assert a.keys() == b.keys()
  for k in a:
    np.testing.assert_array_equal(a[k], b[k], err_msg=f'{what}: {k}')


def _final(r):
  """A run's parameters, normalizer and loss metrics at its end."""
  return {k: v for k, v in r.items() if not k.startswith('rec.')}


def _normalizer_at_end(r):
  return {k: v for k, v in r.items() if k.startswith('norm_')}


def _params(r):
  return {k: v for k, v in _final(r).items()
          if not k.startswith(('metric_', 'norm_'))}


def _flat(r, prefix):
  """The tensors recorded under ``prefix``, by the rest of their name."""
  n = len(prefix) + 1
  return {k[n:]: torch.from_numpy(v) for k, v in r.items()
          if k.startswith(prefix + '.')}


def _tree(r, prefix):
  """The tensors recorded under ``prefix`` as nested dicts."""
  out = {}
  for k, v in _flat(r, prefix).items():
    *path, leaf = k.split('.')
    node = out
    for part in path:
      node = node.setdefault(part, {})
    node[leaf] = v
  return out


def _listed(tree):
  return [tree[str(i)] for i in range(len(tree))]


def _transition(r, prefix='rec.data'):
  from rsr_mjx_tpu_torch.train.losses import Transition
  return Transition(**_tree(r, prefix))


def _normalizer(r):
  from rsr_mjx_tpu_torch.train import running_statistics
  return running_statistics.RunningStatisticsState(**_tree(r, 'rec.norm'))


def _assert_grads(seen, want, what):
  """Each recorded gradient within 1e-5 of the largest entry of ``want``."""
  assert len(seen) == len(want), what
  scale = max(float(w.abs().max()) for w in want)
  assert scale > 0, what
  for i, (g, w) in enumerate(zip(seen, want)):
    np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                               atol=1e-5 * scale, err_msg=f'{what}: {i}')


def _assert_runs_close(two, one):
  """Parameters and normalizer within rtol/atol 1e-2
  (``__graft_entry__.py:84-93``); the loss metrics are of other
  minibatches."""
  two, one = (_params(r) | _normalizer_at_end(r) for r in (two, one))
  assert two.keys() == one.keys()
  for k in one:
    np.testing.assert_allclose(two[k], one[k], rtol=1e-2, atol=1e-2,
                               err_msg=k)


def test_ppo_two_ranks_repeatable(ppo_runs):
  first, again = ppo_runs['two'], ppo_runs['two_again']
  _assert_same_bits(first[0], again[0], 'rank 0, run twice')
  _assert_same_bits(first[1], again[1], 'rank 1, run twice')
  _assert_same_bits(_params(first[0]), _params(first[1]),
                    'the ranks\' replicas')


def test_ppo_two_ranks_match_one_process(ppo_runs):
  from rsr_mjx_tpu_torch.train import losses, networks

  two, one = ppo_runs['two'], ppo_runs['one'][0]
  # the ranks' unrolls side by side are the 1-process unroll ([T, B])
  halves = [_flat(r, 'rec.unroll') for r in two]
  whole = _flat(one, 'rec.unroll')
  assert halves[0].keys() == whole.keys() and 'observation' in whole
  for k, w in whole.items():
    got = torch.cat([h[k] for h in halves], dim=1)
    assert got.shape == w.shape, k
    scale = max(1.0, float(w.abs().max()))
    np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                               atol=1e-3 * scale, err_msg=k)
  # the gradient both ranks step with: the mean of the ranks' own
  per_rank = []
  for r in two:
    data = _transition(r)
    assert data.reward.shape == (2, 2)  # [B local, T]
    net = networks.make_ppo_networks(data.observation.shape[-1],
                                     data.action.shape[-1])
    net.load_state_dict(_flat(r, 'rec.params'))
    kw = {k: v.item() for k, v in _flat(r, 'rec.kw').items()}
    kw['normalize_advantage'] = bool(kw['normalize_advantage'])
    loss, _ = losses.compute_ppo_loss(net, _normalizer(r), data,
                                      torch.from_numpy(r['rec.noise']), **kw)
    per_rank.append(torch.autograd.grad(loss, list(net.parameters())))
  mean = [(a + b) / 2 for a, b in zip(*per_rank)]
  for rank, r in enumerate(two):
    _assert_grads(_listed(_tree(r, 'rec.grads')['0']), mean,
                  f'rank {rank}\'s gradient')
  _assert_runs_close(two[0], one)
  # every observation of the step counted once: 4 envs x 2 steps
  assert float(two[0]['norm_count']) == float(one['norm_count']) == 8.0


def test_group_of_one_is_no_group(ppo_runs):
  _assert_same_bits(ppo_runs['group_of_one'][0], ppo_runs['one'][0],
                    'a gloo group of one against no group')


def test_sac_two_ranks_match_one_process(tmp_path, monkeypatch):
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.train import distributed, ppo, running_statistics
  from rsr_mjx_tpu_torch.train import sac, sac_losses, sac_networks

  runs = _runs(tmp_path, {'two': ('sac', 2), 'one': ('sac', 0)})
  two, one = runs['two'], runs['one'][0]
  _assert_same_bits(_params(two[0]), _params(two[1]), 'the ranks\' replicas')
  # each rank's SGD step: batch_size // world of its own transitions, at
  # the same weights and normalizer
  for prefix in ('rec.params', 'rec.target', 'rec.log_alpha', 'rec.norm'):
    _assert_same_bits(*({k: v for k, v in r.items() if k == prefix
                         or k.startswith(prefix + '.')} for r in two), prefix)
  data = [_transition(r) for r in two]
  assert [d.reward.shape[0] for d in data] == [2, 2]
  assert _transition(one).reward.shape[0] == 4
  # one process's sgd_step on the global batch: the ranks' transitions
  # and noise side by side
  r = two[0]
  obs_size, action_size = (data[0].observation.shape[-1],
                           data[0].action.shape[-1])
  net = sac_networks.make_sac_networks(obs_size, action_size)
  net.load_state_dict(_flat(r, 'rec.params'))
  target = copy.deepcopy(net.q).requires_grad_(False)
  target.load_state_dict(_flat(r, 'rec.target'))
  log_alpha = torch.tensor(r['rec.log_alpha'], requires_grad=True)
  ts = sac.TrainingState(
      networks=net, target_q=target, log_alpha=log_alpha,
      policy_optimizer=ppo.make_optimizer(net.policy.parameters(), 1e-4),
      q_optimizer=ppo.make_optimizer(net.q.parameters(), 1e-4),
      alpha_optimizer=ppo.make_optimizer([log_alpha], 3e-4),
      normalizer_params=_normalizer(r))
  losses = sac_losses.make_losses(
      net, reward_scaling=1.0, discounting=0.9, action_size=action_size,
      normalize_fn=running_statistics.normalize)
  noise = [torch.cat(n) for n in zip(*(_listed(_tree(r, 'rec.noise'))
                                       for r in two))]
  seen = []
  monkeypatch.setattr(distributed, 'mean_grads_',
                      lambda gs: seen.append([g.clone() for g in gs]))
  sac.sgd_step(ts, losses, wrappers.tree_map(lambda *x: torch.cat(x), *data),
               noise, tau=0.005)
  assert len(seen) == 3
  for rank, r in enumerate(two):
    got = _tree(r, 'rec.grads')
    for i, what in enumerate(('temperature', 'critic', 'actor')):
      _assert_grads(_listed(got[str(i)]), seen[i],
                    f'rank {rank}\'s {what} gradient')
  _assert_runs_close(two[0], one)
  # prefill and training step: 2 actor steps of 4 envs
  assert float(two[0]['norm_count']) == float(one['norm_count']) == 8.0


def test_normalizer_sums_over_ranks(tmp_path):
  runs = _runs(tmp_path, {'two': ('norm', 2), 'one': ('norm', 0)})
  one = runs['one'][0]
  for rank in range(2):
    for k in one:
      np.testing.assert_allclose(runs['two'][rank][k], one[k], rtol=1e-6,
                                 atol=1e-6, err_msg=f'rank {rank}: {k}')
  assert float(one['count']) == 60.0


def test_row_stream_draws_rows_of_the_whole_batch():
  from rsr_mjx_tpu_torch.envs import core
  from rsr_mjx_tpu_torch.train import distributed

  whole = core.rand(torch.Generator().manual_seed(3), (6, 4))
  parts = [core.rand(core.RowStream(torch.Generator().manual_seed(3),
                                    2 * r, 2, 6), (2, 4)) for r in range(3)]
  assert torch.equal(torch.cat(parts), whole)
  gauss = core.randn(core.RowStream(torch.Generator().manual_seed(3), 4, 2,
                                    6), (2, 3))
  assert torch.equal(gauss,
                     core.randn(torch.Generator().manual_seed(3), (6, 3))[4:])
  with pytest.raises(ValueError):
    core.rand(core.RowStream(torch.Generator(), 0, 2, 6), (3,))
  # no process group: one process of the whole batch
  assert distributed.world() == (0, 1)
  g = torch.Generator()
  assert distributed.rows(g, 4) is g


def test_row_streams_reset_the_whole_batch():
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import core

  env = envs.load('AirbotCubePush', device='cpu')
  whole = env.reset(torch.Generator().manual_seed(5), 4)
  halves = [env.reset(core.RowStream(torch.Generator().manual_seed(5),
                                     2 * r, 2, 4), 2) for r in range(2)]
  for f in ('qpos', 'qvel', 'ctrl'):
    assert torch.equal(torch.cat([getattr(h.data, f) for h in halves]),
                       getattr(whole.data, f)), f
  assert torch.equal(torch.cat([h.obs for h in halves]), whole.obs)
