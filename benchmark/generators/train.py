"""PPO training through the port's own entry, ``ppo.train``, at the
configuration's published table with ``num_evals=0``, from seed-made
weights handed over through ``restore_checkpoint_path``.

Set-up: the env, the starting checkpoint, env steps at the table's batch
and ``minibatch_step`` calls at the minibatch shape (through the port's
public functions).  The window is one ``ppo.train`` call of N whole
training steps, N = max(1, round(seconds × the traffic's
``sized_at_env_steps_per_s`` / env-steps a training step)): the same work
in every run of a length; end to end: its env-steps over its seconds.

The window's first steps are recorded as they pass (the trainer calls
``acting.generate_unroll``, ``acting.actor_step`` and ``ppo.minibatch_step``
through their modules): the start state and first transitions of the
first unroll, and the first three SGD steps' inputs, losses, gradients
and parameters.  After the window the reference follows them:

- the start: the frozen env's reset from the trainer's env stream (its
  seed drawn from ``seed`` as ``ppo._generators`` draws it), float64;
- the first control step, every env: the frozen stack in float64 from the
  program's state with the program's sampled action; and the behaviour
  log-probability of the sampled pre-tanh action;
- the normaliser after the first batch;
- three SGD steps in float64 (the frozen loss, the clip, Adam) on the
  recorded minibatches and entropy draws, from the same starting weights:
  the first step's loss, and the median leaf's gap of the first
  gradient's norm and of the parameters' change after the three.
"""

from __future__ import annotations

import functools
import math
import os
import sys
import tempfile
import time

import numpy as np

from benchmark import common
from benchmark.reference import follow
from benchmark.roofline import networks as net_flops

START_DIR = 'benchmark_train_start'
TABLE_KEYS = ('num_envs', 'batch_size', 'num_minibatches', 'unroll_length',
              'num_updates_per_batch')


def table(ctx) -> dict:
  t = dict(ctx.cfg['ppo'])
  t.update({k: v for k, v in ctx.sizes.items() if k in TABLE_KEYS})
  return t


def layer_sizes(ctx, t):
  """(policy widths, value widths), input to output."""
  return net_flops.widths({'ppo': t}, ctx.cfg['obs_sizes'],
                          ctx.cfg['action_size'])


def make_weights(ctx, t, device):
  """The starting state dict, drawn from the seed on the device in one
  call: each weight U(−√(3/fan_in), √(3/fan_in)) (the JAX ``MLP.init``),
  each bias 0; keys and layouts of the port's ``PPONetworks``."""
  import torch

  policy, value = layer_sizes(ctx, t)
  shapes = []
  for name, sizes in (('policy', policy), ('value', value)):
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
      shapes.append((f'{name}.layers.{i}', a, b))
  g = torch.Generator(device=device).manual_seed(
      common.stream_seed(ctx.seed, 3))
  u = torch.rand(sum(a * b for _, a, b in shapes), generator=g,
                 device=device)
  sd, at = {}, 0
  for key, a, b in shapes:
    scale = math.sqrt(3.0 / a)
    sd[key + '.weight'] = (u[at:at + a * b].reshape(b, a) * (2 * scale)
                           - scale)
    sd[key + '.bias'] = torch.zeros(b, device=device)
    at += a * b
  return sd


def init_normalizer(ctx):
  """Zero count, mean and summed variance, unit std, by observation key
  (the trainer's ``running_statistics.init_state``)."""
  import torch

  sizes = ctx.cfg['obs_sizes']
  z = lambda n: torch.zeros(n)
  if ctx.cfg['env'].startswith('Go2'):
    keys = sorted(sizes)
    return {'count': torch.zeros(()),
            'mean': {k: z(sizes[k]) for k in keys},
            'summed_variance': {k: z(sizes[k]) for k in keys},
            'std': {k: torch.ones(sizes[k]) for k in keys}}
  n = sizes['state']
  return {'count': torch.zeros(()), 'mean': z(n), 'summed_variance': z(n),
          'std': torch.ones(n)}


def write_start(ctx, sd) -> str:
  """The starting checkpoint, in the format ``restore_checkpoint_path``
  reads (``params.pt``: the normaliser's fields and the state dict)."""
  import torch

  path = os.path.join(tempfile.gettempdir(), START_DIR)
  os.makedirs(path, exist_ok=True)
  torch.save({'normalizer': init_normalizer(ctx),
              'params': {k: v.detach().cpu() for k, v in sd.items()}},
             os.path.join(path, 'params.pt'))
  return path


def env_seed(seed: int) -> int:
  """The seed of the trainer's env stream, drawn from ``seed`` as
  ``ppo._generators`` draws it (one process, no group)."""
  import torch

  base = torch.Generator().manual_seed(seed)
  return int(torch.randint(0, 2**62, (5,), generator=base).tolist()[1])


class Recorder:
  """Wraps the trainer's module functions for one ``ppo.train`` call:
  records the first unroll's start and output and the first three SGD
  steps; in a traced run, profiles control steps and minibatches of the
  first training step and times its SGD phases."""

  def __init__(self, ctx, t, trace: bool):
    self.ctx, self.t, self.trace = ctx, t, trace
    self.unroll = None
    self.unrolls = t['batch_size'] * t['num_minibatches'] // t['num_envs']
    self.batch = []  # the first training step's observations, by unroll
    self.sgd = []
    self.steps = 0
    self.minibatches = 0
    self.per_step = t['num_updates_per_batch'] * t['num_minibatches']
    self.sgd_spans = []
    self.profiles = {}

  def __enter__(self):
    from rsr_mjx_tpu_torch.train import acting, ppo

    self._real = (acting.generate_unroll, acting.actor_step,
                  ppo.minibatch_step)
    acting.generate_unroll = self.generate_unroll
    acting.actor_step = self.actor_step
    ppo.minibatch_step = self.minibatch_step
    return self

  def __exit__(self, *exc):
    from rsr_mjx_tpu_torch.train import acting, ppo

    acting.generate_unroll, acting.actor_step, ppo.minibatch_step = (
        self._real)
    return False

  def _sync(self):
    import torch

    if self.ctx.device != 'cpu':
      torch.cuda.synchronize()

  def generate_unroll(self, env, env_state, policy, generator, length,
                      extra_fields=()):
    from rsr_mjx_tpu_torch.envs.wrappers import tree_map

    first = self.unroll is None
    if first:
      start = tree_map(lambda x: x.clone(), env_state)
      rng = follow.generator_state(env_state)
      if self.trace:
        self._sync()
        t0, self._env_profiled, self._n_env_profiled = (
            time.perf_counter(), 0.0, 0)
    out = self._real[0](env, env_state, policy, generator, length,
                        extra_fields)
    if first:
      self.unroll = (start, rng, out[1])
      if self.trace:
        # a control step's time in the first unroll, its profiled and
        # recorded steps out
        self._sync()
        self.ctrl_step_s = (time.perf_counter() - t0 - self._env_profiled) / (
            length - self._n_env_profiled)
    if len(self.batch) < self.unrolls:
      self.batch.append(out[1].observation)
    return out

  def actor_step(self, *args, **kwargs):
    i = self.steps
    self.steps += 1
    n = self.ctx.traffic['profiled_control_steps']
    if self.trace and 2 <= i < 2 + n:
      t0 = time.perf_counter()
      with common.Profiled(self.ctx.device) as prof:
        out = self._real[1](*args, **kwargs)
      self.profiles.setdefault('env', []).append(prof.trace)
      self._env_profiled += time.perf_counter() - t0
      self._n_env_profiled += 1
      return out
    return self._real[1](*args, **kwargs)

  def minibatch_step(self, networks, optimizer, normalizer, data, noise,
                     loss_kwargs, max_grad_norm):
    from rsr_mjx_tpu_torch.envs.wrappers import tree_map

    i = self.minibatches
    self.minibatches += 1
    rec = i < 3
    if rec:
      entry = dict(data=tree_map(lambda x: x.clone(), data),
                   noise=noise.clone(), normalizer=normalizer,
                   loss_kwargs=loss_kwargs, max_grad_norm=max_grad_norm)
    phase = i % self.per_step
    if self.trace and phase == 0:
      self._sync()
      self._t = time.perf_counter()
      self._profiled, self._n_profiled = 0.0, 0
    n = self.ctx.traffic['profiled_minibatches']
    if self.trace and 8 <= i < 8 + n:
      t0 = time.perf_counter()
      with common.Profiled(self.ctx.device) as prof:
        metrics = self._real[2](networks, optimizer, normalizer, data,
                                noise, loss_kwargs, max_grad_norm)
      self.profiles.setdefault('sgd', []).append(prof.trace)
      self._profiled += time.perf_counter() - t0
      self._n_profiled += 1
    else:
      metrics = self._real[2](networks, optimizer, normalizer, data, noise,
                              loss_kwargs, max_grad_norm)
    if self.trace and phase == self.per_step - 1:
      # the SGD phase of a training step, its profiled minibatches out
      self._sync()
      self.sgd_spans.append(
          (time.perf_counter() - self._t - self._profiled)
          / (self.per_step - self._n_profiled))
    if rec:
      entry['loss'] = metrics['total_loss'].clone()  # read after the window
      entry['grads'] = {k: p.grad.detach().clone()
                        for k, p in networks.named_parameters()}
      entry['after'] = {k: v.detach().clone()
                        for k, v in networks.state_dict().items()}
      self.sgd.append(entry)
    return metrics


def network_factory(t):
  from rsr_mjx_tpu_torch.train import networks

  nf = t['network_factory']
  return functools.partial(
      networks.make_ppo_networks,
      policy_hidden_layer_sizes=tuple(nf['policy_hidden_layer_sizes']),
      value_hidden_layer_sizes=tuple(nf['value_hidden_layer_sizes']),
      policy_obs_key=nf['policy_obs_key'], value_obs_key=nf['value_obs_key'])


def steps_per_training_step(t) -> int:
  return t['batch_size'] * t['unroll_length'] * t['num_minibatches']


def warm_up(ctx, t, env0, sd) -> None:
  """Two env steps at the table's batch and two ``minibatch_step`` calls at
  the minibatch shape, through the port's public functions."""
  import torch
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.envs.wrappers import tree_map
  from rsr_mjx_tpu_torch.train import acting, ppo, running_statistics
  from rsr_mjx_tpu_torch.train import networks as pn

  dev = ctx.device
  B, T, mb = t['num_envs'], t['unroll_length'], t['batch_size']
  env = wrappers.wrap_for_training(env0, episode_length=t['episode_length'],
                                   num_envs=B)
  net = network_factory(t)(env0.observation_size, env0.action_size).to(dev)
  net.load_state_dict(sd)
  norm = running_statistics.init_state(env0.observation_size, dev)
  policy = pn.make_inference_fn(net, running_statistics.normalize)(
      (norm, net))
  g = torch.Generator(device=dev).manual_seed(common.stream_seed(ctx.seed, 4))
  state = env.reset(g)
  for _ in range(2):
    state, data = acting.generate_unroll(env, state, policy, g, 1,
                                         extra_fields=('truncation',))
  # a [batch, T] minibatch made of the step's transitions
  mbatch = tree_map(
      lambda x: x[0, :mb].unsqueeze(1).expand(
          (mb, T) + x.shape[2:]).contiguous(), data)
  opt = ppo.make_optimizer(net.parameters(), t['learning_rate'])
  kw = dict(past_data=None, entropy_cost=t['entropy_cost'],
            discounting=t['discounting'], reward_scaling=t['reward_scaling'],
            gae_lambda=0.95, clipping_epsilon=0.3, normalize_advantage=True,
            rsr_loss_scale=1.0)
  for _ in range(2):
    noise = pn.standard_normal((T, mb, env0.action_size), g)
    ppo.minibatch_step(net, opt, norm, mbatch, noise, kw, t['max_grad_norm'])
  _sync(dev)


def _sync(device):
  import torch

  if device != 'cpu':
    torch.cuda.synchronize()


def train_kwargs(t) -> dict:
  skip = ('num_timesteps', 'num_evals', 'network_factory')
  return {k: v for k, v in t.items() if k not in skip}


def window(ctx, t, env0, start_dir, n_steps, trace):
  """One ``ppo.train`` call of ``n_steps`` training steps; (seconds,
  recorder)."""
  from rsr_mjx_tpu_torch.train import ppo

  with Recorder(ctx, t, trace) as rec:
    _sync(ctx.device)
    common.settle()
    t0 = ctx.opened = time.perf_counter()
    ppo.train(env0, num_timesteps=n_steps * steps_per_training_step(t),
              num_evals=0, seed=ctx.seed, restore_checkpoint_path=start_dir,
              network_factory=network_factory(t), device=ctx.device,
              **train_kwargs(t))
    _sync(ctx.device)
    secs = time.perf_counter() - t0
  return secs, rec


def setup(ctx):
  import torch
  from rsr_mjx_tpu_torch import envs

  t = table(ctx)
  env0 = envs.load(ctx.cfg['env'], device=ctx.device,
                   **ctx.cfg['env_kwargs'])
  sd = make_weights(ctx, t, ctx.device)
  start_dir = write_start(ctx, sd)
  warm_up(ctx, t, env0, sd)
  n = max(1, round(ctx.seconds * ctx.traffic['sized_at_env_steps_per_s']
                   / steps_per_training_step(t)))
  return t, env0, {k: v.detach().cpu() for k, v in sd.items()}, start_dir, n


def run(ctx) -> common.Outcome:
  import torch

  t, env0, sd, start_dir, n = setup(ctx)
  if ctx.device != 'cpu':
    torch.cuda.reset_peak_memory_stats()
  secs, rec = window(ctx, t, env0, start_dir, n, ctx.trace)
  peak = torch.cuda.max_memory_allocated() if ctx.device != 'cpu' else 0
  steps = n * steps_per_training_step(t)
  context = {'envs': t['num_envs'], 'window_s': secs,
             'control_steps': n * steps_per_training_step(t) // t['num_envs'],
             'network_flops': n * network_flops(ctx, t),
             'sgd_spans_s': rec.sgd_spans}
  if ctx.trace and rec.profiles.get('env') and rec.profiles.get('sgd'):
    per_step_ctrl = steps_per_training_step(t) // t['num_envs']
    n_mb = t['num_updates_per_batch'] * t['num_minibatches']
    trace = common.combine_traces(
        [(p, per_step_ctrl / len(rec.profiles['env']))
         for p in rec.profiles['env']]
        + [(p, n_mb / len(rec.profiles['sgd'])) for p in rec.profiles['sgd']])
    trace['substeps'] = per_step_ctrl * ctx.cfg['substeps']
    context['trace'] = trace
    if rec.sgd_spans:
      context['unprofiled_s'] = (per_step_ctrl * rec.ctrl_step_s
                                 + n_mb * np.mean(rec.sgd_spans))
  values = compare(ctx, t, sd, rec)
  _cleanup(start_dir)
  return common.Outcome(
      end_to_end={'train_env_steps_per_s': steps / secs},
      checks=common.checks_from(values, ctx.limits),
      attempted=steps, failed=0, memory_peak_bytes=int(peak),
      context=context)


def _cleanup(start_dir):
  path = os.path.join(start_dir, 'params.pt')
  if os.path.exists(path):
    os.remove(path)


def network_flops(ctx, t) -> float:
  """Matmul FLOPs of one training step: the rollout's policy forward on
  every env-step; every minibatch's policy and value forward and
  backward, and the value forward of its bootstrap rows."""
  policy, value = layer_sizes(ctx, t)
  rows = steps_per_training_step(t)
  mb_rows = t['batch_size'] * t['unroll_length']
  n_mb = t['num_updates_per_batch'] * t['num_minibatches']
  return (rows * net_flops.forward(policy)
          + n_mb * (mb_rows * (net_flops.forward_backward(policy)
                               + net_flops.forward_backward(value))
                    + t['batch_size'] * net_flops.forward(value)))


# -- the reference -----------------------------------------------------------


def _np(x):
  return x.detach().double().cpu().numpy()


def ref_networks(ctx, t, sd, dtype, device='cpu'):
  """The frozen ``PPONetworks`` holding the starting weights."""
  from benchmark.reference.frozen.train import networks

  nf = t['network_factory']
  net = networks.make_ppo_networks(
      ctx.cfg['obs_sizes'] if ctx.cfg['env'].startswith('Go2')
      else ctx.cfg['obs_sizes']['state'], ctx.cfg['action_size'],
      policy_hidden_layer_sizes=tuple(nf['policy_hidden_layer_sizes']),
      value_hidden_layer_sizes=tuple(nf['value_hidden_layer_sizes']),
      policy_obs_key=nf['policy_obs_key'], value_obs_key=nf['value_obs_key'])
  net.load_state_dict(sd)
  return net.to(device=device, dtype=dtype)


def _cast(tree, dtype, device='cpu'):
  from benchmark.reference.frozen.envs.wrappers import tree_map

  return tree_map(lambda x: x.to(device=device, dtype=dtype)
                  if x.is_floating_point() else x.to(device), tree)


def _carry_transition(x, dtype, device='cpu'):
  """A port ``Transition`` as the frozen copy's, cast."""
  from benchmark.reference.frozen.train.losses import Transition

  return Transition(*(_cast(v, dtype, device) for v in x))


def sgd_reference(ctx, t, sd, rec, normalizer, dtype, device='cpu',
                  half=False):
  """Three SGD steps of the frozen loss, the clip and Adam on the recorded
  minibatches; (losses (each with its scale and the gradient's global
  norm before the clip), first gradients, parameters after three) by
  leaf.
  ``half`` plants a fault: each minibatch's first half of rows alone."""
  import torch
  from benchmark.reference.frozen.train import losses

  net = ref_networks(ctx, t, sd, dtype, device)
  opt = torch.optim.Adam(net.parameters(), lr=t['learning_rate'],
                         betas=(0.9, 0.999), eps=1e-8)
  out_losses, grads = [], None
  for k, e in enumerate(rec.sgd):
    data = _carry_transition(e['data'], dtype, device)
    noise = e['noise'].to(device=device, dtype=dtype)
    if half:
      m = noise.shape[1] // 2
      data = type(data)(*(_slice(v, m) for v in data))
      noise = noise[:, :m]
    kw = dict(e['loss_kwargs'])
    opt.zero_grad(set_to_none=True)
    with torch.enable_grad():
      loss, m = losses.compute_ppo_loss(net, normalizer, data, noise, **kw)
      loss.backward()
    gs = [p.grad for p in net.parameters()]
    with torch.no_grad():
      norm = torch.sqrt(sum(torch.sum(g * g) for g in gs))
      if e['max_grad_norm'] is not None and norm >= e['max_grad_norm']:
        for g in gs:
          g.mul_(e['max_grad_norm'] / norm)
    if k == 0:
      grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
    opt.step()
    # the loss and its scale: the sum of its terms' magnitudes
    out_losses.append((loss.item(), float(
        m['policy_loss'].abs() + m['v_loss'] + m['entropy_loss'].abs()
        + m['sim2real_loss'].abs()), float(norm)))
  after = {n: p.detach().clone() for n, p in net.named_parameters()}
  return out_losses, grads, after


def _slice(tree, m):
  from benchmark.reference.frozen.envs.wrappers import tree_map

  return tree_map(lambda x: x[:m], tree)


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
  """Each leaf's gap of norms, |‖p‖ − ‖r‖| over the larger of ‖r‖ and
  the median leaf's ‖r‖."""
  norms_r = {k: float(np.linalg.norm(_np(v))) for k, v in ref.items()}
  med = float(np.median(list(norms_r.values())))
  return {k: abs(float(np.linalg.norm(_np(prog[k]))) - r) / max(r, med, 1e-30)
          for k, r in norms_r.items() if keep is None or k in keep}


def sgd_numbers(rec, sd, losses_r, grads_r, after_r, losses_p=None,
                grads_p=None, after_p=None, why=None):
  """The first step's loss gap (over the sum of the reference loss's
  terms' magnitudes); the median leaf's gap of the first gradient's and
  of the three steps' change's norms.  The worst leaf's and the later
  steps' gaps swing from seed to seed with Adam's first steps on
  gradients near nought, in single small leaves: ``why`` receives them,
  and the worst leaves' names, for the look."""
  losses_p = [x[0] if isinstance(x, tuple) else float(x)
              for x in losses_p or [e['loss'] for e in rec.sgd]]
  grads_p = grads_p or rec.sgd[0]['grads']
  after_p = after_p or rec.sgd[-1]['after']
  loss = [abs(p - r) / max(scale, 1e-12)
          for p, (r, scale, _) in zip(losses_p, losses_r)]
  gnorm = {k: float(np.linalg.norm(_np(v))) for k, v in grads_r.items()}
  med = float(np.median(list(gnorm.values())))
  # leaves whose reference gradient is nought to rounding move by
  # round-off alone under Adam: left out of the change by this rule
  keep = {k for k, v in gnorm.items() if v >= 1e-3 * med}
  start = {k: v.double() for k, v in sd.items()}
  change_r = {k: after_r[k].cpu().double() - start[k] for k in after_r}
  change_p = {k: after_p[k].cpu().double() - start[k] for k in after_r}
  grad = leaf_gaps(grads_p, grads_r)
  change = leaf_gaps(change_p, change_r, keep)
  if why is not None:
    worst = lambda g: max(g.items(), key=lambda kv: kv[1])
    why.update(loss_by_step=loss, worst_grad=worst(grad),
               worst_change=worst(change), left_out=sorted(set(gnorm) - keep),
               ref_norm_before_clip=[x[2] for x in losses_r])
    if rec is not None:
      why['prog_norm_after_clip'] = [
          float(np.sqrt(sum(np.sum(_np(g) ** 2) for g in e['grads'].values())))
          for e in rec.sgd]
  return {'loss_gap': loss[0],
          'grad_norm_gap': float(np.median(list(grad.values()))),
          'param_change_gap': float(np.median(list(change.values())))}


def ref_normalizer(ctx, rec, dtype, device='cpu', half=False, rows=None):
  """The frozen normaliser updated from the first batch's observations
  (``half``: the first half of the envs alone, a fault; ``rows=0``: not
  updated, a fault)."""
  import torch
  from benchmark.reference.frozen.envs.wrappers import tree_map
  from benchmark.reference.frozen.train import running_statistics as rs

  obs = _cast(tree_map(lambda *xs: torch.cat(xs, dim=1), *rec.batch),
              dtype, device)
  init = rs.init_state(ctx.cfg['obs_sizes'] if isinstance(obs, dict)
                       else ctx.cfg['obs_sizes']['state'], device)
  init = rs.to(init, device, dtype)
  if rows == 0:
    return init
  if half:
    obs = tree_map(lambda x: x[:, : x.shape[1] // 2], obs)
  return rs.update(init, obs)


def normalizer_gap(prog, ref) -> float:
  """Worst entry of |Δmean| / std and |Δstd| / std."""
  def leaves(x):
    return [x] if not isinstance(x, dict) else [x[k] for k in sorted(x)]
  worst = 0.0
  for mp, mr, sp, sr in zip(leaves(prog.mean), leaves(ref.mean),
                            leaves(prog.std), leaves(ref.std)):
    sr_ = _np(sr)
    worst = max(worst, float(np.max(np.abs(_np(mp) - _np(mr)) / sr_)),
                float(np.max(np.abs(_np(sp) - sr_) / sr_)))
  return worst


def physics_numbers(ctx, t, rec):
  """The physics numbers of the program, every env: ``obs_gap``, the
  widest gap over envs, at the start (the observation, against the
  frozen reset from the trainer's env stream) and after the first control
  step (observation and reward, against the frozen stack from the
  program's state with its sampled action), of each env's widest gap to
  the reference (``common.nearer_gap``: float64, or float32 where
  nearer); ``envs_off``, the envs that leave the references by more than
  ``common.SPLIT`` of an entry where the two agree within it and that
  the reference from the state with its qpos moved by a millionth does
  not reach either (``rollout.unexplained``); ``done_mismatch``, the envs whose done differs
  from both references'.  Returns (numbers, {fault: numbers}, what the look
  prints), the faults planted in the recorded step."""
  start, rng, data = rec.unroll
  nxt = data.next_observation
  nxt = ({k: v[0] for k, v in nxt.items()} if isinstance(nxt, dict)
         else nxt[0])
  prog = np.concatenate([_np(follow.flat_obs(nxt)),
                         _np(data.reward[0])[:, None]], axis=1)
  return _physics(ctx, t, rec, start.obs, prog, _np(data.discount[0]) < 0.5)


def _physics(ctx, t, rec, prog_start, prog, prog_done):
  """``physics_numbers`` of the given start observation, step vector
  (observation and reward) and done."""
  import torch
  from benchmark.generators.rollout import done_of, step_vector, unexplained

  B = t['num_envs']
  start, rng, data = rec.unroll
  action = data.action[0]
  flat = lambda obs: _np(follow.flat_obs(obs))
  r0, ref, dn, stack = {}, {}, {}, {}
  for dt in (torch.float64, torch.float32):
    env0, env = stack[dt] = follow.training_stack(ctx.cfg, ctx.device, dt, B)
    g = torch.Generator(device=ctx.device).manual_seed(env_seed(ctx.seed))
    r0[dt] = flat(env0.reset(g, B).obs)
    s = follow.step(env, start, action, dt, rng)
    ref[dt], dn[dt] = step_vector(s), done_of(s)
  env0, env = stack[torch.float64]

  def moved_reset(seed):
    g = torch.Generator(device=ctx.device).manual_seed(env_seed(ctx.seed))
    init = follow.moved_init(env0.sample_init(g, B), seed)
    return flat((env0.reset_to(init, g) if isinstance(init, dict)
                 else env0.reset_to(*init)).obs)
  refs = (ref[torch.float64], ref[torch.float32])
  first = common.nearer_gap(flat(prog_start), r0[torch.float64],
                            r0[torch.float32])
  gap = common.nearer_gap(prog, *refs)
  same = common.nearer_gap(step_vector(start), *refs)
  half = np.concatenate([gap[: B // 2], same[B // 2:]])
  miss = lambda d: (d != dn[torch.float64]) & (d != dn[torch.float32])
  dp, ds = miss(prog_done), miss(done_of(start))
  o0 = int(unexplained(flat(prog_start), r0[torch.float64],
                       r0[torch.float32], moved_reset).sum())
  op = unexplained(prog, *refs, lambda seed: step_vector(follow.step(
      env, start, action, torch.float64, rng, moved=seed)))
  # a fault's envs lie orders beyond a millionth's reach: no witness
  os_ = common.off_envs(step_vector(start), *refs)
  look = common.merge_looks([
      common.split_look(flat(prog_start), r0[torch.float64],
                        r0[torch.float32]),
      common.split_look(prog, *refs)])
  numbers = {'obs_gap': float(max(first.max(), gap.max())),
             'envs_off': float(o0 + op.sum()),
             'done_mismatch': float(dp.sum())}
  faults = {'unchanged': {'obs_gap': float(same.max()),
                          'envs_off': float(o0 + os_.sum()),
                          'done_mismatch': float(ds.sum())},
            'half_batch': {'obs_gap': float(half.max()),
                           'envs_off': float(o0 + op[: B // 2].sum()
                                             + os_[B // 2:].sum()),
                           'done_mismatch': float(dp[: B // 2].sum()
                                                  + ds[B // 2:].sum())}}
  return numbers, faults, look


def physics_control(ctx, t, rec):
  """The physics numbers of the frozen stack in the program's place: in
  float32 with TF32 on (the precision control), and in float32 from the
  program's state with its physics state rounded through bfloat16 (the
  start from the reset so rounded)."""
  import torch
  from benchmark.generators.rollout import bf16_init, done_of, step_vector
  from benchmark.reference.frozen.physics import forward as ref_forward

  f32 = torch.float32
  B = t['num_envs']
  start, rng, data = rec.unroll
  action = data.action[0]
  env0, env = follow.training_stack(ctx.cfg, ctx.device, f32, B)

  def outputs(state, first):
    s = follow.step(env, state, action, f32, rng)
    return first, step_vector(s), done_of(s)

  def reset(rounded):
    g = torch.Generator(device=ctx.device).manual_seed(env_seed(ctx.seed))
    init = env0.sample_init(g, B)
    if not rounded:
      return env0.reset(
          torch.Generator(device=ctx.device).manual_seed(env_seed(ctx.seed)),
          B).obs
    init = bf16_init(init)
    return (env0.reset_to(init, g) if isinstance(init, dict)
            else env0.reset_to(*init)).obs

  ref_forward.ALLOW_TF32 = True
  try:
    tf32 = outputs(start, reset(False))
  finally:
    ref_forward.ALLOW_TF32 = False
  bf16 = outputs(follow.bf16_physics(start), reset(True))
  low, _, look = _physics(ctx, t, rec, *bf16)
  print(f'train: the look at bfloat16 {look}', file=sys.stderr)
  return _physics(ctx, t, rec, *tf32)[0], low


def log_prob(ctx, t, sd, rec, dtype, device='cpu'):
  """The behaviour log-probability of the first step's sampled pre-tanh
  actions under the frozen networks at the starting weights and the
  starting normaliser (nothing updates it before the first unroll)."""
  import torch
  from benchmark.reference.frozen.train import running_statistics as rs

  start, _, data = rec.unroll
  net = ref_networks(ctx, t, sd, dtype, device)
  obs = _cast(start.obs, dtype, device)
  init = rs.to(rs.init_state(ctx.cfg['obs_sizes'] if isinstance(obs, dict)
                             else ctx.cfg['obs_sizes']['state'], device),
               device, dtype)
  with torch.no_grad():
    logits = net.policy_logits(rs.normalize(init, obs))
    raw = data.extras['policy_extras']['raw_action'][0].to(device, dtype)
    return _np(net.distribution.log_prob(logits, raw))


def rel_gap(a, ref) -> float:
  """Widest |a − ref| over max(1, |ref|)."""
  return float(np.max(np.abs(a - ref) / np.maximum(1.0, np.abs(ref))))


def compare(ctx, t, sd, rec) -> dict:
  import torch

  f64 = torch.float64
  out, _, look = physics_numbers(ctx, t, rec)
  print(f'train: the look at the envs {look}', file=sys.stderr)
  out['log_prob_gap'] = rel_gap(
      _np(rec.unroll[2].extras['policy_extras']['log_prob'][0]),
      log_prob(ctx, t, sd, rec, f64))
  norm_r = ref_normalizer(ctx, rec, f64)
  out['normalizer_gap'] = normalizer_gap(rec.sgd[0]['normalizer'], norm_r)
  losses_r, grads_r, after_r = sgd_reference(ctx, t, sd, rec, norm_r, f64)
  why = {}
  out.update(sgd_numbers(rec, sd, losses_r, grads_r, after_r, why=why))
  print(f'train: the look {why}', file=sys.stderr)
  return out


def readings(ctx) -> dict:
  """The program's numbers, the control's (the reference in float32 with
  TF32 on the card, in the program's place), the physics' with its state
  rounded through bfloat16 (``physics_control``) and the faults' planted in
  the reference or the recorded data (each minibatch's or the batch's
  first half alone; a step that returns its state; a normaliser not
  updated; an Adam step that leaves the parameters reads 1 by the
  change's measure), from one training step."""
  import torch

  t, env0, sd, start_dir, _ = setup(ctx)
  _, rec = window(ctx, t, env0, start_dir, 1, False)
  _cleanup(start_dir)
  program = compare(ctx, t, sd, rec)
  f64 = torch.float64
  norm_r = ref_normalizer(ctx, rec, f64)
  ref = sgd_reference(ctx, t, sd, rec, norm_r, f64)
  _, faults, look = physics_numbers(ctx, t, rec)
  control, bf16 = physics_control(ctx, t, rec)
  dev = ctx.device
  tf32 = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    norm_c = ref_normalizer(ctx, rec, torch.float32, dev)
    control['log_prob_gap'] = rel_gap(
        log_prob(ctx, t, sd, rec, torch.float32, dev),
        log_prob(ctx, t, sd, rec, f64))
    control['normalizer_gap'] = normalizer_gap(norm_c, norm_r)
    c = sgd_reference(ctx, t, sd, rec, norm_c, torch.float32, dev)
  finally:
    torch.backends.cuda.matmul.allow_tf32 = tf32
  control.update(sgd_numbers(rec, sd, *ref, *c))
  # the look: the reference in float32 on the card with TF32 off, in the
  # program's place (what rounding alone gives on this seed's data)
  torch.backends.cuda.matmul.allow_tf32 = False
  f32 = sgd_reference(ctx, t, sd, rec, ref_normalizer(ctx, rec, torch.float32,
                                                      dev), torch.float32, dev)
  torch.backends.cuda.matmul.allow_tf32 = tf32
  why = {}
  print(f'train: the look at float32 {sgd_numbers(rec, sd, *ref, *f32, why=why)}'
        f' {why}', file=sys.stderr)
  h = sgd_reference(ctx, t, sd, rec, norm_r, f64, half=True)
  faults['half_batch'].update(sgd_numbers(rec, sd, *ref, *h))
  faults['half_batch']['normalizer_gap'] = normalizer_gap(
      ref_normalizer(ctx, rec, f64, half=True), norm_r)
  faults['unchanged'].update(
      param_change_gap=1.0,
      normalizer_gap=normalizer_gap(ref_normalizer(ctx, rec, f64, rows=0),
                                    norm_r))
  return {'program': program, 'control': control, 'physics_bf16': bf16,
          'faults': faults, 'look': look}
