"""Served rollouts: the trained policy's mode actions on ``serve_envs``
envs, back-to-back control steps of ``wrap_for_training(env).step`` for
the window, as the evaluation programs and data collection serve them.

The reset states are drawn from the seed by the frozen copy of the env's
reset distribution and handed to the port through ``reset_to`` (the Go2
joystick also takes a generator, made from the seed, for the episode's
later draws).  End to end: control env-steps (envs × control steps) over
the window, between two synchronisations.

Checked after the window: the start (the reset's forward pass) against
the frozen copy's ``reset_to`` in float64, and at control steps drawn from
the seed, the reference's step from the program's state with the
program's action (obs, reward, done, every env) and the reference's
policy at the program's observation (every env's action).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from benchmark import common
from benchmark.metrics import _readers
from benchmark.reference import follow
from benchmark.reference import policy as ref_policy


def _keys(cfg):
  nf = cfg['ppo']['network_factory']
  return nf['policy_obs_key'], nf['value_obs_key']


def _reset_adapter(env0, init, episode_seed, device):
  """The port's env with ``reset`` bound to ``reset_to(init)``: each reset
  starts the same envs, the Go2 joystick with a fresh episode generator
  from ``episode_seed``."""
  import torch
  from rsr_mjx_tpu_torch.envs.core import Wrapper

  class ResetTo(Wrapper):

    def reset(self, generator=None, batch_size=None):
      if isinstance(init, dict):
        g = torch.Generator(device=device).manual_seed(episode_seed)
        return self.env.reset_to(init, g)
      return self.env.reset_to(*init)

  return ResetTo(env0)


def draw_init(ctx, B):
  """The reset draws of ``B`` envs from the seed, by the frozen env's
  ``sample_init`` on the device, in float32.  The benchmark's own input,
  made with the reference's env: its seconds go to ``ctx.reference_s``,
  which ``setup_s`` leaves out."""
  import torch
  from benchmark.reference.frozen import envs as ref_envs

  t0 = time.perf_counter()
  ref0 = ref_envs.load(ctx.cfg['env'], device=ctx.device,
                       **ctx.cfg['env_kwargs'])
  g = torch.Generator(device=ctx.device).manual_seed(
      common.stream_seed(ctx.seed, 0))
  init = ref0.sample_init(g, B)
  _sync(ctx.device)
  ctx.reference_s += time.perf_counter() - t0
  return init


def setup(ctx):
  """(wrapped env, policy, B) of the port, warmed up on the cell's shapes."""
  import torch
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.train import networks

  cfg = ctx.cfg
  B = ctx.sizes.get('serve_envs', cfg['serve_envs'])
  env0 = envs.load(cfg['env'], device=ctx.device, **cfg['env_kwargs'])
  init = draw_init(ctx, B)
  env = wrappers.wrap_for_training(
      _reset_adapter(env0, init, common.stream_seed(ctx.seed, 1),
                     ctx.device),
      episode_length=cfg['episode_length'], num_envs=B)
  normalizer, params = networks.load_ppo_params(
      os.path.join(common.ROOT, cfg['weights']))
  pkey, vkey = _keys(cfg)
  policy = networks.make_policy(normalizer, params, ctx.device,
                                obs_key=pkey, value_obs_key=vkey)
  with torch.no_grad():
    state = env.reset(None)
    for _ in range(ctx.traffic['warmup_steps']):
      state = env.step(state, policy(state.obs))
  _sync(ctx.device)
  return env, policy, B, init


def _sync(device):
  import torch

  if device != 'cpu':
    torch.cuda.synchronize()


def window(ctx, env, policy, seconds, checked):
  """Control steps for ``seconds`` (and at least past the checked ones);
  returns (steps, seconds, the start state, {step: (state, generator
  state, action, next state)})."""
  import torch

  records = {}
  with torch.no_grad():
    state = env.reset(None)
    _sync(ctx.device)
    common.settle()
    start = state
    t0 = ctx.opened = time.perf_counter()
    steps = 0
    last = max(checked) if checked else -1
    while True:
      rng = follow.generator_state(state) if steps in checked else None
      action = policy(state.obs)
      nstate = env.step(state, action)
      if steps in checked:
        records[steps] = (state, rng, action, nstate)
      state = nstate
      steps += 1
      if steps > last and time.perf_counter() - t0 >= seconds:
        break
    _sync(ctx.device)
    return steps, time.perf_counter() - t0, start, records


def checked_steps(ctx):
  t = ctx.traffic
  rng = np.random.default_rng([ctx.seed, 2])
  lo, hi = t['checked_from'], t['checked_to']
  return set(int(s) for s in rng.choice(np.arange(lo, hi),
                                        size=t['checked_steps'],
                                        replace=False))


def _np(x):
  return x.detach().double().cpu().numpy()


def step_vector(state):
  """A state's observation and reward side by side, (B, n), float64
  numpy: what one control step produces for each env, done aside."""
  import torch

  return _np(torch.cat([follow.flat_obs(state.obs).double(),
                        state.reward.double()[:, None]], dim=1))


def done_of(state) -> np.ndarray:
  return _np(state.done) > 0.5


def stacks(ctx, B):
  """The frozen training stack in float64 and in float32 (TF32 off):
  {dtype: (env, wrapped env)}."""
  import torch

  return {dt: follow.training_stack(ctx.cfg, ctx.device, dt, B)
          for dt in (torch.float64, torch.float32)}


def compare(ctx, init, start, records, B, refs, policy_precision=None):
  """The numbers compared, of the program (or of a control in its place,
  whose actions are then the reference policy's at ``policy_precision``)
  against the frozen stack ``refs`` (``stacks``), every env:

  - ``obs_gap``: the widest gap over envs, at the start (the observation)
    and after each checked step (observation and reward), of each env's
    widest gap to the reference (``common.nearer_gap``: the float64
    reference, or the float32 one where that is nearer);
  - ``envs_off``: the envs, at the start and after each checked step,
    that leave the references by more than ``common.SPLIT`` of an entry
    where the two references agree within it (``common.off_envs``) and
    the reference from the state with its qpos moved by a millionth does
    not reach the program's outputs either (``unexplained``);
  - ``done_mismatch``: the envs whose done differs from both references';
  - ``action_gap``: the widest gap of any env's action to the float64
    reference policy at the program's observation.

  Returns (numbers, {fault: numbers}, what the look prints): the faults
  are planted in the recorded steps, a step that returns its state, and
  half of the envs left unstepped."""
  import torch

  cfg = ctx.cfg
  pkey = _keys(cfg)[0]
  normalizer, params = ref_policy.load(
      os.path.join(common.ROOT, cfg['weights']))
  f64, f32 = torch.float64, torch.float32
  flat = lambda s: _np(follow.flat_obs(s.obs))
  r0 = {dt: reset_to(ctx, refs[dt][0], init, dt) for dt in refs}
  gaps = [common.nearer_gap(flat(start), flat(r0[f64]), flat(r0[f32]))]
  off0 = unexplained(
      flat(start), flat(r0[f64]), flat(r0[f32]),
      lambda seed: flat(reset_to(ctx, refs[f64][0], init, f64, seed)))
  off = {'program': int(off0.sum()), 'unchanged': 0, 'half_batch': 0}
  look = [common.split_look(flat(start), flat(r0[f64]), flat(r0[f32]))]
  unchanged, half, act = [], [], []
  done = {'program': 0, 'unchanged': 0, 'half_batch': 0}
  for k in sorted(records):
    state, rng, action, nstate = records[k]
    ref = {dt: follow.step(refs[dt][1], state, action, dt, rng)
           for dt in refs}
    v64, v32 = step_vector(ref[f64]), step_vector(ref[f32])
    d64, d32 = done_of(ref[f64]), done_of(ref[f32])
    gap = common.nearer_gap(step_vector(nstate), v64, v32)
    look.append(common.split_look(step_vector(nstate), v64, v32))
    same = common.nearer_gap(step_vector(state), v64, v32)
    on = unexplained(
        step_vector(nstate), v64, v32,
        lambda seed: step_vector(follow.step(refs[f64][1], state, action,
                                             f64, rng, moved=seed)))
    # a fault's envs lie orders beyond a millionth's reach: no witness
    os_ = common.off_envs(step_vector(state), v64, v32)
    off['program'] += int(on.sum())
    off['unchanged'] += int(os_.sum())
    off['half_batch'] += int(on[: B // 2].sum() + os_[B // 2:].sum())
    gaps.append(gap)
    unchanged.append(same)
    half.append(np.concatenate([gap[: B // 2], same[B // 2:]]))
    miss = lambda d: (d != d64) & (d != d32)
    dn, ds = miss(done_of(nstate)), miss(done_of(state))
    done['program'] += int(dn.sum())
    done['unchanged'] += int(ds.sum())
    done['half_batch'] += int(dn[: B // 2].sum() + ds[B // 2:].sum())
    obs_k = _np(state.obs[pkey] if isinstance(state.obs, dict)
                else state.obs)
    want = ref_policy.mode(normalizer, params, obs_k, pkey, 'float64')
    got = (_np(action) if policy_precision is None else
           ref_policy.mode(normalizer, params, obs_k, pkey,
                           policy_precision))
    act.append(float(np.abs(got - want).max()))
  widest = lambda gs: float(max(g.max() for g in gs))
  out = {'obs_gap': widest(gaps), 'envs_off': float(off['program']),
         'done_mismatch': float(done['program']), 'action_gap': max(act)}
  faults = {f: {'obs_gap': widest(gs), 'envs_off': float(off[f]),
                'done_mismatch': float(done[f])}
            for f, gs in (('unchanged', unchanged), ('half_batch', half))}
  return out, faults, common.merge_looks(look)


def unexplained(prog, ref64, ref32, run) -> np.ndarray:
  """``common.off_envs`` less the envs that ``run(seed)``, the float64
  reference from the state with its qpos moved (``follow.reached``),
  brings to the program's outputs.  Prints each env left (at most five):
  its gaps to the two references and between them."""
  off = common.off_envs(prog, ref64, ref32)
  if off.any():
    off &= ~follow.reached(run, prog, off, common.SPLIT)
  for i in np.nonzero(off)[0][:5]:
    print(f'envs off: env {i} to f64 {common.rel_gap(prog, ref64)[i]:.3g} '
          f'to f32 {common.rel_gap(prog, ref32)[i]:.3g} f32 to f64 '
          f'{common.rel_gap(ref32, ref64)[i]:.3g}', file=sys.stderr)
  return off


def reset_to(ctx, env0, init, dtype, moved=None):
  """The frozen env's reset from the same draws (and, for the Go2
  joystick, the same episode generator) as the program's; ``moved``, a
  seed: with their qpos moved (``follow.moved_init``)."""
  import torch

  if isinstance(init, dict):
    init = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in init.items()}
  else:
    init = tuple(x.to(dtype) for x in init)
  if moved is not None:
    init = follow.moved_init(init, moved)
  if isinstance(init, dict):
    g = torch.Generator(device=ctx.device).manual_seed(
        common.stream_seed(ctx.seed, 1))
    return env0.reset_to(init, g)
  return env0.reset_to(*init)


def bf16_init(init):
  """The reset draws' floating entries rounded through bfloat16."""
  import torch

  r = lambda x: (x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point()
                 else x)
  if isinstance(init, dict):
    return {k: r(v) for k, v in init.items()}
  return tuple(r(x) for x in init)


def control(ctx, init, records, B, refs):
  """The precision control's numbers: the frozen stack in float32 with
  TF32 on, from the program's states, and the policy with its matmul
  inputs rounded to TF32; and the physics one precision further down:
  the frozen stack in float32 from the program's states with their
  physics state (``follow.BF16_FIELDS``) rounded through bfloat16, and
  the start from the reset draws so rounded.  Both held to the reference
  as the program is."""
  import torch
  from benchmark.reference.frozen.physics import forward as ref_forward

  f32 = torch.float32
  env0, env32 = refs[f32]
  ref_forward.ALLOW_TF32 = True
  try:
    c_start = reset_to(ctx, env0, init, f32)
    ctrl = {k: (state, rng, action,
                follow.step(env32, state, action, f32, rng))
            for k, (state, rng, action, _) in records.items()}
  finally:
    ref_forward.ALLOW_TF32 = False
  tf32, _, _ = compare(ctx, init, c_start, ctrl, B, refs,
                       policy_precision='tf32')
  b_start = reset_to(ctx, env0, bf16_init(init), f32)
  low = {k: (state, rng, action,
             follow.step(env32, follow.bf16_physics(state), action, f32,
                         rng))
         for k, (state, rng, action, _) in records.items()}
  bf16, _, look = compare(ctx, init, b_start, low, B, refs)
  print(f'rollout: the look at bfloat16 {look}', file=sys.stderr)
  return tf32, {k: bf16[k] for k in ('obs_gap', 'envs_off', 'done_mismatch')}


def run(ctx) -> common.Outcome:
  import torch

  env, policy, B, init = setup(ctx)
  checked = checked_steps(ctx)
  if ctx.device != 'cpu':
    torch.cuda.reset_peak_memory_stats()
  steps, secs, start, records = window(ctx, env, policy, ctx.seconds,
                                       checked)
  peak = torch.cuda.max_memory_allocated() if ctx.device != 'cpu' else 0
  context = {'envs': B, 'control_steps': steps, 'window_s': secs,
             'network_flops': _readers.policy_rows_flops(ctx.cfg,
                                                         steps * B)}
  if ctx.trace:
    context['trace'] = profile(ctx, env, policy)
    context['unprofiled_s'] = context['trace']['control_steps'] * secs / steps
  del env, policy
  values, _, look = compare(ctx, init, start, records, B, stacks(ctx, B))
  print(f'rollout: the look {look}', file=sys.stderr)
  return common.Outcome(
      end_to_end={'rollout_env_steps_per_s': steps * B / secs},
      checks=common.checks_from(values, ctx.limits),
      attempted=steps * B, failed=0, memory_peak_bytes=int(peak),
      context=context)


def profile(ctx, env, policy):
  """The profiled sub-window after the window: ``profiled_steps``
  control steps from a fresh reset's second step."""
  import torch
  from torch.profiler import record_function

  n = ctx.traffic['profiled_steps']
  with torch.no_grad():
    state = env.reset(None)
    state = env.step(state, policy(state.obs))
    with common.Profiled(ctx.device) as prof:
      for _ in range(n):
        with record_function('bench.policy'):
          action = policy(state.obs)
        with record_function('bench.env_step'):
          state = env.step(state, action)
  trace = prof.trace
  trace['substeps'] = n * ctx.cfg['substeps']
  trace['control_steps'] = n
  return trace


def readings(ctx) -> dict:
  """The program's numbers, the control's and the planted faults', on
  one short window."""
  env, policy, B, init = setup(ctx)
  checked = checked_steps(ctx)
  _, _, start, records = window(ctx, env, policy, ctx.seconds, checked)
  del env, policy
  refs = stacks(ctx, B)
  program, faults, look = compare(ctx, init, start, records, B, refs)
  tf32, bf16 = control(ctx, init, records, B, refs)
  return {'program': program, 'control': tf32, 'physics_bf16': bf16,
          'faults': faults, 'look': look}
