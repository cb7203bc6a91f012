"""The training wrapper stack over batched envs.

Counterpart of ``rsr_mjx_tpu/envs/wrappers.py``, ``wrap_for_training``'s
stack:
  - BatchWrapper: fixes the batch size (the role of the JAX VmapWrapper;
    envs here are batched natively);
  - CanonicalDtypeWrapper: pins every float tensor to the physics dtype;
  - EpisodeWrapper: step counting, time-limit done, ``truncation``;
  - NonFiniteGuardWrapper: quarantines numerically blown envs and restores
    their reset-time info;
  - AutoResetWrapper: restores the cached first state where done.
The JAX StrongTypeWrapper clears JAX weak types and has no counterpart.
The port's domain-randomisation, evaluation and observation-selection
wrappers are left out of this copy.

Every step builds new ``info``/``metrics`` dicts, so a state returned by a
step never aliases the dicts of the state it came from.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.frozen.envs.core import Env, State, Wrapper


def tree_map(fn, *trees):
  """Apply ``fn`` leafwise over tensors in matching dataclass (State, Data,
  Contact) / dict / tuple / NamedTuple / list structures; other leaves
  (python numbers, static numpy arrays, a ``torch.Generator``, None) pass
  through from the first tree."""
  t0 = trees[0]
  if isinstance(t0, torch.Tensor):
    return fn(*trees)
  if dataclasses.is_dataclass(t0):
    return dataclasses.replace(t0, **{
        f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
        for f in dataclasses.fields(t0)
    })
  if isinstance(t0, dict):
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
  if isinstance(t0, (tuple, list)):
    leaves = [tree_map(fn, *xs) for xs in zip(*trees)]
    # a NamedTuple (a Transition) takes its fields as arguments
    return type(t0)(*leaves) if hasattr(t0, '_fields') else type(t0)(leaves)
  return t0


def _where(mask: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
  """torch.where with a per-env mask (B,) broadcast over trailing axes."""
  return torch.where(mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)),
                     x, y)


def _nan_to_zero(x: torch.Tensor) -> torch.Tensor:
  if x.is_floating_point():
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
  return x


class BatchWrapper(Wrapper):
  """Holds the batch size: ``reset(generator)`` resets ``batch_size`` envs."""

  def __init__(self, env: Env, batch_size: int):
    super().__init__(env)
    self.batch_size = batch_size

  def reset(self, generator: torch.Generator) -> State:
    return self.env.reset(generator, self.batch_size)


class CanonicalDtypeWrapper(Wrapper):
  """Pins every float tensor of reset/step outputs to the physics dtype."""

  def __init__(self, env: Env):
    super().__init__(env)
    self._dtype = env.model.qpos0.dtype

  def _pin(self, state: State) -> State:
    cast = lambda x: x.to(self._dtype) if x.is_floating_point() else x
    return tree_map(cast, state)

  def reset(self, *args) -> State:
    return self._pin(self.env.reset(*args))

  def step(self, state: State, action: torch.Tensor) -> State:
    return self._pin(self.env.step(state, action))


class EpisodeWrapper(Wrapper):
  """Time limit and action repeat (brax episode semantics)."""

  def __init__(self, env: Env, episode_length: int, action_repeat: int = 1):
    super().__init__(env)
    self.episode_length = episode_length
    self.action_repeat = action_repeat

  def reset(self, *args) -> State:
    state = self.env.reset(*args)
    info = dict(state.info)
    info['steps'] = torch.zeros_like(state.reward)
    info['truncation'] = torch.zeros_like(state.reward)
    return state.replace(info=info)

  def step(self, state: State, action: torch.Tensor) -> State:
    reward = torch.zeros_like(state.reward)
    for _ in range(self.action_repeat):
      state = self.env.step(state, action)
      reward = reward + state.reward
    info = dict(state.info)
    steps = info['steps'] + self.action_repeat
    over = steps >= self.episode_length
    done = torch.where(over, torch.ones_like(state.done), state.done)
    info['truncation'] = torch.where(over, 1 - state.done,
                                     torch.zeros_like(state.done))
    info['steps'] = steps
    return state.replace(reward=reward, done=done, info=info)


class NonFiniteGuardWrapper(Wrapper):
  """Quarantines numerically blown envs.

  Where qpos/qvel, obs or reward go non-finite or |qvel| exceeds
  ``qvel_limit``, the env is marked done (a termination, not a
  truncation), its reward is zeroed, its state is sanitized, and its
  reset-time info is restored; AutoReset then restores its first state.
  The trip count is the ``nonfinite`` metric.
  """

  def __init__(self, env: Env, qvel_limit: float = 1e3):
    super().__init__(env)
    self.qvel_limit = qvel_limit

  def _blown(self, state: State) -> torch.Tensor:
    qpos, qvel = state.data.qpos, state.data.qvel
    finite = (torch.all(torch.isfinite(qpos), dim=-1)
              & torch.all(torch.isfinite(qvel), dim=-1))
    speed = torch.amax(torch.abs(torch.nan_to_num(qvel, nan=float('inf'))),
                       dim=-1)
    blown = (~finite) | (speed > self.qvel_limit)
    obs = state.obs
    for leaf in (obs.values() if isinstance(obs, dict) else [obs]):
      blown = blown | ~torch.all(torch.isfinite(leaf), dim=-1)
    return blown | ~torch.isfinite(state.reward)

  def reset(self, *args) -> State:
    state = self.env.reset(*args)
    metrics = dict(state.metrics)
    metrics['nonfinite'] = torch.zeros_like(state.reward)
    info = dict(state.info)
    info['first_info'] = {k: v for k, v in info.items() if k != 'first_info'}
    return state.replace(metrics=metrics, info=info)

  def step(self, state: State, action: torch.Tensor) -> State:
    action = _nan_to_zero(action)
    inner_metrics = dict(state.metrics)
    inner_metrics.pop('nonfinite', None)
    state = self.env.step(state.replace(metrics=inner_metrics), action)
    blown = self._blown(state)
    where_blown = lambda x, y: _where(blown, x, y)

    data = tree_map(where_blown, tree_map(_nan_to_zero, state.data),
                    state.data)
    obs = tree_map(where_blown, tree_map(_nan_to_zero, state.obs), state.obs)
    reward = torch.where(blown, torch.zeros_like(state.reward), state.reward)
    done = torch.where(blown, torch.ones_like(state.done), state.done)
    metrics = tree_map(_nan_to_zero, state.metrics)
    metrics['nonfinite'] = blown.to(reward.dtype)
    info = dict(state.info)
    if 'truncation' in info:
      info['truncation'] = torch.where(
          blown, torch.zeros_like(info['truncation']), info['truncation'])
    for k, v in info.get('first_info', {}).items():
      if k != 'truncation' and k in info:
        info[k] = tree_map(where_blown, v, info[k])
    return state.replace(data=data, obs=obs, reward=reward, done=done,
                         metrics=metrics, info=info)


class AutoResetWrapper(Wrapper):
  """Restores the cached first state where done."""

  def reset(self, *args) -> State:
    state = self.env.reset(*args)
    info = dict(state.info)
    info['first_data'] = state.data
    info['first_obs'] = state.obs
    return state.replace(info=info)

  def step(self, state: State, action: torch.Tensor) -> State:
    info = dict(state.info)
    if 'steps' in info:
      info['steps'] = torch.where(state.done > 0,
                                  torch.zeros_like(info['steps']),
                                  info['steps'])
    state = state.replace(done=torch.zeros_like(state.done), info=info)
    state = self.env.step(state, action)
    where_done = lambda x, y: _where(state.done > 0, x, y)
    data = tree_map(where_done, state.info['first_data'], state.data)
    obs = tree_map(where_done, state.info['first_obs'], state.obs)
    return state.replace(data=data, obs=obs)


def wrap_for_training(env: Env, episode_length: int = 1000,
                      action_repeat: int = 1, num_envs: int = 1,
                      qvel_limit: float = 1e3) -> Env:
  """The JAX package's training stack: Batch → CanonicalDtype → Episode →
  NonFiniteGuard → AutoReset."""
  env = BatchWrapper(env, num_envs)
  env = CanonicalDtypeWrapper(env)
  env = EpisodeWrapper(env, episode_length, action_repeat)
  env = NonFiniteGuardWrapper(env, qvel_limit=qvel_limit)
  return AutoResetWrapper(env)
