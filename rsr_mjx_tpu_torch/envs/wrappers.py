"""The training wrapper stack over batched envs.

Counterpart of ``rsr_mjx_tpu/envs/wrappers.py``, ``wrap_for_training``'s
stack:
  - BatchWrapper: fixes the batch size (the role of the JAX VmapWrapper;
    envs here are batched natively), or in its place
    DomainRandomizationWrapper: binds one model per env (the JAX
    DomainRandomizationVmapWrapper);
  - CanonicalDtypeWrapper: pins every float tensor to the physics dtype;
  - EpisodeWrapper: step counting, time-limit done, ``truncation``;
  - NonFiniteGuardWrapper: quarantines numerically blown envs and restores
    their reset-time info;
  - AutoResetWrapper: restores the cached first state where done.
The JAX StrongTypeWrapper clears JAX weak types and has no counterpart.
``EvalWrapper`` goes above the stack for the evaluator;
``SelectObservationWrapper`` goes below it, to feed a trainer with a flat
policy one entry of a dict observation.

Every step builds new ``info``/``metrics`` dicts, so a state returned by a
step never aliases the dicts of the state it came from.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import torch

from rsr_mjx_tpu_torch.envs.core import Env, State, Wrapper
from rsr_mjx_tpu_torch.utils import tracing


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


def _bind_copy(env: Env, model) -> Env:
  """A copy of the wrapper chain ``env`` whose innermost env steps with
  ``model``; ``env`` itself is left as it is."""
  out = copy.copy(env)
  if isinstance(env, Wrapper):
    out.env = _bind_copy(env.env, model)
  else:
    out.bind_model(model)
  return out


class DomainRandomizationWrapper(Wrapper):
  """One randomised model per env (JAX DomainRandomizationVmapWrapper).

  ``randomization_fn(model)`` returns a batched model (``Model.batched``
  leaves with a leading env axis; ``envs.get_domain_randomizer`` with its
  generator and batch size bound).  It is bound to a copy of ``env``, so
  env i steps with model i through every auto-reset, and whoever else holds
  ``env`` (an evaluator) keeps the nominal model.  The batch size is the
  model's."""

  def __init__(self, env: Env, randomization_fn: Callable):
    model = randomization_fn(env.model)
    if model.batch_size is None:
      raise ValueError('randomization_fn returned a model with no '
                       'per-env leaves')
    super().__init__(_bind_copy(env, model))
    self.batch_size = model.batch_size

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
  """Restores the cached first state where done.  The outermost wrapper
  of ``wrap_for_training``: its ``step`` and ``reset`` are the spans
  ``env.step`` and ``env.reset`` of ``utils.tracing`` (their self time is
  the env layer outside the physics)."""

  @tracing.span('env.reset')
  def reset(self, *args) -> State:
    state = self.env.reset(*args)
    info = dict(state.info)
    info['first_data'] = state.data
    info['first_obs'] = state.obs
    return state.replace(info=info)

  @tracing.span('env.step')
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


@dataclasses.dataclass
class EvalMetrics:
  """Per-env metrics summed over the episode, whether the episode is still
  running (1) or has ended (0), and the steps it took (brax EvalMetrics)."""

  episode_metrics: dict
  active_episodes: torch.Tensor
  episode_steps: torch.Tensor


class EvalWrapper(Wrapper):
  """Accumulates each env's reward and metrics up to its first done, in
  ``info['eval_metrics']``, for the Evaluator; above ``wrap_for_training``,
  whose ``steps`` it reads."""

  def reset(self, *args) -> State:
    state = self.env.reset(*args)
    metrics = dict(state.metrics, reward=state.reward)
    info = dict(state.info)
    info['eval_metrics'] = EvalMetrics(
        episode_metrics={k: torch.zeros_like(v) for k, v in metrics.items()},
        active_episodes=torch.ones_like(state.reward),
        episode_steps=torch.zeros_like(state.reward))
    return state.replace(metrics=metrics, info=info)

  def step(self, state: State, action: torch.Tensor) -> State:
    info = dict(state.info)
    em = info.pop('eval_metrics')
    nstate = self.env.step(state.replace(info=info), action)
    metrics = dict(nstate.metrics, reward=nstate.reward)
    active = em.active_episodes
    info = dict(nstate.info)
    info['eval_metrics'] = EvalMetrics(
        episode_metrics={k: v + metrics[k] * active
                         for k, v in em.episode_metrics.items()},
        active_episodes=active * (1 - nstate.done),
        episode_steps=torch.where(active > 0, nstate.info['steps'],
                                  em.episode_steps))
    return nstate.replace(metrics=metrics, info=info)


class SelectObservationWrapper(Wrapper):
  """Replaces a dict observation by its entry ``key`` (the SAC policy of a
  Go2 task reads ``state``).  The inner env's step reads ``data`` and
  ``info`` only, so it takes the state with the selected obs."""

  def __init__(self, env: Env, key: str = 'state'):
    super().__init__(env)
    self._key = key

  def reset(self, *args) -> State:
    state = self.env.reset(*args)
    return state.replace(obs=state.obs[self._key])

  def step(self, state: State, action: torch.Tensor) -> State:
    nstate = self.env.step(state, action)
    return nstate.replace(obs=nstate.obs[self._key])

  @property
  def observation_size(self) -> int:
    return self.env.observation_size[self._key][-1]


def wrap_for_training(env: Env, episode_length: int = 1000,
                      action_repeat: int = 1, num_envs: int = 1,
                      qvel_limit: float = 1e3,
                      randomization_fn: Optional[Callable] = None) -> Env:
  """The JAX package's training stack: Batch (DomainRandomization where a
  ``randomization_fn`` is given; its model's batch size replaces
  ``num_envs``) → CanonicalDtype → Episode → NonFiniteGuard → AutoReset."""
  if randomization_fn is None:
    env = BatchWrapper(env, num_envs)
  else:
    env = DomainRandomizationWrapper(env, randomization_fn)
  env = CanonicalDtypeWrapper(env)
  env = EpisodeWrapper(env, episode_length, action_repeat)
  env = NonFiniteGuardWrapper(env, qvel_limit=qvel_limit)
  return AutoResetWrapper(env)
