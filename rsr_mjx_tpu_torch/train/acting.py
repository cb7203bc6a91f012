"""Rollout generation and evaluation.

Counterpart of ``rsr_mjx_tpu/train/acting.py``.  A rollout is a Python loop
over control steps under ``torch.no_grad()``: the physics kernels have no
autograd, so no tensor that requires grad may reach the env.  A policy is
``policy(obs, generator) → (action, extras)``; the stochastic policy draws
its noise for all envs from the one ``torch.Generator`` it is given, or
from a ``core.RowStream`` (a trainer under a process group): then each
env's noise depends on its index in the whole batch only, so that a
rollout on N devices equals the rollout on one, as the JAX trainer's
per-env keys make it.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from rsr_mjx_tpu_torch.envs.core import Env, State
from rsr_mjx_tpu_torch.envs.wrappers import tree_map
from rsr_mjx_tpu_torch.train.losses import Transition
from rsr_mjx_tpu_torch.utils import tracing

Policy = Callable[[torch.Tensor, torch.Generator], Tuple[torch.Tensor, dict]]


@torch.no_grad()
def actor_step(env: Env, env_state: State, policy: Policy,
               generator: torch.Generator,
               extra_fields: Sequence[str] = ()) -> Tuple[State, Transition]:
  """One policy step in a batched env."""
  actions, policy_extras = policy(env_state.obs, generator)
  nstate = env.step(env_state, actions)
  state_extras = {x: nstate.info[x] for x in extra_fields}
  return nstate, Transition(
      observation=env_state.obs,
      action=actions,
      reward=nstate.reward,
      discount=1 - nstate.done,
      next_observation=nstate.obs,
      extras={'policy_extras': policy_extras, 'state_extras': state_extras},
  )


@torch.no_grad()
def generate_unroll(env: Env, env_state: State, policy: Policy,
                    generator: torch.Generator, unroll_length: int,
                    extra_fields: Sequence[str] = ()
                    ) -> Tuple[State, Transition]:
  """``unroll_length`` steps; transitions stacked time-major [T, B, ...].
  Span ``ppo.unroll``."""
  with tracing.span('ppo.unroll'):
    steps = []
    for _ in range(unroll_length):
      env_state, transition = actor_step(env, env_state, policy, generator,
                                         extra_fields)
      steps.append(transition)
    return env_state, tree_map(lambda *xs: torch.stack(xs), *steps)


class Evaluator:
  """Policy evaluation over fresh episodes (brax acting.Evaluator).
  ``eval_env`` is wrapped for training with ``num_eval_envs`` envs and an
  ``EvalWrapper`` on top."""

  def __init__(self, eval_env: Env, eval_policy_fn: Callable[..., Policy],
               num_eval_envs: int, episode_length: int, action_repeat: int,
               generator: torch.Generator):
    self._env = eval_env
    self._policy_fn = eval_policy_fn
    self._generator = generator
    self._unroll_length = episode_length // action_repeat
    self._eval_walltime = 0.0
    self._steps_per_unroll = episode_length * num_eval_envs

  def run_evaluation(self, params, training_metrics):
    t = time.time()
    state = self._env.reset(self._generator)
    state, _ = generate_unroll(self._env, state, self._policy_fn(params),
                               self._generator, self._unroll_length)
    eval_metrics = state.info['eval_metrics']
    epi_rewards = eval_metrics.episode_metrics['reward'].cpu().numpy()
    epi_lengths = eval_metrics.episode_steps.cpu().numpy()
    epoch_eval_time = time.time() - t
    self._eval_walltime += epoch_eval_time
    # a numerically blown env shows as eval/nan_episodes and is kept out
    # of the mean; if every one blew up, the reward reads NaN
    finite = np.isfinite(epi_rewards)
    n_nan = int((~finite).sum())
    if n_nan:
      epi_rewards = epi_rewards[finite]
      epi_lengths = epi_lengths[finite]
    if epi_rewards.size == 0:
      epi_rewards = np.full(1, np.nan)
      epi_lengths = np.full(1, np.nan)
    return {
        'eval/episode_reward': float(np.mean(epi_rewards)),
        'eval/episode_reward_std': float(np.std(epi_rewards)),
        'eval/avg_episode_length': float(np.mean(epi_lengths)),
        'eval/nan_episodes': n_nan,
        'eval/epoch_eval_time': epoch_eval_time,
        'eval/sps': self._steps_per_unroll / epoch_eval_time,
        'eval/walltime': self._eval_walltime,
        **training_metrics,
    }
