"""RSR policy training: validate the five dataset arrays, precompute the
penalty state, and train a policy with the penalty in its loss.

Counterpart of the policy half of ``rsr_mjx_tpu/rsr/pipeline.py``
(``build_policy_rsr_data``, ``policy_params_training``).  The PPO branch
trains with the port's ``train.ppo``; SAC is ROADMAP item 4 and raises.
Physics-parameter tuning (``env_params_tuning``) needs gradients through
the physics, ROADMAP item 3, and is not here yet.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from rsr_mjx_tpu_torch.rsr import loss as rsr_loss


def build_policy_rsr_data(
    past_states: Any,
    past_actions: Any,
    past_next_states_real: Any,
    past_next_states_sim: Any,
    current_next_states_sim: Any,
    num_samples: int = 10,
    min_val: float = -3.0,
    max_val: float = 3.0,
    bandwidth: float = 0.1,
    seed: int = 0,
    grid=None,
    device='cuda',
) -> rsr_loss.RSRData:
  """Validate the five arrays and precompute the ``RSRData`` on
  ``device``; ``grid`` as in ``loss.build_rsr_data``."""
  arrays = tuple(
      rsr_loss.as_tensor(v, device)
      for v in (past_states, past_actions, past_next_states_real,
                past_next_states_sim, current_next_states_sim)
  )
  (past_states, past_actions, past_next_states_real, past_next_states_sim,
   current_next_states_sim) = arrays

  if any(v.ndim != 2 for v in arrays):
    shapes = tuple(tuple(v.shape) for v in arrays)
    raise ValueError(f'all RSR datasets must be rank 2, got {shapes}')
  sample_counts = {v.shape[0] for v in arrays}
  if len(sample_counts) != 1:
    shapes = tuple(tuple(v.shape) for v in arrays)
    raise ValueError(f'RSR datasets must have equal lengths, got {shapes}')
  if next(iter(sample_counts)) == 0:
    raise ValueError('RSR datasets must not be empty')
  for name, v in (
      ('real next-state', past_next_states_real),
      ('previous sim next-state', past_next_states_sim),
      ('current sim next-state', current_next_states_sim),
  ):
    if v.shape[1] != past_states.shape[1]:
      raise ValueError(f'{name} width must match state width')

  real_data = torch.hstack([past_states, past_actions, past_next_states_real])
  previous_sim_data = torch.hstack(
      [past_states, past_actions, past_next_states_sim])
  current_sim_data = torch.hstack(
      [past_states, past_actions, current_next_states_sim])
  return rsr_loss.build_rsr_data(
      real_data,
      previous_sim_data,
      current_sim_data,
      num_samples=num_samples,
      min_value=min_val,
      max_value=max_val,
      bandwidth=bandwidth,
      seed=seed,
      grid=grid,
  )


def policy_params_training(
    env,
    restore_checkpoint_path: Optional[str] = None,
    policy_params_fn: Optional[Callable[..., None]] = None,
    network_factory: Optional[Callable[..., Any]] = None,
    progress_fn: Optional[Callable[..., None]] = None,
    past_states: Any = None,
    past_actions: Any = None,
    past_next_states_real: Any = None,
    past_next_states_sim: Any = None,
    current_next_states_sim: Any = None,
    algorithm: str = 'ppo',
    num_samples: int = 10,
    min_val: float = -3.0,
    max_val: float = 3.0,
    bandwidth: float = 0.1,
    rsr_loss_scale: float = 1.0,
    num_timesteps: int = 5_000_000,
    num_evals: int = 10,
    reward_scaling: float = 0.1,
    episode_length: int = 1200,
    normalize_observations: bool = True,
    action_repeat: int = 1,
    discounting: float = 0.96,
    learning_rate: float = 1e-4,
    num_envs: int = 512,
    batch_size: int = 128,
    seed: int = 0,
    num_eval_envs: int = 128,
    deterministic_eval: bool = False,
    # PPO-specific
    unroll_length: int = 10,
    num_minibatches: int = 32,
    num_updates_per_batch: int = 8,
    entropy_cost: float = 2e-2,
    # SAC-specific
    tau: float = 0.005,
    min_replay_size: int = 0,
    max_replay_size: Optional[int] = None,
    grad_updates_per_step: int = 1,
    checkpoint_logdir: Optional[str] = None,
    wrap_env_fn: Optional[Callable[..., Any]] = None,
    eval_env=None,
    device='cuda',
):
  """Train an RSR policy: PPO with the penalty built from the five
  datasets (``rsr_loss_scale`` times it) in the loss.  ``env`` and
  ``eval_env`` live on ``device``.  Returns (make_inference_fn, params),
  params being (normalizer, ``PPONetworks``)."""
  if rsr_loss_scale < 0:
    raise ValueError(
        f'rsr_loss_scale must be non-negative, got {rsr_loss_scale}'
    )
  required = (
      past_states,
      past_actions,
      past_next_states_real,
      past_next_states_sim,
      current_next_states_sim,
  )
  if any(v is None for v in required):
    raise ValueError('all five RSR policy datasets are required')

  past_data = build_policy_rsr_data(
      past_states,
      past_actions,
      past_next_states_real,
      past_next_states_sim,
      current_next_states_sim,
      num_samples=num_samples,
      min_val=min_val,
      max_val=max_val,
      bandwidth=bandwidth,
      seed=seed,
      device=device,
  )
  progress_fn = progress_fn or (lambda *args: None)
  algorithm = algorithm.strip().lower()

  if algorithm == 'ppo':
    from rsr_mjx_tpu_torch.train import networks as ppo_networks
    from rsr_mjx_tpu_torch.train import ppo

    make_inference_fn, params, _ = ppo.train(
        environment=env,
        past_data=past_data,
        num_timesteps=num_timesteps,
        num_evals=num_evals,
        num_eval_envs=num_eval_envs,
        reward_scaling=reward_scaling,
        episode_length=episode_length,
        normalize_observations=normalize_observations,
        action_repeat=action_repeat,
        unroll_length=unroll_length,
        num_minibatches=num_minibatches,
        num_updates_per_batch=num_updates_per_batch,
        discounting=discounting,
        learning_rate=learning_rate,
        entropy_cost=entropy_cost,
        num_envs=num_envs,
        batch_size=batch_size,
        restore_checkpoint_path=restore_checkpoint_path,
        policy_params_fn=policy_params_fn or (lambda *args: None),
        network_factory=network_factory or ppo_networks.make_ppo_networks,
        progress_fn=progress_fn,
        deterministic_eval=deterministic_eval,
        rsr_loss_scale=rsr_loss_scale,
        seed=seed,
        eval_env=eval_env,
        device=device,
    )
    return make_inference_fn, params

  if algorithm == 'sac':
    raise NotImplementedError('RSR policy training with SAC is not ported '
                              'yet: ROADMAP item 4 (SAC, with the RSR '
                              'penalty)')

  raise ValueError(
      f'unsupported algorithm {algorithm!r}; expected "ppo" or "sac"'
  )
