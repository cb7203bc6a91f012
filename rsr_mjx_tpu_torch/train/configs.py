"""Tuned PPO configurations.

Counterpart of ``ppo_config`` in ``rsr_mjx_tpu/train/configs.py``, as a
plain ``Config``.  Only the Airbot table is ported; the Go2 tables come
with the Go2 training slice and raise until then.
"""

from __future__ import annotations

from rsr_mjx_tpu_torch.envs.config import Config


def ppo_config(env_name: str) -> Config:
  """The tuned PPO config of ``env_name`` (the JAX Airbot table,
  airbot_training/train.py:26-55 of the reference, with max_grad_norm 1.0
  as the JAX package sets it)."""
  if env_name.startswith('Airbot'):
    return Config(
        num_timesteps=15_000_000,
        num_evals=30,
        reward_scaling=0.1,
        episode_length=1200,
        normalize_observations=True,
        action_repeat=1,
        unroll_length=10,
        num_minibatches=32,
        num_updates_per_batch=8,
        discounting=0.96,
        learning_rate=1e-4,
        entropy_cost=2e-2,
        num_envs=1024,
        batch_size=256,
        max_grad_norm=1.0,
        network_factory=Config(
            policy_hidden_layer_sizes=(32, 32, 32, 32),
            value_hidden_layer_sizes=(256, 256, 256, 256, 256),
        ),
    )
  raise ValueError(f'no tuned PPO config for {env_name!r} in the port yet: '
                   'the Go2 tables come with the Go2 training slice')
