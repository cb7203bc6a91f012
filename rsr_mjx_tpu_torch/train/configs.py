"""Tuned PPO and SAC configurations.

Counterpart of ``ppo_config`` and ``sac_config`` in
``rsr_mjx_tpu/train/configs.py``, as plain ``Config``s: the Airbot table
and the Go2 tables (a generic table with overrides for the joystick,
handstand / footstand and getup tasks), one for every Go2 task of the
JAX package.
"""

from __future__ import annotations

from rsr_mjx_tpu_torch.envs.config import Config

# the default episode_length of each Go2 task's env config (the JAX
# package's envs/go2/joystick.py, getup.py, handstand.py)
_GO2_EPISODE_LENGTH = {
    'Go2JoystickFlatTerrain': 1000,
    'Go2JoystickRoughTerrain': 1000,
    'Go2Getup': 300,
    'Go2Handstand': 500,
    'Go2Footstand': 500,
}


def ppo_config(env_name: str) -> Config:
  """The tuned PPO config of ``env_name``: for Airbot the reference's
  airbot_training/train.py:26-55 with max_grad_norm 1.0 as the JAX package
  sets it, for Go2 its locomotion_params.py:4-123."""
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
  if env_name not in _GO2_EPISODE_LENGTH:
    raise ValueError(f'Unsupported env: {env_name}')

  rl_config = Config(
      num_timesteps=100_000_000,
      num_evals=10,
      reward_scaling=1.0,
      episode_length=_GO2_EPISODE_LENGTH[env_name],
      normalize_observations=True,
      action_repeat=1,
      unroll_length=20,
      num_minibatches=32,
      num_updates_per_batch=4,
      discounting=0.97,
      learning_rate=3e-4,
      entropy_cost=1e-2,
      num_envs=8192,
      batch_size=256,
      max_grad_norm=1.0,
      network_factory=Config(
          policy_hidden_layer_sizes=(128, 128, 128, 128),
          value_hidden_layer_sizes=(256, 256, 256, 256, 256),
          policy_obs_key='state',
          value_obs_key='state',
      ),
  )
  # each Go2 task overrides the generic networks with an asymmetric
  # actor-critic: the value network on the privileged state
  asymmetric = Config(
      policy_hidden_layer_sizes=(512, 256, 128),
      value_hidden_layer_sizes=(512, 256, 128),
      policy_obs_key='state',
      value_obs_key='privileged_state',
  )
  if env_name in ('Go2JoystickFlatTerrain', 'Go2JoystickRoughTerrain'):
    rl_config.update(num_timesteps=200_000_000, num_evals=10,
                     network_factory=asymmetric)
  elif env_name in ('Go2Handstand', 'Go2Footstand'):
    rl_config.update(num_timesteps=100_000_000, num_evals=5,
                     network_factory=asymmetric)
  elif env_name == 'Go2Getup':
    rl_config.update(num_timesteps=50_000_000, num_evals=5,
                     network_factory=asymmetric)
  return rl_config


def sac_config(env_name: str) -> Config:
  """The tuned SAC config of ``env_name``: for Airbot the reference's
  airbot_training/train_sac.py:32-56 (reward scaling 0.1 keeps the
  Q-targets O(17) at γ 0.96), for Go2 its locomotion_params.py:125-180;
  a Go2 policy reads the ``policy_obs_key`` entry of the dict
  observation."""
  if env_name.startswith('Airbot'):
    return Config(
        num_timesteps=500_000,
        num_evals=10,
        reward_scaling=0.1,
        episode_length=1200,
        normalize_observations=True,
        action_repeat=1,
        discounting=0.96,
        learning_rate=1e-4,
        num_envs=1024,
        num_eval_envs=128,
        batch_size=256,
        tau=0.005,
        min_replay_size=100_000,
        max_replay_size=1_000_000,
        grad_updates_per_step=1,
        network_factory=Config(hidden_layer_sizes=(256, 256)),
    )
  if env_name not in _GO2_EPISODE_LENGTH:
    raise ValueError(f'Unsupported env: {env_name}')

  rl_config = Config(
      num_timesteps=5_000_000,
      num_evals=10,
      reward_scaling=1.0,
      episode_length=_GO2_EPISODE_LENGTH[env_name],
      normalize_observations=True,
      action_repeat=1,
      discounting=0.97,
      learning_rate=3e-4,
      num_envs=1024,
      num_eval_envs=128,
      batch_size=256,
      tau=0.005,
      min_replay_size=100_000,
      max_replay_size=1_000_000,
      grad_updates_per_step=1,
      policy_obs_key='state',
      network_factory=Config(hidden_layer_sizes=(256, 256)),
  )
  wide = Config(hidden_layer_sizes=(512, 256, 128))
  if env_name in ('Go2JoystickFlatTerrain', 'Go2JoystickRoughTerrain'):
    rl_config.update(num_timesteps=20_000_000, num_evals=10, num_envs=4096,
                     batch_size=512, min_replay_size=200_000,
                     network_factory=wide)
  elif env_name in ('Go2Handstand', 'Go2Footstand'):
    rl_config.update(num_timesteps=10_000_000, num_evals=5,
                     network_factory=wide)
  elif env_name == 'Go2Getup':
    rl_config.update(num_timesteps=5_000_000, num_evals=5,
                     network_factory=wide)
  return rl_config
