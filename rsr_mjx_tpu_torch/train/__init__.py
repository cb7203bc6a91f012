"""Policy inference: observation normalization, the PPO policy network and
loading trained parameters written by the JAX package."""
