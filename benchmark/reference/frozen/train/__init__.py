"""PPO networks, normaliser and loss (frozen copy)."""
