"""PPO on one device: observation normalization, the policy and value
networks, the loss, rollouts and evaluation, the trainer, checkpoints, the
tuned configs and a command line (``python -m rsr_mjx_tpu_torch.train.cli``);
and loading trained parameters written by either package."""
