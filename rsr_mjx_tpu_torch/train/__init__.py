"""PPO and SAC on one device: observation normalization, the policy, value
and twin-critic networks, the losses, rollouts and evaluation, the replay
ring, the trainers, checkpoints, the tuned configs and a command line
(``python -m rsr_mjx_tpu_torch.train.cli``); and loading trained
parameters written by either package."""
