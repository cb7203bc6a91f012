"""SAC losses with the RSR penalty on the actor objective.

Counterpart of ``rsr_mjx_tpu/train/sac_losses.py``: the temperature loss
against the target entropy −0.5·|A|, the twin-Q Bellman loss with
truncation masking, and the actor loss α·log π − min Q plus the RSR term
(``rsr.compute_rsr_loss``) on the raw observations and the freshly
sampled, postprocessed action (the PPO loss takes the mode instead).
Each loss takes its standard-normal draw as ``noise`` (shaped like the
action batch), so a caller can hand over another source's draws.  A loss
is a function of the modules that hold the parameters; the caller takes
the gradient with respect to the parameters the JAX loss is
differentiated by (``sac.sgd_step``): the stop-gradients of the JAX
losses are ``torch.no_grad`` here.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from rsr_mjx_tpu_torch.rsr import loss as rsr
from rsr_mjx_tpu_torch.train.sac_networks import SACNetworks


def make_losses(networks: SACNetworks, reward_scaling: float,
                discounting: float, action_size: int,
                normalize_fn: Optional[Callable] = None,
                past_data: Any = None, rsr_loss_scale: float = 1.0):
  """(alpha_loss, critic_loss, actor_loss), as the JAX ``make_losses``;
  ``normalize_fn`` is (normalizer state, obs) → obs, or None for none.

  - ``alpha_loss(log_alpha, normalizer_params, transitions, noise)``:
    differentiate by ``log_alpha``;
  - ``critic_loss(normalizer_params, target_q, alpha, transitions,
    noise)``: by ``networks.q``; ``target_q`` are the target critics;
  - ``actor_loss(normalizer_params, alpha, transitions, noise)``: by
    ``networks.policy``.
  """
  target_entropy = -0.5 * action_size
  dist = networks.distribution
  normalize = normalize_fn or (lambda state, obs: obs)

  def sample(logits, noise):
    raw = dist.sample_no_postprocess(logits, noise)
    return raw, dist.log_prob(logits, raw)

  def alpha_loss(log_alpha, normalizer_params, transitions, noise):
    """Temperature loss (SAC eq. 18)."""
    with torch.no_grad():
      obs = normalize(normalizer_params, transitions.observation)
      _, log_prob = sample(networks.policy_logits(obs), noise)
      target = -log_prob - target_entropy
    return torch.mean(torch.exp(log_alpha) * target)

  def critic_loss(normalizer_params, target_q, alpha, transitions, noise):
    """Twin-Q Bellman loss; the target is held fixed."""
    obs = normalize(normalizer_params, transitions.observation)
    with torch.no_grad():
      nobs = normalize(normalizer_params, transitions.next_observation)
      next_raw, next_log_prob = sample(networks.policy_logits(nobs), noise)
      next_q = networks.q_values(nobs, dist.postprocess(next_raw), target_q)
      next_value = torch.amin(next_q, dim=-1) - alpha * next_log_prob
      target_q_value = (transitions.reward * reward_scaling
                        + transitions.discount * discounting * next_value)
    q_error = networks.q_values(obs, transitions.action) - target_q_value[
        ..., None]
    truncation = transitions.extras['state_extras']['truncation']
    q_error = q_error * (1 - truncation)[..., None]
    return 0.5 * torch.mean(torch.square(q_error))

  def actor_loss(normalizer_params, alpha, transitions, noise):
    """α·log π − min Q, plus the RSR penalty."""
    obs = normalize(normalizer_params, transitions.observation)
    raw, log_prob = sample(networks.policy_logits(obs), noise)
    action = dist.postprocess(raw)
    q_action = networks.q_values(obs, action)
    base = torch.mean(alpha * log_prob - torch.amin(q_action, dim=-1))
    sim2real_loss, _ = rsr.compute_rsr_loss(
        transitions.observation, action, transitions.next_observation,
        past_data, loss_scale=rsr_loss_scale)
    return base + sim2real_loss

  return alpha_loss, critic_loss, actor_loss
