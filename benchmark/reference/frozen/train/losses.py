"""PPO loss.

Counterpart of ``rsr_mjx_tpu/train/losses.py``: GAE by a reverse loop over
time with truncation masking, clipped surrogate + 0.25·value error +
entropy bonus; the RSR term, 0 without past data, is left out.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from benchmark.reference.frozen.envs.wrappers import tree_map
from benchmark.reference.frozen.train import running_statistics
from benchmark.reference.frozen.train.networks import PPONetworks


class Transition(NamedTuple):
  """Env transitions; leading dims [B, T] in the loss, [T, B] from a
  rollout."""

  observation: Any
  action: torch.Tensor  # postprocessed (tanh-squashed) action
  reward: torch.Tensor
  discount: torch.Tensor  # 1 - done
  next_observation: Any
  extras: Dict[str, Any]  # {'state_extras': {...}, 'policy_extras': {...}}


def compute_gae(truncation, termination, rewards, values, bootstrap_value,
                lambda_: float = 1.0, discount: float = 0.99):
  """Generalized advantage estimation over [T, B], as the JAX reverse
  scan; returns (vs, advantages), both detached."""
  with torch.no_grad():
    truncation_mask = 1 - truncation
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = rewards + discount * (1 - termination) * values_t_plus_1 - values
    deltas = deltas * truncation_mask
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = [None] * truncation_mask.shape[0]
    for t in reversed(range(truncation_mask.shape[0])):
      acc = deltas[t] + (discount * (1 - termination[t]) * truncation_mask[t]
                         * lambda_ * acc)
      vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    advantages = (rewards + discount * (1 - termination) * vs_t_plus_1
                  - values) * truncation_mask
  return vs, advantages


def compute_ppo_loss(
    networks: PPONetworks,
    normalizer_params: running_statistics.RunningStatisticsState,
    data: Transition,
    entropy_noise: torch.Tensor,
    past_data: Any = None,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    reward_scaling: float = 1.0,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.3,
    normalize_advantage: bool = True,
    rsr_loss_scale: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """PPO loss over a [B, T] transition batch, as the JAX function, of the
  weights ``networks`` holds.  ``entropy_noise`` is the standard-normal
  draw of the entropy estimate, time-major: (T, B, action size).  The
  metrics are detached."""
  dist = networks.distribution
  data = tree_map(lambda x: torch.swapaxes(x, 0, 1), data)  # time-major
  obs = running_statistics.normalize(normalizer_params, data.observation)
  policy_logits = networks.policy_logits(obs)
  baseline = networks.value_apply(obs)
  last = tree_map(lambda x: x[-1], data.next_observation)
  bootstrap_value = networks.value_apply(
      running_statistics.normalize(normalizer_params, last))

  rewards = data.reward * reward_scaling
  truncation = data.extras['state_extras']['truncation']
  termination = (1 - data.discount) * (1 - truncation)

  target_action_log_probs = dist.log_prob(
      policy_logits, data.extras['policy_extras']['raw_action'])
  behaviour_action_log_probs = data.extras['policy_extras']['log_prob']

  vs, advantages = compute_gae(
      truncation=truncation, termination=termination, rewards=rewards,
      values=baseline.detach(), bootstrap_value=bootstrap_value.detach(),
      lambda_=gae_lambda, discount=discounting)
  if normalize_advantage:
    # population std (ddof 0), as jnp.std
    advantages = (advantages - advantages.mean()) / (
        advantages.std(correction=0) + 1e-8)
  rho_s = torch.exp(target_action_log_probs - behaviour_action_log_probs)

  surrogate_loss1 = rho_s * advantages
  surrogate_loss2 = torch.clamp(rho_s, 1 - clipping_epsilon,
                                1 + clipping_epsilon) * advantages
  policy_loss = -torch.mean(torch.minimum(surrogate_loss1, surrogate_loss2))

  v_error = vs - baseline
  v_loss = torch.mean(v_error * v_error) * 0.5 * 0.5

  entropy = torch.mean(dist.entropy(policy_logits, entropy_noise))
  entropy_loss = entropy_cost * -entropy

  task_loss = policy_loss + v_loss + entropy_loss

  # the RSR term (the port's ``rsr.compute_rsr_loss``) is left out of
  # this copy: without past data, as the benchmark's cells train, it is 0
  if past_data is not None and rsr_loss_scale != 0.0:
    raise NotImplementedError('the frozen loss has no RSR term')
  sim2real_loss = torch.zeros((), dtype=task_loss.dtype,
                              device=task_loss.device)
  distribution_distance = sim2real_loss

  total_loss = task_loss + sim2real_loss
  metrics = {
      'total_loss': total_loss,
      'task_loss': task_loss,
      'policy_loss': policy_loss,
      'v_loss': v_loss,
      'entropy_loss': entropy_loss,
      'sim2real_loss': sim2real_loss,
      'rsr_distribution_distance': distribution_distance,
  }
  return total_loss, {k: v.detach() for k, v in metrics.items()}
