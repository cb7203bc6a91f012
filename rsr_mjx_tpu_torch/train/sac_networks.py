"""SAC networks: the tanh-normal policy and the twin Q critics.

Counterpart of ``rsr_mjx_tpu/train/sac_networks.py``: a policy MLP whose
head gives the parameters of a ``NormalTanhDistribution`` (2·|A|) and
``n_critics`` Q MLPs on ``[obs, action]``, ReLU activations (the JAX
default), initialised as the JAX ``MLP.init`` (``lecun_uniform_``).
``sac_params_from_numpy`` / ``sac_params_to_numpy`` carry the weights in
the JAX layout ({'policy': [{'w': (in, out), 'b'}...], 'q': [[...] x
n_critics]}); ``make_policy`` serves a SAC ``final_params.pkl`` of either
package, (normalizer, policy layers) as ``sac.load_params`` reads it.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rsr_mjx_tpu_torch.train import networks as ppo_networks
from rsr_mjx_tpu_torch.train import running_statistics
from rsr_mjx_tpu_torch.train.networks import MLP, NormalTanhDistribution


class SACNetworks(nn.Module):
  """The policy MLP, the Q MLPs (``q``, an ``nn.ModuleList``) and the
  action distribution."""

  def __init__(self, policy: MLP, q: Sequence[MLP],
               distribution: NormalTanhDistribution, obs_size: int,
               action_size: int):
    super().__init__()
    self.policy = policy
    self.q = nn.ModuleList(q)
    self.distribution = distribution
    self.obs_size = obs_size
    self.action_size = action_size

  def init(self, generator: torch.Generator) -> 'SACNetworks':
    """Initialise as the JAX ``SACNetworks.init`` does (policy, then each
    critic); the draws are the generator's, not JAX's."""
    ppo_networks.lecun_uniform_(self.policy, generator)
    for q in self.q:
      ppo_networks.lecun_uniform_(q, generator)
    return self

  def policy_logits(self, obs: torch.Tensor) -> torch.Tensor:
    return self.policy(obs)

  def q_values(self, obs: torch.Tensor, action: torch.Tensor,
               q: Sequence[MLP] = None) -> torch.Tensor:
    """(..., n_critics) Q estimates of the critics ``q`` (this module's
    own by default; the trainer passes its target copy)."""
    x = torch.cat([obs, action], dim=-1)
    return torch.stack([torch.squeeze(m(x), dim=-1)
                        for m in (self.q if q is None else q)], dim=-1)


def make_sac_networks(obs_size: int, action_size: int,
                      hidden_layer_sizes: Sequence[int] = (256, 256),
                      activation=F.relu, n_critics: int = 2) -> SACNetworks:
  """The JAX ``make_sac_networks`` with its defaults, on the CPU; call
  ``init`` for the JAX initialisation and ``.to`` for the device."""
  dist = NormalTanhDistribution(event_size=action_size)
  hidden = tuple(hidden_layer_sizes)
  policy = MLP(obs_size, hidden + (dist.param_size(),), activation)
  q = [MLP(obs_size + action_size, hidden + (1,), activation)
       for _ in range(n_critics)]
  return SACNetworks(policy, q, dist, obs_size, action_size)


def sac_params_from_numpy(params: Mapping[str, Any], device='cuda') -> dict:
  """A ``SACNetworks`` state dict of float32 tensors on ``device`` from
  the JAX layout {'policy': [{'w': (in, out), 'b': (out,)}, ...], 'q':
  [[...], ...]}."""
  f32 = ppo_networks.to_tensor(device)
  sd = ppo_networks.layers_to_state_dict('policy.', params['policy'], f32)
  for j, q in enumerate(params['q']):
    sd.update(ppo_networks.layers_to_state_dict(f'q.{j}.', q, f32))
  return sd


def sac_params_to_numpy(networks) -> dict:
  """The inverse of ``sac_params_from_numpy``: the JAX layout of numpy
  float32 arrays from a ``SACNetworks`` or its state dict (or a part of
  one: a key missing gives an empty list)."""
  sd = networks.state_dict() if isinstance(networks, nn.Module) else networks
  n_critics = len({k.split('.')[1] for k in sd if k.startswith('q.')})
  return {'policy': ppo_networks.state_dict_to_layers('policy.', sd),
          'q': [ppo_networks.state_dict_to_layers(f'q.{j}.', sd)
                for j in range(n_critics)]}


def make_policy(normalizer, policy_params, device='cuda',
                deterministic: bool = True):
  """The policy obs → action of trained JAX-layout SAC parameters:
  ``normalizer`` (the state, numpy or tensors) and the policy layers
  [{'w': (in, out), 'b'}...].  Deterministic: the tanh of the mode of the
  logits on normalized observations; else ``act(obs, generator)`` draws
  the tanh-normal sample."""
  sizes = [np.shape(layer['w']) for layer in policy_params]
  dist = NormalTanhDistribution(event_size=sizes[-1][1] // 2)
  mlp = MLP(sizes[0][0], [out for _, out in sizes], F.relu)
  f32 = ppo_networks.to_tensor(device)
  mlp.load_state_dict(ppo_networks.layers_to_state_dict('', policy_params,
                                                        f32))
  mlp.to(device).eval()
  norm = running_statistics.map_state(
      lambda a: a.to(device) if isinstance(a, torch.Tensor) else f32(a),
      normalizer)

  def act(obs: torch.Tensor, generator: torch.Generator = None):
    logits = mlp(running_statistics.normalize(norm, obs))
    if deterministic:
      return dist.mode(logits)
    noise = ppo_networks.standard_normal(
        logits.shape[:-1] + (dist.event_size,), generator)
    return dist.postprocess(dist.sample_no_postprocess(logits, noise))

  return act
