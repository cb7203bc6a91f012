"""Policy and value networks, the tanh-normal distribution, and trained
parameters carried between the two packages.

Counterpart of ``rsr_mjx_tpu/train/networks.py``: MLPs with swish
activations (``F.silu``) initialised as the JAX ``MLP.init`` (LeCun
uniform weights, zero biases), the policy head giving the parameters of a
tanh-normal distribution whose mode ``tanh(loc)`` is the deterministic
action, and ``PPONetworks`` with policy and value observation keys for
dict observations.  Every function that draws takes its standard-normal
draw as a tensor (``standard_normal`` draws one from a generator), so a
caller can hand over another source's draws.

``load_ppo_params`` reads a PPO ``final_params.pkl`` of either package;
``ppo_params_from_numpy`` / ``ppo_params_to_numpy`` carry both networks
and the whole normalizer state into and out of ``PPONetworks``, and
``make_policy`` serves such parameters as the deterministic policy that
``make_inference_fn`` gives.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import pickle
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rsr_mjx_tpu_torch.envs import core
from rsr_mjx_tpu_torch.train import running_statistics
from rsr_mjx_tpu_torch.train.running_statistics import RunningStatisticsState
from rsr_mjx_tpu_torch.utils import tracing


class MLP(nn.Module):
  """Hidden layers with an activation, then a linear head."""

  def __init__(self, in_size: int, layer_sizes: Sequence[int],
               activation=F.silu, activate_final: bool = False):
    super().__init__()
    sizes = (in_size,) + tuple(layer_sizes)
    self.layers = nn.ModuleList(
        nn.Linear(sizes[i], sizes[i + 1]) for i in range(len(layer_sizes))
    )
    self.activation = activation
    self.activate_final = activate_final

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    n = len(self.layers)
    for i, layer in enumerate(self.layers):
      x = layer(x)
      if i < n - 1 or self.activate_final:
        x = self.activation(x)
    return x


# ---------------------------------------------------------------------------
# Training side: initialisation, the distribution, PPONetworks.
# ---------------------------------------------------------------------------


def lecun_uniform_(mlp: MLP, generator: torch.Generator) -> MLP:
  """Initialise ``mlp`` in place as the JAX ``MLP.init``: each weight
  U(−√(3/fan_in), √(3/fan_in)), each bias 0 (``nn.Linear``'s own init
  differs).  Draws layer by layer on the generator's device."""
  with torch.no_grad():
    for layer in mlp.layers:
      scale = math.sqrt(3.0 / layer.in_features)
      u = torch.rand(layer.weight.shape, generator=generator,
                     device=generator.device)
      layer.weight.copy_(u * (2 * scale) - scale)
      layer.bias.zero_()
  return mlp


def standard_normal(shape, generator: torch.Generator) -> torch.Tensor:
  """A float32 standard-normal draw of ``shape`` on the generator's
  device (a ``core.RowStream``'s rows of a draw for the whole batch)."""
  return core.randn(generator, shape)


@dataclasses.dataclass(frozen=True)
class NormalTanhDistribution:
  """Normal with softplus std, squashed by tanh (the JAX class's
  arithmetic).  ``logits`` are [loc | raw scale]; ``noise`` is a standard
  normal draw shaped like loc."""

  event_size: int
  min_std: float = 0.001
  var_scale: float = 1.0

  def param_size(self) -> int:
    return 2 * self.event_size

  def _loc_scale(self, logits: torch.Tensor):
    loc, raw = torch.chunk(logits, 2, dim=-1)
    return loc, (F.softplus(raw) + self.min_std) * self.var_scale

  def sample_no_postprocess(self, logits, noise):
    loc, scale = self._loc_scale(logits)
    return loc + scale * noise

  def mode(self, logits):
    return torch.tanh(self._loc_scale(logits)[0])

  @staticmethod
  def _log_det_jacobian(raw):
    """log |d tanh(x) / dx| = 2 (log 2 − x − softplus(−2x))."""
    return 2.0 * (math.log(2.0) - raw - F.softplus(-2.0 * raw))

  def log_prob(self, logits, raw_actions):
    """log p of pre-tanh actions, with the tanh change of variables."""
    loc, scale = self._loc_scale(logits)
    log_unnormalized = -0.5 * torch.square(raw_actions / scale - loc / scale)
    log_normalization = 0.5 * math.log(2.0 * math.pi) + torch.log(scale)
    return torch.sum(log_unnormalized - log_normalization
                     - self._log_det_jacobian(raw_actions), dim=-1)

  def postprocess(self, raw_actions):
    return torch.tanh(raw_actions)

  def entropy(self, logits, noise):
    """Entropy estimate with the tanh Jacobian at the sample
    loc + scale·noise (brax semantics)."""
    loc, scale = self._loc_scale(logits)
    entropy = 0.5 + 0.5 * math.log(2.0 * math.pi) + torch.log(scale)
    raw = loc + scale * noise
    return torch.sum(entropy + self._log_det_jacobian(raw), dim=-1)


class PPONetworks(nn.Module):
  """Policy and value MLPs and the action distribution.  Of a dict
  observation the policy reads entry ``policy_obs_key`` and the value
  ``value_obs_key`` (the asymmetric actor-critic of the Go2 configs)."""

  def __init__(self, policy: MLP, value: MLP,
               distribution: NormalTanhDistribution, obs_size: Any,
               action_size: int, policy_obs_key: str = 'state',
               value_obs_key: str = 'state'):
    super().__init__()
    self.policy = policy
    self.value = value
    self.distribution = distribution
    self.obs_size = obs_size
    self.action_size = action_size
    self.policy_obs_key = policy_obs_key
    self.value_obs_key = value_obs_key

  def init(self, generator: torch.Generator) -> 'PPONetworks':
    """Initialise as the JAX ``PPONetworks.init`` does (policy, then
    value); the draws are the generator's, not JAX's."""
    lecun_uniform_(self.policy, generator)
    lecun_uniform_(self.value, generator)
    return self

  def policy_logits(self, obs):
    if isinstance(obs, dict):
      obs = obs[self.policy_obs_key]
    return self.policy(obs)

  def value_apply(self, obs):
    if isinstance(obs, dict):
      obs = obs[self.value_obs_key]
    return torch.squeeze(self.value(obs), dim=-1)


def _obs_width(obs_size, key):
  size = obs_size[key] if isinstance(obs_size, Mapping) else obs_size
  return size[-1] if isinstance(size, (tuple, list)) else size


def make_ppo_networks(
    obs_size, action_size: int,
    policy_hidden_layer_sizes: Sequence[int] = (32, 32, 32, 32),
    value_hidden_layer_sizes: Sequence[int] = (256, 256, 256, 256, 256),
    activation: Callable = F.silu, policy_obs_key: str = 'state',
    value_obs_key: str = 'state') -> PPONetworks:
  """The JAX ``make_ppo_networks`` with its defaults, on the CPU; call
  ``init`` for the JAX initialisation and ``.to`` for the device."""
  dist = NormalTanhDistribution(event_size=action_size)
  policy = MLP(_obs_width(obs_size, policy_obs_key),
               tuple(policy_hidden_layer_sizes) + (dist.param_size(),),
               activation)
  value = MLP(_obs_width(obs_size, value_obs_key),
              tuple(value_hidden_layer_sizes) + (1,), activation)
  return PPONetworks(policy, value, dist, obs_size, action_size,
                     policy_obs_key, value_obs_key)


def make_inference_fn(networks: PPONetworks, normalizer=None):
  """make_policy(params, deterministic) → policy(obs, generator) →
  (action, extras), as the JAX function.  ``params`` is (normalizer state,
  a ``PPONetworks`` holding the weights); ``normalizer`` is a function
  (state, obs) → obs such as ``running_statistics.normalize``, or None.
  The stochastic policy draws its noise from ``generator`` and returns the
  pre-tanh action and its log-probability in ``extras``."""
  dist = networks.distribution

  def make_policy(params, deterministic: bool = False):
    normalizer_params, net = params

    def policy(obs, generator: torch.Generator):
      if normalizer is not None:
        obs = normalizer(normalizer_params, obs)
      logits = net.policy_logits(obs)
      if deterministic:
        return dist.mode(logits), {}
      noise = standard_normal(logits.shape[:-1] + (dist.event_size,),
                              generator).to(logits.device)
      raw = dist.sample_no_postprocess(logits, noise)
      return dist.postprocess(raw), {
          'log_prob': dist.log_prob(logits, raw), 'raw_action': raw}

    return policy

  return make_policy


def to_tensor(device):
  """numpy (or array-like) → float32 tensor on ``device``."""
  return lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
  return t.detach().cpu().numpy().astype(np.float32)


def layers_to_state_dict(prefix: str, layers, to_tensor_fn) -> dict:
  """The state dict entries of an ``MLP`` (its keys after ``prefix``, such
  as 'policy.') from JAX-layout layers [{'w': (in, out), 'b': (out,)},
  ...]; ``nn.Linear`` keeps its weight as (out, in)."""
  sd = {}
  for i, layer in enumerate(layers):
    sd[f'{prefix}layers.{i}.weight'] = to_tensor_fn(layer['w']).T.contiguous()
    sd[f'{prefix}layers.{i}.bias'] = to_tensor_fn(layer['b'])
  return sd


def state_dict_to_layers(prefix: str, sd) -> list:
  """The inverse of ``layers_to_state_dict``: numpy float32 layers."""
  n = sum(1 for k in sd if k.startswith(f'{prefix}layers.')
          and k.endswith('.weight'))
  return [{'w': to_numpy(sd[f'{prefix}layers.{i}.weight']).T.copy(),
           'b': to_numpy(sd[f'{prefix}layers.{i}.bias'])} for i in range(n)]


def ppo_params_from_numpy(normalizer: RunningStatisticsState,
                          params: Mapping[str, Any], device='cuda'):
  """(normalizer of float32 tensors on ``device``, ``PPONetworks`` state
  dict) from the JAX layout: {'policy': [{'w': (in, out), 'b': (out,)},
  ...], 'value': [...]} and the whole normalizer state."""
  f32 = to_tensor(device)
  sd = {}
  for net in ('policy', 'value'):
    sd.update(layers_to_state_dict(f'{net}.', params[net], f32))
  return running_statistics.map_state(f32, normalizer), sd


def ppo_params_to_numpy(normalizer: RunningStatisticsState, networks):
  """The inverse of ``ppo_params_from_numpy``: (normalizer of numpy
  float32 arrays, {'policy': [{'w', 'b'}, ...], 'value': [...]}) from the
  normalizer and a ``PPONetworks`` or its state dict."""
  sd = networks.state_dict() if isinstance(networks, nn.Module) else networks
  return (running_statistics.map_state(to_numpy, normalizer),
          {net: state_dict_to_layers(f'{net}.', sd)
           for net in ('policy', 'value')})


# ---------------------------------------------------------------------------
# Parameters written by a trainer, pickled.
# ---------------------------------------------------------------------------

# the normalizer class as the JAX trainer and the port's pickle it
_STATS_CLASSES = {
    ('rsr_mjx_tpu.train.running_statistics', 'RunningStatisticsState'),
    ('rsr_mjx_tpu_torch.train.running_statistics', 'RunningStatisticsState'),
}
# numpy's array reconstruction, under numpy 2's module names and numpy 1's
_NUMPY = {
    ('numpy', 'ndarray'), ('numpy', 'dtype'),
    ('numpy._core.multiarray', '_reconstruct'),
    ('numpy._core.multiarray', 'scalar'),
    ('numpy.core.multiarray', '_reconstruct'),
    ('numpy.core.multiarray', 'scalar'),
}


class _ParamsUnpickler(pickle.Unpickler):
  """Admits numpy array reconstruction and the normalizer state class
  (mapped to the port's own); refuses every other global."""

  def find_class(self, module, name):
    if (module, name) in _STATS_CLASSES:
      return RunningStatisticsState
    if (module, name) in _NUMPY:
      try:
        mod = importlib.import_module(module)
      except ImportError:  # the pickle's numpy major differs from ours
        other = ('numpy.core' if module.startswith('numpy._core')
                 else 'numpy._core')
        mod = importlib.import_module(other + '.multiarray')
      return getattr(mod, name)
    raise pickle.UnpicklingError(f'refusing to load global {module}.{name}')


def load_ppo_params(path: str):
  """(normalizer RunningStatisticsState, {'policy': [...], 'value': [...]})
  of numpy arrays, from a PPO ``final_params.pkl``."""
  with open(path, 'rb') as f:
    normalizer, net = _ParamsUnpickler(f).load()
  return normalizer, net


def networks_from_numpy(normalizer: RunningStatisticsState,
                        params: Mapping[str, Any], device='cuda',
                        policy_obs_key: str = 'state',
                        value_obs_key: str = 'state'):
  """(normalizer, ``PPONetworks``) on ``device`` holding JAX-layout
  parameters (as ``load_ppo_params`` gives them); the layer sizes come
  from the weights, the observation keys from the caller."""
  sizes = {net: [np.shape(layer['w']) for layer in params[net]]
           for net in ('policy', 'value')}
  obs_size = {value_obs_key: sizes['value'][0][0],
              policy_obs_key: sizes['policy'][0][0]}
  if len(obs_size) == 1:
    obs_size = obs_size[policy_obs_key]
  net = make_ppo_networks(
      obs_size, sizes['policy'][-1][1] // 2,
      policy_hidden_layer_sizes=[out for _, out in sizes['policy'][:-1]],
      value_hidden_layer_sizes=[out for _, out in sizes['value'][:-1]],
      policy_obs_key=policy_obs_key, value_obs_key=value_obs_key)
  normalizer, sd = ppo_params_from_numpy(normalizer, params, device)
  net.load_state_dict(sd)
  return normalizer, net.to(device).eval()


def make_policy(normalizer: RunningStatisticsState, params, device='cuda',
                obs_key: str = 'state', value_obs_key: str = 'state'):
  """The deterministic policy obs → action of trained JAX-layout
  parameters: the normalizer, ``PPONetworks.policy_logits`` on entry
  ``obs_key`` of a dict observation, the distribution's mode
  (``make_inference_fn(..., deterministic=True)``).  Where the normalizer
  is over a dict observation, the policy also takes that entry alone.
  Each call is the span ``policy.act``."""
  weights = networks_from_numpy(normalizer, params, device, obs_key,
                                value_obs_key)
  policy = make_inference_fn(weights[1], running_statistics.normalize)(
      weights, deterministic=True)
  by_key = isinstance(weights[0].mean, dict)

  @tracing.span('policy.act')
  def act(obs):
    if by_key and not isinstance(obs, dict):
      obs = {obs_key: obs}
    return policy(obs, None)[0]

  return act
