"""The PPO policy network for inference, and loading trained parameters.

Counterpart of the inference side of ``rsr_mjx_tpu/train/networks.py``:
an MLP with swish activations whose head gives the parameters of a
tanh-normal distribution, whose mode ``tanh(loc)`` is the deterministic
action.  ``load_ppo_params`` reads a ``final_params.pkl`` that the JAX
trainer wrote, and ``params_from_numpy`` carries its weights into the
port's ``nn.Module``.  Initialisation, sampling and losses come with the
training slice.
"""

from __future__ import annotations

import importlib
import pickle
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from rsr_mjx_tpu_torch.train.running_statistics import RunningStatisticsState


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


def tanh_normal_mode(logits: torch.Tensor) -> torch.Tensor:
  """Mode of the tanh-normal whose parameters are [loc | raw scale]."""
  loc, _ = torch.chunk(logits, 2, dim=-1)
  return torch.tanh(loc)


class PPOPolicy(nn.Module):
  """Deterministic PPO policy: normalize the observation, run the policy
  MLP (swish; jax.nn.swish is x·sigmoid(x), torch's silu), take the mode.
  Of a dict observation it reads the entry ``obs_key``."""

  def __init__(self, obs_size: int, action_size: int,
               hidden_layer_sizes: Sequence[int] = (32, 32, 32, 32),
               obs_key: str = 'state'):
    super().__init__()
    self.obs_key = obs_key
    self.register_buffer('obs_mean', torch.zeros(obs_size))
    self.register_buffer('obs_std', torch.ones(obs_size))
    self.mlp = MLP(obs_size, tuple(hidden_layer_sizes) + (2 * action_size,))

  def forward(self, obs) -> torch.Tensor:
    if isinstance(obs, dict):
      obs = obs[self.obs_key]
    return tanh_normal_mode(self.mlp((obs - self.obs_mean) / self.obs_std))


# ---------------------------------------------------------------------------
# Parameters written by the JAX trainer.
# ---------------------------------------------------------------------------

_STATS_CLASS = ('rsr_mjx_tpu.train.running_statistics',
                'RunningStatisticsState')
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
    if (module, name) == _STATS_CLASS:
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


def params_from_numpy(normalizer: RunningStatisticsState, policy,
                      obs_key: str = 'state') -> dict:
  """``PPOPolicy`` state dict from the JAX parameters: ``policy`` is the
  list of {'w': (in, out), 'b': (out,)} layers, the normalizer gives the
  observation mean and std (for a dict observation, dicts of which the
  policy reads entry ``obs_key``).  nn.Linear keeps its weight as
  (out, in)."""
  f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
  pick = lambda a: a[obs_key] if isinstance(a, dict) else a
  sd = {'obs_mean': f32(pick(normalizer.mean)),
        'obs_std': f32(pick(normalizer.std))}
  for i, layer in enumerate(policy):
    sd[f'mlp.layers.{i}.weight'] = f32(layer['w']).T.contiguous()
    sd[f'mlp.layers.{i}.bias'] = f32(layer['b'])
  return sd


def make_policy(normalizer: RunningStatisticsState, policy,
                device='cuda', obs_key: str = 'state') -> PPOPolicy:
  """A ``PPOPolicy`` on ``device`` holding the given JAX parameters; its
  sizes come from the weights."""
  sizes = [np.asarray(layer['w']).shape for layer in policy]
  net = PPOPolicy(sizes[0][0], sizes[-1][1] // 2,
                  [out for _, out in sizes[:-1]], obs_key=obs_key)
  net.load_state_dict(params_from_numpy(normalizer, policy, obs_key))
  return net.to(device).eval()
