"""The PPO policy in plain numpy: the observation normaliser, the MLP with
swish activations and the tanh-normal head's mode, from trained weights
in the JAX layout ([{'w': (in, out), 'b': (out,)}, ...]).

``precision`` is 'float64' (the reference), 'float32' or 'tf32' (float32
matmuls whose inputs are rounded to TF32, the precision control).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from benchmark import common


def load(path: str):
  """(normaliser, {'policy': layers, 'value': layers}) of a
  ``final_params.pkl``, as numpy; the unpickler admits numpy arrays and
  the normaliser's class only."""
  from benchmark.reference.frozen.train import networks

  return networks.load_ppo_params(path)


def _matmul(x, w, precision: str):
  if precision == 'float64':
    return np.asarray(x, np.float64) @ np.asarray(w, np.float64)
  if precision == 'tf32':
    return (common.tf32(x).astype(np.float32)
            @ common.tf32(w).astype(np.float32))
  return np.asarray(x, np.float32) @ np.asarray(w, np.float32)


def mlp(layers: Sequence[dict], x, precision: str = 'float64'):
  dtype = np.float64 if precision == 'float64' else np.float32
  x = np.asarray(x, dtype)
  for i, layer in enumerate(layers):
    x = _matmul(x, layer['w'], precision) + np.asarray(layer['b'], dtype)
    if i < len(layers) - 1:
      x = x / (1.0 + np.exp(-x))  # swish
  return x


def normalize(normalizer: Any, obs, key: str = 'state',
              precision: str = 'float64'):
  dtype = np.float64 if precision == 'float64' else np.float32
  mean, std = normalizer.mean, normalizer.std
  if isinstance(mean, dict):
    mean, std = mean[key], std[key]
  return (np.asarray(obs, dtype) - np.asarray(mean, dtype)) / np.asarray(
      std, dtype)


def mode(normalizer, params, obs, key: str = 'state',
         precision: str = 'float64'):
  """The deterministic action tanh(loc) of the policy at observations
  ``obs`` (N, obs size)."""
  logits = mlp(params['policy'], normalize(normalizer, obs, key, precision),
               precision)
  return np.tanh(logits[..., : logits.shape[-1] // 2])
