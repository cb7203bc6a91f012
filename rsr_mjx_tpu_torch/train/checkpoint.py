"""Checkpoints of (normalizer, networks), and the final parameters pickle.

Counterpart of ``rsr_mjx_tpu/train/checkpoint.py``, which writes Orbax
pytree checkpoints.  Here a checkpoint is a directory holding
``params.pt``: the normalizer state and the ``PPONetworks`` state dict as
CPU tensors (``torch.save``; ``restore`` reads it with
``weights_only=True``).  ``latest_checkpoint`` finds the newest
step-numbered directory as the JAX function does.  ``save_params`` writes
``final_params.pkl`` in the JAX trainer's layout, numpy arrays in
(RunningStatisticsState, {'policy': [...], 'value': [...]}), with the
normalizer under the JAX package's class path, so that the JAX
``sac.load_params`` reads it where torch is not installed;
``networks.load_ppo_params`` reads it back.  ``dump_numpy`` is that
pickler, which the SAC trainer's checkpoints use too.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import torch

from rsr_mjx_tpu_torch.train import networks as ppo_networks
from rsr_mjx_tpu_torch.train import running_statistics
from rsr_mjx_tpu_torch.train.running_statistics import RunningStatisticsState

_FILE = 'params.pt'
# where the JAX package keeps the normalizer state class
_JAX_STATS_CLASS = ('rsr_mjx_tpu.train.running_statistics',
                    'RunningStatisticsState')


def save(path: str, params) -> None:
  """Save ``params`` = (normalizer, PPONetworks) into the directory
  ``path`` (made if missing; an earlier checkpoint there is
  overwritten)."""
  normalizer, net = params
  cpu = running_statistics.to(normalizer, 'cpu')
  os.makedirs(path, exist_ok=True)
  torch.save({'normalizer': dataclasses.asdict(cpu),
              'params': {k: v.detach().cpu()
                         for k, v in net.state_dict().items()}},
             os.path.join(path, _FILE))


def restore(path: str, device='cuda'):
  """(normalizer, PPONetworks state dict) from the checkpoint directory
  ``path``, on ``device``."""
  blob = torch.load(os.path.join(path, _FILE), map_location=device,
                    weights_only=True)
  return RunningStatisticsState(**blob['normalizer']), blob['params']


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
  """The newest step-numbered checkpoint directory under ``ckpt_dir``."""
  if not os.path.isdir(ckpt_dir):
    return None
  candidates = [d for d in os.listdir(ckpt_dir) if d.isdigit()]
  if not candidates:
    return None
  return os.path.join(ckpt_dir, max(candidates, key=int))


class _JaxPathPickler(pickle._Pickler):
  """Names the normalizer class by the JAX package's path, which the JAX
  package imports without torch (the C pickler would check that the path
  imports to this class, so this is the pure-Python one)."""

  def save_global(self, obj, name=None):
    if obj is not RunningStatisticsState:
      return super().save_global(obj, name)
    for part in _JAX_STATS_CLASS:  # protocol 4, as save_params writes
      self.save(part)
    self.write(pickle.STACK_GLOBAL)
    self.memoize(obj)


def dump_numpy(path: str, tree) -> None:
  """Pickle ``tree`` (numpy arrays, dicts, lists and the normalizer state)
  with the normalizer under the JAX package's class path."""
  with open(path, 'wb') as f:
    _JaxPathPickler(f, protocol=4).dump(tree)


def save_params(path: str, params) -> None:
  """Pickle ``params`` = (normalizer, PPONetworks) as numpy in the JAX
  trainer's ``final_params.pkl`` layout."""
  dump_numpy(path, ppo_networks.ppo_params_to_numpy(*params))
