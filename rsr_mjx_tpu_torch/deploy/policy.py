"""Trained parameters → the policy a robot's control loop calls.

Counterpart of ``rsr_mjx_tpu/deploy/policy.py``.  ``PolicyInference``
reads a PPO or SAC ``final_params.pkl`` of either package (or a directory
holding one), or a PPO checkpoint directory of the port
(``train/checkpoint.py``), and serves it on one device at batch 1.  The
network sizes come from the weights (``networks.networks_from_numpy``,
``sac_networks.make_policy``).  A JAX Orbax directory is refused with the
path of the ``final_params.pkl`` its trainer wrote beside it: Orbax is the
JAX package's.

``get_action`` keeps the data-collection contract: every raw action is
appended to the action log, one ``%.6f`` comma row per call, and the first
six dims scaled by ``action_scale`` (0.02) are returned; these logs are the
RSR workflow's inputs.  It runs on the card unless ``device='cpu'`` is
asked for.  One call uploads the observation and copies the action back:
no other synchronisation.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from rsr_mjx_tpu_torch.utils import tracing

# files of a JAX Orbax checkpoint directory
_ORBAX_FILES = ('_CHECKPOINT_METADATA', '_METADATA', 'manifest.ocdbt')
_FINAL = 'final_params.pkl'


def _is_orbax(path: str) -> bool:
  return any(os.path.exists(os.path.join(path, f)) for f in _ORBAX_FILES)


def _final_beside(path: str) -> Optional[str]:
  """The nearest ``final_params.pkl`` in ``path`` or a directory above
  it (the trainer writes it two levels above a step checkpoint)."""
  path = os.path.abspath(path)
  for _ in range(3):
    candidate = os.path.join(path, _FINAL)
    if os.path.isfile(candidate):
      return candidate
    path = os.path.dirname(path)
  return None


def load_numpy_params(ckpt_dir: str):
  """(normalizer, parameters) as numpy in the JAX layout from ``ckpt_dir``:
  a ``final_params.pkl`` (PPO: (normalizer, {'policy', 'value'}); SAC:
  (normalizer, policy layers)), a directory holding one, a port checkpoint
  directory (``params.pt``) or one of step-numbered port checkpoints."""
  from rsr_mjx_tpu_torch.train import checkpoint, sac
  from rsr_mjx_tpu_torch.train import networks as ppo_networks

  if os.path.isfile(ckpt_dir):
    return sac.load_params(ckpt_dir)
  if not os.path.isdir(ckpt_dir):
    raise FileNotFoundError(f'no checkpoint at {ckpt_dir}')
  if os.path.isfile(os.path.join(ckpt_dir, _FINAL)):
    return sac.load_params(os.path.join(ckpt_dir, _FINAL))
  step_dir = ckpt_dir
  if not os.path.isfile(os.path.join(ckpt_dir, checkpoint._FILE)):
    step_dir = checkpoint.latest_checkpoint(ckpt_dir) or ckpt_dir
  if os.path.isfile(os.path.join(step_dir, checkpoint._FILE)):
    normalizer, state_dict = checkpoint.restore(step_dir, device='cpu')
    return ppo_networks.ppo_params_to_numpy(normalizer, state_dict)
  if _is_orbax(step_dir):
    final = _final_beside(step_dir)
    raise ValueError(
        f'{ckpt_dir} is a JAX Orbax checkpoint, which the port does not '
        'read; pass the final_params.pkl its trainer wrote: '
        + (final or f'none found above {ckpt_dir}'))
  raise FileNotFoundError(f'no {_FINAL} or port checkpoint in {ckpt_dir}')


def _shapes(state_dict, prefix: str):
  return [tuple(v.shape) for k, v in state_dict.items()
          if k.startswith(prefix)]


def _check_sizes(expected: torch.nn.Module, loaded: torch.nn.Module,
                 prefixes) -> None:
  """Raise where the factory's networks and the weights' differ."""
  for prefix in prefixes:
    want = _shapes(expected.state_dict(), prefix)
    have = _shapes(loaded.state_dict(), prefix)
    if want != have:
      raise ValueError(f'network_factory gives {prefix}* shapes {want}; '
                       f'the checkpoint holds {have}')


class PolicyInference:
  """A trained policy served for hardware inference."""

  def __init__(
      self,
      ckpt_dir: str,
      env,
      algorithm: str = 'ppo',
      network_factory: Optional[Callable] = None,
      action_log_path: Optional[str] = 'real_action.txt',
      action_scale: float = 0.02,
      seed: int = 42,
      device='cuda',
  ):
    """``env`` gives the observation and action sizes a
    ``network_factory(obs_size, action_size)`` is called with; the
    factory's networks must match the weights' sizes (without one, the
    sizes are the weights')."""
    from rsr_mjx_tpu_torch.train import networks as ppo_networks
    from rsr_mjx_tpu_torch.train import running_statistics, sac_networks

    self.device = torch.device(device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError("no CUDA device: pass device='cpu' to serve on "
                         'the CPU')
    self._action_log_path = action_log_path
    self._action_scale = action_scale
    self.generator = torch.Generator(device=self.device).manual_seed(seed)
    normalizer, params = load_numpy_params(ckpt_dir)

    if algorithm == 'ppo':
      keys = ('state', 'state')
      if network_factory is not None:
        net = network_factory(env.observation_size, env.action_size)
        keys = (net.policy_obs_key, net.value_obs_key)
      weights = ppo_networks.networks_from_numpy(normalizer, params,
                                                 self.device, *keys)
      if network_factory is not None:
        _check_sizes(net, weights[1], ('policy.', 'value.'))
      make = ppo_networks.make_inference_fn(weights[1],
                                            running_statistics.normalize)
      by_key = isinstance(weights[0].mean, dict)

      def policy(deterministic):
        fn = make(weights, deterministic=deterministic)
        if by_key:
          return lambda obs, g: fn({keys[0]: obs}, g)[0]
        return lambda obs, g: fn(obs, g)[0]
    elif algorithm == 'sac':
      if network_factory is not None:
        net = network_factory(env.observation_size, env.action_size)
        loaded = sac_networks.make_sac_networks(
            np.shape(params[0]['w'])[0], np.shape(params[-1]['w'])[1] // 2,
            hidden_layer_sizes=[np.shape(p['w'])[1] for p in params[:-1]])
        _check_sizes(net, loaded, ('policy.',))

      def policy(deterministic):
        return sac_networks.make_policy(normalizer, params, self.device,
                                        deterministic=deterministic)
    else:
      raise ValueError(f'unknown algorithm {algorithm!r}')
    self._policies = {det: policy(det) for det in (True, False)}

  @tracing.span('deploy.get_action')
  @torch.no_grad()
  def get_action(self, observation, deterministic: bool = True) -> np.ndarray:
    """The policy's action for one observation, its first six dims scaled
    for the hardware; the raw action is appended to the action log.
    Deterministic: the distribution's mode; else a sample drawn from
    ``self.generator``.  Span ``deploy.get_action``."""
    obs = torch.from_numpy(np.asarray(observation, np.float32)).to(
        self.device)
    action = self._policies[deterministic](obs, self.generator)
    action = action.cpu().numpy()
    if self._action_log_path:
      with open(self._action_log_path, 'a') as f:
        np.savetxt(f, action.reshape(1, -1), fmt='%.6f', delimiter=',')
    return action[:6] * self._action_scale
