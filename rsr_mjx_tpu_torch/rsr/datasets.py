"""The six-file RSR dataset: loading and validation.

Counterpart of ``rsr_mjx_tpu/rsr/datasets.py``.  RSR policy training reads
six text tables:

  real_obs.txt         real-robot observation rows (N+1, obs_dim)
  real_action.txt      real-robot action rows       (N,   act_dim)
  past_sim_obs.txt     sim rollout under the PREVIOUS physics params
  current_sim_obs.txt  sim rollout under the CURRENT (tuned) params
  obs.txt              on-policy sim observations (width check only)
  actions.txt          on-policy sim actions      (width check only)

The checks, their order and their messages are the JAX package's:
existence, row counts of at least the transitions (+1 for observations),
equal feature widths.  The tables are read with numpy and returned as
float32 tensors on the requested device.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

REQUIRED_DATA_FILES = (
    'real_obs.txt',
    'real_action.txt',
    'past_sim_obs.txt',
    'current_sim_obs.txt',
    'obs.txt',
    'actions.txt',
)


def _require_data_file(data_dir: str, filename: str) -> str:
  path = os.path.join(data_dir, filename)
  if not os.path.isfile(path):
    raise FileNotFoundError(
        f'Required dataset file not found: {path}. '
        f'Expected files: {", ".join(REQUIRED_DATA_FILES)}'
    )
  return path


def _load_numeric_table(path: str) -> np.ndarray:
  data = np.loadtxt(path, delimiter=',')
  if data.ndim == 1:
    data = data.reshape(1, -1)
  if data.size == 0:
    raise ValueError(f'{os.path.basename(path)} is empty.')
  return data


def _load_transition_triplet(obs_path: str, action_path: str,
                             max_transitions: int):
  """(s_t, a_t, s_{t+1}) numpy rows with a shared transition count."""
  observations = _load_numeric_table(obs_path)
  actions = _load_numeric_table(action_path)
  transition_count = min(len(observations) - 1, len(actions), max_transitions)
  if transition_count <= 0:
    raise ValueError(
        f'Not enough aligned transitions in {os.path.basename(obs_path)} '
        f'and {os.path.basename(action_path)}. Need at least 2 '
        'observations and 1 action.'
    )
  return (observations[:transition_count], actions[:transition_count],
          observations[1:transition_count + 1])


def _validate_observation_sequence(path: str, transition_count: int):
  observations = _load_numeric_table(path)
  required = transition_count + 1
  if len(observations) < required:
    raise ValueError(
        f'{os.path.basename(path)} needs at least {required} rows for '
        f'{transition_count} transitions, found {len(observations)}.'
    )
  return observations


def _validate_action_sequence(path: str, transition_count: int):
  actions = _load_numeric_table(path)
  if len(actions) < transition_count:
    raise ValueError(
        f'{os.path.basename(path)} needs at least {transition_count} '
        f'rows, found {len(actions)}.'
    )
  return actions


def _validate_feature_width(arrays: Dict[str, np.ndarray],
                            expected_width: int, label: str) -> None:
  for name, array in arrays.items():
    if array.shape[1] != expected_width:
      raise ValueError(
          f'{name} must have {expected_width} {label} features, '
          f'found shape {array.shape}.'
      )


def load_rsr_datasets(data_dir: str, max_transitions: int = 50,
                      device='cuda') -> Tuple[torch.Tensor, ...]:
  """Load and validate the five arrays ``policy_params_training`` takes:
  (past states, past actions, real next states, previous-sim next states,
  current-sim next states), float32 on ``device``."""
  paths = {
      name: _require_data_file(data_dir, name)
      for name in REQUIRED_DATA_FILES
  }
  past_states, past_actions, past_next_states_real = (
      _load_transition_triplet(
          paths['real_obs.txt'], paths['real_action.txt'], max_transitions
      )
  )
  transition_count = int(past_states.shape[0])
  obs_dim = int(past_states.shape[1])
  action_dim = int(past_actions.shape[1])

  past_sim_obs = _validate_observation_sequence(
      paths['past_sim_obs.txt'], transition_count
  )
  current_sim_obs = _validate_observation_sequence(
      paths['current_sim_obs.txt'], transition_count
  )
  sim_obs = _validate_observation_sequence(paths['obs.txt'], transition_count)
  sim_actions = _validate_action_sequence(
      paths['actions.txt'], transition_count
  )

  _validate_feature_width(
      {
          'real_obs.txt': _load_numeric_table(paths['real_obs.txt']),
          'past_sim_obs.txt': past_sim_obs,
          'current_sim_obs.txt': current_sim_obs,
          'obs.txt': sim_obs,
      },
      obs_dim,
      'observation',
  )
  _validate_feature_width(
      {
          'real_action.txt': _load_numeric_table(paths['real_action.txt']),
          'actions.txt': sim_actions,
      },
      action_dim,
      'action',
  )

  arrays = (
      past_states,
      past_actions,
      past_next_states_real,
      past_sim_obs[1:transition_count + 1],
      current_sim_obs[1:transition_count + 1],
  )
  return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
               for a in arrays)


def txt_to_2d_array(path: str) -> np.ndarray:
  """Loose whitespace/comma text loader: one row per non-empty line."""
  rows = []
  with open(path) as f:
    for line in f:
      line = line.strip().replace(',', ' ')
      if not line:
        continue
      rows.append([float(tok) for tok in line.split()])
  return np.asarray(rows)
