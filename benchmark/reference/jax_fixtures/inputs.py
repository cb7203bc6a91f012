"""The inputs of the JAX-made fixtures beside this file, drawn with numpy
from a seed, so that the fixtures hold only what the JAX package computed
(and its own draws): the Go2 joystick's starting weights, the
normaliser's batch and the three minibatches of the SGD fixture.

``<config>.npz`` holds the JAX package's outputs on these inputs, and
under ``generator_source`` the script that made them; the tests in
``benchmark/tests/test_bench_jax_fixtures.py`` hold the frozen reference
to them.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 14
# the train cell's minibatch: 256 envs × 20 steps, the joystick's sizes
T, B, A = 20, 256, 12
OBS = {'state': 48, 'privileged_state': 123}
POLICY = (48, 512, 256, 128, 2 * A)
VALUE = (123, 512, 256, 128, 1)
NORMALIZER_ENVS = 512
SGD_STEPS = 3


def path(config: str) -> str:
  return os.path.join(HERE, f'{config}.npz')


def weights(rng):
  """{'policy': [(w (in, out), b)], 'value': [...]}: w uniform in
  ±√(3/fan_in) (JAX's lecun-uniform range), b small and not 0."""
  out = {}
  for name, sizes in (('policy', POLICY), ('value', VALUE)):
    layers = []
    for a, b in zip(sizes[:-1], sizes[1:]):
      s = np.sqrt(3.0 / a)
      layers.append((rng.uniform(-s, s, (a, b)).astype(np.float32),
                     (0.01 * rng.normal(size=b)).astype(np.float32)))
    out[name] = layers
  return out


def sgd_inputs(seed: int = SEED) -> dict:
  """The SGD fixture's inputs: ``weights``, ``normalizer_batch`` ({key:
  (T, NORMALIZER_ENVS, n)}) and ``minibatches``, each {'observation',
  'next_observation': {key: (B, T, n)}, 'raw_action': (B, T, A),
  'reward', 'discount', 'truncation', 'log_prob_offset': (B, T)}; the
  loss reads ``log_prob`` = the JAX policy's log-probability of the raw
  action plus the offset, which the fixture holds."""
  rng = np.random.default_rng(seed)
  w = weights(rng)
  scale = {k: rng.uniform(0.2, 3.0, n).astype(np.float32)
           for k, n in OBS.items()}
  shift = {k: rng.normal(size=n).astype(np.float32) for k, n in OBS.items()}

  def obs(*lead):
    return {k: (shift[k] + scale[k] * rng.normal(size=lead + (n,))
                ).astype(np.float32) for k, n in OBS.items()}

  batch = obs(T, NORMALIZER_ENVS)
  mbs = []
  for _ in range(SGD_STEPS):
    mbs.append({
        'observation': obs(B, T),
        'next_observation': obs(B, T),
        'raw_action': (0.5 * rng.normal(size=(B, T, A))).astype(np.float32),
        'reward': rng.normal(size=(B, T)).astype(np.float32),
        'discount': (rng.random((B, T)) > 0.02).astype(np.float32),
        'truncation': (rng.random((B, T)) < 0.01).astype(np.float32),
        'log_prob_offset': (0.3 * rng.normal(size=(B, T))).astype(np.float32),
    })
  return {'weights': w, 'normalizer_batch': batch, 'minibatches': mbs}


# the loss's arguments in the joystick table (ppo.train's defaults for
# the rest), and the optimiser's
LOSS_KWARGS = dict(entropy_cost=0.01, discounting=0.97, reward_scaling=1.0,
                   gae_lambda=0.95, clipping_epsilon=0.3,
                   normalize_advantage=True)
LEARNING_RATE = 3e-4
MAX_GRAD_NORM = 1.0
