"""The readers of the port's spans on a made-up snapshot: each metric's
field of its span, and None on the CPU, for a span the program lacks and
for a program without the tracing module."""

import sys
import types

import pytest

from benchmark import common

SNAP = {
    'spans': {
        'physics.step': {'calls': 40, 'total_s': 3.0, 'self_s': 0.4,
                         'profiled': 8, 'median_ms': 71.5,
                         'median_self_ms': 9.5},
        'env.step': {'calls': 10, 'total_s': 3.2, 'self_s': 0.2,
                     'profiled': 2, 'median_ms': 300.0,
                     'median_self_ms': 18.25},
        'ppo.minibatch_step': {'calls': 128, 'total_s': 1.1, 'self_s': 1.1,
                               'profiled': 0, 'median_ms': 8.5,
                               'median_self_ms': 8.5},
        'ppo.setup': {'calls': 1, 'total_s': 2.75, 'self_s': 0.5,
                      'profiled': 0, 'median_ms': 2750.0,
                      'median_self_ms': 500.0},
    },
    'counters': {'physics.substeps': 40},
}
WANT = {
    'physics_host_ms_per_substep.rollout': 71.5,
    'physics_host_ms_per_substep.train': 71.5,
    'env_host_ms_per_step.rollout': 18.25,
    'env_host_ms_per_step.train': 18.25,
    'sgd_host_ms_per_minibatch.train': 8.5,
    'ppo_setup_s.train': 2.75,
}
CARD = types.SimpleNamespace(device='cuda')


def fake_port(monkeypatch, snap):
  """The port's tracing module replaced by one whose snapshot is
  ``snap``; None: a port without the module."""
  import rsr_mjx_tpu_torch.utils as utils

  fake = None if snap is None else types.SimpleNamespace(
      snapshot=lambda: snap)
  monkeypatch.setitem(sys.modules, 'rsr_mjx_tpu_torch.utils.tracing', fake)
  if fake is None:
    monkeypatch.delattr(utils, 'tracing', raising=False)
  else:
    monkeypatch.setattr(utils, 'tracing', fake, raising=False)


def test_every_span_metric_has_its_reader():
  spec = common.manifest()
  names = {m['name'] for m in spec['per_layer']
           if m['source'] == 'program_span'}
  assert names == set(WANT)


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_on_a_snapshot(name, monkeypatch):
  read = common.load_file('metrics', name).read
  fake_port(monkeypatch, SNAP)
  assert read(CARD, None) == WANT[name]
  assert read(types.SimpleNamespace(device='cpu'), None) is None


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_silent_without_the_span(name, monkeypatch):
  read = common.load_file('metrics', name).read
  fake_port(monkeypatch, {'spans': {'physics.step': dict(
      SNAP['spans']['physics.step'], median_ms=None)}, 'counters': {}})
  assert read(CARD, None) is None
  fake_port(monkeypatch, None)  # a port without the module
  assert read(CARD, None) is None
