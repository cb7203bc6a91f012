"""The reader of ``sgd_graph_share.train`` on made-up snapshots: replays
over the minibatch span's calls, and None on the CPU, without the counter
or the span, and for a port without the tracing module."""

import sys
import types

import pytest

from benchmark import common

CARD = types.SimpleNamespace(device='cuda')
SPAN = {'calls': 640, 'total_s': 0.5, 'self_s': 0.5, 'profiled': 8,
        'median_ms': 0.4, 'median_self_ms': 0.4}


def _read(monkeypatch, snap, ctx=CARD):
  import rsr_mjx_tpu_torch.utils as utils

  fake = None if snap is None else types.SimpleNamespace(
      snapshot=lambda: snap)
  monkeypatch.setitem(sys.modules, 'rsr_mjx_tpu_torch.utils.tracing', fake)
  if fake is None:
    monkeypatch.delattr(utils, 'tracing', raising=False)
  else:
    monkeypatch.setattr(utils, 'tracing', fake, raising=False)
  return common.load_file('metrics', 'sgd_graph_share.train').read(ctx, None)


def test_share_of_replays(monkeypatch):
  snap = {'spans': {'ppo.minibatch_step': SPAN},
          'counters': {'ppo.sgd_graph_replays': 639}}
  assert _read(monkeypatch, snap) == pytest.approx(100.0 * 639 / 640)
  assert _read(monkeypatch, snap, types.SimpleNamespace(device='cpu')) is None


@pytest.mark.parametrize('snap', [
    {'spans': {'ppo.minibatch_step': SPAN}, 'counters': {}},
    {'spans': {}, 'counters': {'ppo.sgd_graph_replays': 3}},
    None])
def test_silent_without_what_it_reads(snap, monkeypatch):
  assert _read(monkeypatch, snap) is None
