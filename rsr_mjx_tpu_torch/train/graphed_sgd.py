"""One PPO minibatch step replayed from a CUDA graph.

Launched op by op, a minibatch step (the PPO loss with its reverse GAE
loop, the backward pass, the global-norm clip, Adam) is a few hundred small
kernels, and the host takes longer to launch them than the card takes to
run them.  ``run(eager, networks, optimizer, normalizer, data, noise,
loss_kwargs, max_grad_norm)`` captures ``eager`` (``ppo._minibatch_step``)
into a CUDA graph and afterwards replays it: the normalizer, the minibatch
and the entropy draw are copied into the graph's static inputs (one
``_foreach_copy_``), the graph is launched, and the loss metrics are copied
out (one more).  The parameters, their gradients and Adam's state are read
and written at their addresses.

The step's Adam is ``ppo.adam_step_``, whose step count and bias
corrections live on the device: the eager step and its capture run the
same update.

When it replays.  ``eager_reason`` says why a step runs eagerly, or None:
a tensor is not on a card (``'device'``); a ``torch.distributed`` process
group is up, whose gradient mean all-reduces (``'distributed'``); the
caller is capturing a graph already (``'capturing'``).  Nothing else is
tested: no flag, no name.  The eager paths run ``eager`` as it is.

Cache.  One graph per key: the networks and the optimizer (both held
weakly: an entry dies with either), the optimizer's state dict (held, so a
``load_state_dict`` makes a new key), every input leaf's shape, dtype and
strides, the loss keyword values (objects such as ``past_data`` by
identity, and held), ``max_grad_norm``, each param group's lr, betas and
eps, and the device.  At most ``MAX_GRAPHS`` are kept, least recently used
first out, each with its own memory pool, freed with it.

Capture (``utils/cuda_graphs``' side stream, pools, capture and cache).
The first call of a key runs the eager step on a side stream: that is the
call's answer, and it makes Adam's state and every lazy library handle,
so nothing is allocated for it or built inside a capture.  The second
call captures the step on that stream, on static inputs, and replays the
graph once for its own answer: a capture runs nothing, so no update is
applied twice.  After every call each parameter's ``.grad``
holds the step's clipped gradient (after a replay, the graph's own
buffer, refilled by each replay); the returned metrics are copies that no
later replay changes.

Counters of ``utils.tracing``: ``ppo.sgd_graph_captures`` and
``ppo.sgd_graph_replays`` (each replayed step, the capturing call's
included).
"""

from __future__ import annotations

from typing import Optional

import torch

from rsr_mjx_tpu_torch.envs.wrappers import tree_map
from rsr_mjx_tpu_torch.train import distributed
from rsr_mjx_tpu_torch.utils import cuda_graphs
from rsr_mjx_tpu_torch.utils import tracing

# graphs kept, one per key
MAX_GRAPHS = 4

_COUNTERS = tracing.group('ppo')
for _k in ('sgd_graph_captures', 'sgd_graph_replays'):
  _COUNTERS.setdefault(_k, 0)

_CACHE = cuda_graphs.Cache()  # {key: _Entry}
_SCALARS = (bool, int, float, str, type(None))


# ---------------------------------------------------------------------------
# When a step replays


def _tensors(tree) -> list:
  """tree's tensors in ``tree_map``'s order."""
  out = []
  tree_map(out.append, tree)
  return out


def _on_card(t: torch.Tensor) -> bool:
  return t.is_cuda


def _capturing() -> bool:
  return torch.cuda.is_current_stream_capturing()


def eager_reason(networks, leaves) -> Optional[str]:
  """Why a step of ``networks`` on ``leaves`` (the tensors of the
  normalizer, the minibatch and the draw) runs eagerly ('device',
  'distributed', 'capturing'), or None where it replays a graph."""
  if not (_on_card(next(networks.parameters()))
          and all(_on_card(t) for t in leaves)):
    return 'device'
  if distributed.active():
    return 'distributed'
  if _capturing():
    return 'capturing'
  return None


def _key(networks, optimizer, leaves, loss_kwargs, max_grad_norm) -> tuple:
  layout = tuple((t.shape, t.dtype, t.stride()) for t in leaves)
  kwargs = tuple((k, v if isinstance(v, _SCALARS) else id(v))
                 for k, v in sorted(loss_kwargs.items()))
  hyper = tuple((g['lr'], tuple(g['betas']), g['eps'])
                for g in optimizer.param_groups)
  return (id(networks), id(optimizer), id(optimizer.state), layout, kwargs,
          max_grad_norm, hyper, leaves[0].device)


# ---------------------------------------------------------------------------
# The graphs


class _Graph:
  """One captured step: the graph, its static inputs, the metrics' names
  and buffers, and the parameters with their gradient buffers."""

  __slots__ = ('graph', 'device', 'inputs', 'names', 'metrics', 'params',
               'grads')

  def __init__(self, graph, device, inputs, names, metrics, params, grads):
    self.graph, self.device, self.inputs = graph, device, inputs
    self.names, self.metrics = names, metrics
    self.params, self.grads = params, grads

  def run(self, leaves) -> dict:
    torch._foreach_copy_(self.inputs, leaves)
    with torch.cuda.device(self.device):
      self.graph.replay()
    outs = [torch.empty_like(m) for m in self.metrics]
    torch._foreach_copy_(outs, self.metrics)
    for p, g in zip(self.params, self.grads):
      p.grad = g
    tracing.count('ppo.sgd_graph_replays')
    return dict(zip(self.names, outs))


class _Entry:
  """A key's weak references to its networks and optimizer, the objects
  its key names by identity (held), and its graph once captured."""

  __slots__ = ('networks', 'optimizer', 'held', 'graph')

  def __init__(self, held):
    self.networks = self.optimizer = None  # weak (``Cache.add``)
    self.held = held
    self.graph: Optional[_Graph] = None


def _device_index(t: torch.Tensor) -> int:
  return t.device.index if t.is_cuda else -1


def _capture_graph(eager, networks, optimizer, inputs, leaves, loss_kwargs,
                   max_grad_norm) -> _Graph:
  """The step captured on static copies of ``leaves`` (``inputs`` their
  tree: normalizer, minibatch, draw)."""
  dev = _device_index(leaves[0])
  static = [torch.empty_like(t) for t in leaves]
  it = iter(static)
  args = tree_map(lambda _: next(it), inputs)
  params = [p for p in networks.parameters() if p.grad is not None]
  names = []

  def step():
    metrics = eager(networks, optimizer, *args, loss_kwargs, max_grad_norm)
    names[:] = metrics
    return list(metrics.values()) + [p.grad for p in params]

  with torch.cuda.device(dev):
    graph, out = cuda_graphs.capture(
        step, cuda_graphs.new_pool(),
        cuda_graphs.side_stream(leaves[0].device))
  n = len(names)
  tracing.count('ppo.sgd_graph_captures')
  return _Graph(graph, dev, static, names, out[:n], params, out[n:])


def run(eager, networks, optimizer, normalizer_params, data, entropy_noise,
        loss_kwargs, max_grad_norm) -> dict:
  """``eager(networks, optimizer, normalizer_params, data, entropy_noise,
  loss_kwargs, max_grad_norm)``, replayed from a CUDA graph where
  ``eager_reason`` allows it."""
  args = (networks, optimizer, normalizer_params, data, entropy_noise,
          loss_kwargs, max_grad_norm)
  inputs = (normalizer_params, data, entropy_noise)
  leaves = _tensors(inputs)
  if eager_reason(networks, leaves):
    return eager(*args)
  key = _key(networks, optimizer, leaves, loss_kwargs, max_grad_norm)
  entry = _CACHE.get(key)
  if entry is None or entry.networks() is not networks:
    entry = _Entry([optimizer.state] + [v for v in loss_kwargs.values()
                                        if not isinstance(v, _SCALARS)])
    entry.networks, entry.optimizer = _CACHE.add(
        key, entry, (networks, optimizer), MAX_GRAPHS)
    with torch.cuda.device(_device_index(leaves[0])):
      return cuda_graphs.on_stream(
          cuda_graphs.side_stream(leaves[0].device), lambda: eager(*args))
  _CACHE.move_to_end(key)
  if entry.graph is None:
    entry.graph = _capture_graph(eager, networks, optimizer, inputs, leaves,
                                 loss_kwargs, max_grad_norm)
  return entry.graph.run(leaves)


def clear() -> None:
  """Drops every graph and its pool."""
  _CACHE.clear()
