"""Share of the SGD minibatch steps replayed from a CUDA graph, in %: the
port's counter ``ppo.sgd_graph_replays`` over the calls of its span
``ppo.minibatch_step``, read from ``rsr_mjx_tpu_torch.utils.tracing
.snapshot()`` after a run on the card.  None on the CPU, where no step
replays, and where the port has no such counter or span."""


def read(ctx, out):
  if ctx.device == 'cpu':
    return None
  try:
    from rsr_mjx_tpu_torch.utils import tracing
  except ImportError:
    return None
  snap = tracing.snapshot()
  replays = snap['counters'].get('ppo.sgd_graph_replays')
  span = snap['spans'].get('ppo.minibatch_step')
  if replays is None or not span or not span['calls']:
    return None
  return 100.0 * replays / span['calls']
