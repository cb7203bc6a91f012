"""Host-clock span around ``ppo.minibatch_step``, synchronised on both
sides, averaged over the window's minibatches in the traced run, in ms."""


def read(ctx, out):
  spans = out.context.get('sgd_spans_s')
  return 1e3 * sum(spans) / len(spans) if spans else None
