"""Seconds ``ppo.train`` spends before its first training step inside
the train window: the total of the port's span ``ppo.setup`` (networks,
restore, the env's reset, the evaluator's build)."""

from benchmark.metrics import _spans


def read(ctx, out):
  return _spans.read(ctx, 'ppo.setup', 'total_s')
