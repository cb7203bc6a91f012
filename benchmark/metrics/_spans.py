"""What the per-layer metrics of the port's own spans share: each reads
``rsr_mjx_tpu_torch.utils.tracing.snapshot()`` in the run's process after
a run on the card, and gives None where the port has no such module or
span, where the span's field is None (a median with no call outside the
profiler), or on the CPU, where a span times the computation itself and
not the host's issuing of the card's work."""


def read(ctx, span: str, field: str):
  """Field ``field`` of span ``span`` in the port's snapshot, or None."""
  if ctx.device == 'cpu':
    return None
  try:
    from rsr_mjx_tpu_torch.utils import tracing
  except ImportError:
    return None
  s = tracing.snapshot()['spans'].get(span)
  return None if s is None else s[field]
