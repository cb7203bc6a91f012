"""What the per-layer metrics of the physics stages' device time share:
each reads the probe of ``benchmark/generators/rollout_getup.py``
(``context['trace']['stages']``: device ms per substep by the port's span
open at each kernel's launch), and gives None where there is no probe
(the CPU) or no such span (a port without it)."""


def read(out, span: str):
  stages = (out.context.get('trace') or {}).get('stages') or {}
  return stages.get(span)
