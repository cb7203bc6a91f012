"""Published peaks of one H100 SXM (NVIDIA data sheet, at the full 700 W
limit): device-memory bytes/s and float32 FLOP/s outside the tensor
cores.  A card set below 700 W reaches less; the harness prints the
card's power limit beside every share."""

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
  """The least time of a call: the larger of bytes over the memory peak
  and operations over the float32 peak."""
  return max(nbytes / HBM_BYTES_S, flops / FP32_FLOP_S)
