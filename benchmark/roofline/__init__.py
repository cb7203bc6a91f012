"""The yardstick of the kernels: the published peaks of one H100 and the
least work of each hand-written kernel, worked out from its inputs'
shapes (copied from ``chip_smoke.py``'s ``k1_work`` ... ``k4_work`` and
``bound_ms``), one file a kernel (``K1.py`` ...) with the names by which
its device time is found in a trace; and the networks' matmul FLOPs."""
