"""K1, the batched SPD solve (``csrc/spd_solve.cu``): x = A⁻¹ b for B
systems of size n."""

NAMES = ('spd_solve_kernel', 'spd_solve_thread_kernel')


def work(shape: dict, B: int):
  """(bytes, FLOPs) of one call at the configuration's ``shape``."""
  n = shape['n']
  # x depends on the triangle A[a][b >= a] alone: n(n+1)/2 entries of A
  nbytes = 4 * (n * (n + 1) // 2 * B + 2 * n * B)
  # Cholesky n³/3 multiply-adds, two triangular solves n² each, n roots
  flops = B * (2 * n**3 / 3 + 2 * n * n + n)
  return nbytes, flops
