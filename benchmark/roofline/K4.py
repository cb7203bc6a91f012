"""K4, the generic-row Newton solve (``csrc/newton_generic.cu``) at its
fixed schedule of ``iters`` Newton and ``ls_iters`` line-search steps."""

NAMES = ('newton_generic_kernel',)


def work(shape: dict, B: int):
  iters, ls_iters, nv, R = (shape['iters'], shape['ls_iters'], shape['nv'],
                            shape['R'])
  ins = (nv * nv + 2 * nv + nv * R + 3 * R) * B + 2 * R
  outs = (nv + R + nv) * B
  mv = 2 * nv * (nv + R)  # one product with M and J
  per_iter = (
      2 * (nv * (nv + 1) // 2) * R + nv * R  # Hessian triangle, J·diag(c)
      + mv  # gradient
      + 2 * nv**3 / 3 + 2 * nv * nv  # Cholesky and solves
      + mv  # M dx, J dx
      + ls_iters * 8 * R  # line search
      + 12 * R  # accept test
  )
  flops = B * (2 * nv * R + iters * per_iter + 2 * nv * R)
  return 4 * (ins + outs), flops
