"""K3, the pyramid-basis Newton solve (``csrc/newton_pyr.cu``) at its
fixed schedule of ``iters`` Newton and ``ls_iters`` line-search steps."""

NAMES = ('newton_pyr_kernel',)


def work(shape: dict, B: int):
  iters, ls_iters = shape['iters'], shape['ls_iters']
  nv, Rs, NU, C, naxes = (shape['nv'], shape['Rs'], shape['NU'], shape['C'],
                          shape['naxes'])
  nc = 2 * naxes * C  # contact pyramid rows
  ins = (nv * nv + 2 * nv + nv * Rs + 3 * Rs + nv * NU + NU + C) * B + 2 * Rs
  outs = (nv + Rs + nc + nv) * B
  mv = 2 * nv * (nv + Rs + NU)  # one product with M, J and U
  per_iter = (
      2 * (nv * (nv + 1) // 2) * (Rs + NU)  # Hessian lower triangle
      + nv * Rs + 2 * nv * C * (1 + 2 * naxes)  # J·diag(c) and W = U·S
      + mv  # gradient
      + 2 * nv**3 / 3 + 2 * nv * nv  # Cholesky and solves
      + mv  # M dx, J dx, U dx
      + ls_iters * 8 * (Rs + nc)  # line search
      + 12 * (Rs + nc)  # accept test
  )
  flops = B * (mv + iters * per_iter + mv)
  return 4 * (ins + outs), flops
