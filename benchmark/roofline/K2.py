"""K2, the contact selection (``csrc/contact_select.cu``): the nsel
nearest of ncon contact slots and their features."""

NAMES = ('contact_select_kernel',)


def work(shape: dict, B: int):
  ncon, nsel, Fd = shape['ncon'], shape['nsel'], shape['Fd']
  Ptot, nst = shape['Ptot'], shape['nst']
  # every dist read once; only the selected slots' features are needed;
  # the rows and the picked slots written
  nbytes = 4 * (ncon * B + nsel * Fd * B + Ptot * nst + ncon
                + nsel * (Fd + nst) * B + nsel * B)
  flops = ncon * B  # each dist compared at least once
  return nbytes, flops
