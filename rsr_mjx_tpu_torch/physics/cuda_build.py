"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, into ``rsr_mjx_tpu_torch/build/`` (listed in
``.gitignore``); all sources compile at once, one ``nvcc`` process each.
Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from rsr_mjx_tpu_torch.utils import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point and argument types of each library
SIGNATURES = {
    'spd_solve': ('spd_solve_lanes_launch', [P, P, P, I, I, F, I, P]),
    'contact_select': ('contact_select_launch', [P] * 6 + [I] * 7 + [P]),
    'newton_pyr': ('newton_pyr_launch', [P] * 16 + [I] * 8 + [P]),
    'newton_generic': ('newton_generic_launch', [P] * 12 + [I] * 6 + [P]),
    'assemble_rows': ('assemble_rows_launch', [P] * 16 + [I] * 10 + [F, P]),
}
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_LOCK = threading.Lock()
_FUNCS: dict = {}


def _nvcc() -> str:
  for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _lib_path(name: str) -> str:
  return os.path.join(BUILD_DIR, f'lib{name}.so')


def _stale(name: str) -> bool:
  lib = _lib_path(name)
  if not os.path.exists(lib):
    return True
  t = os.path.getmtime(lib)
  deps = [f'{name}.cu'] + [f for f in os.listdir(CSRC) if f.endswith('.cuh')]
  return any(os.path.getmtime(os.path.join(CSRC, f)) > t for f in deps)


@tracing.span('kernels.build')
def build_all(verbose: bool = False) -> dict:
  """Compile every stale kernel library, all ``nvcc`` runs in parallel
  (span ``kernels.build``; counter ``kernels.builds``, the libraries
  built).  Returns {name: compiler output}; raises if any build fails."""
  os.makedirs(BUILD_DIR, exist_ok=True)
  nvcc = _nvcc()
  procs = {}
  for name in SIGNATURES:
    if not _stale(name):
      continue
    tmp = _lib_path(name) + f'.tmp{os.getpid()}'
    cmd = [nvcc] + NVCC_FLAGS + (['-Xptxas', '-v'] if verbose else []) + [
        '-o', tmp, os.path.join(CSRC, f'{name}.cu')]
    procs[name] = (tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  logs, failed = {}, []
  for name, (tmp, proc) in procs.items():
    out, _ = proc.communicate()
    logs[name] = out
    if proc.returncode:
      failed.append(name)
    else:
      os.replace(tmp, _lib_path(name))
  tracing.count('kernels.builds', len(procs) - len(failed))
  if failed:
    raise RuntimeError('nvcc failed for ' + ', '.join(
        f'{n}:\n{logs[n]}' for n in failed))
  return logs


def kernel(name: str):
  """The C launcher of library ``name`` (built and loaded at first use)."""
  fn = _FUNCS.get(name)
  if fn is None:
    with _LOCK:
      if name not in _FUNCS:
        if any(_stale(n) for n in SIGNATURES):
          build_all()
        for n, (sym, argtypes) in SIGNATURES.items():
          f = getattr(ctypes.CDLL(_lib_path(n)), sym)
          f.argtypes = argtypes
          f.restype = ctypes.c_int
          _FUNCS[n] = f
      fn = _FUNCS[name]
  return fn
