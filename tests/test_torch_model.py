"""The PyTorch port's model against the JAX package's, and the port's rules.

The port builds the Airbot models (both cube-push variants, T-push) from
committed snapshots (numpy only); these tests hold each snapshot field by
field against the JAX Model that C MuJoCo compiles from the same MJCF,
against a fresh build by the port's own ``put_model``, and check the
constraint layout.  All exact: both sides take the same float32 values
from the compiled MjModel.
"""

import ast
import os

import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.physics import constraint as jC
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs.airbot import snapshot
from rsr_mjx_tpu_torch.physics import constraint as pC
from rsr_mjx_tpu_torch.physics import io as pio
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.physics import types as pT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (nq, nv, nu, ncon, ncon_sel) of each Airbot env's model
SIZES = {'AirbotCubePush': (22, 20, 5, 480, 24),
         'AirbotCubePushTrain': (22, 20, 5, 480, 24),
         'AirbotTPush': (15, 14, 5, 720, 32)}


def _np(x):
  return None if x is None else np.asarray(x)


def _assert_port_models_equal(a, b):
  for f in pT.SIZE_FIELDS + ('ncon', 'ncon_sel'):
    assert getattr(a, f) == getattr(b, f), f
  for f in pT.OPT_TENSOR_FIELDS:
    np.testing.assert_array_equal(_np(getattr(a.opt, f)),
                                  _np(getattr(b.opt, f)), err_msg=f)
  for f in pT.OPT_STATIC_FIELDS:
    assert getattr(a.opt, f) == getattr(b.opt, f), f
  for f in pT.NUMERIC_FIELDS:
    x, y = _np(a.numeric[f]), _np(b.numeric[f])
    assert (x is None) == (y is None), f
    if x is not None:
      np.testing.assert_array_equal(x, y, err_msg=f)
  for f in pT.STATIC_FIELDS:
    np.testing.assert_array_equal(a.static[f], b.static[f], err_msg=f)
  assert [n for n, _ in a.pairs] == [n for n, _ in b.pairs]
  for (_, x), (_, y) in zip(a.pairs, b.pairs):
    np.testing.assert_array_equal(x, y)
  assert a.names == b.names


@pytest.mark.parametrize('name', sorted(SIZES))
def test_model_matches_jax(name):
  jm = jenvs.load(name).model
  pm = penvs.load(name, device='cpu').model
  for f in pT.SIZE_FIELDS + ('ncon', 'ncon_sel'):
    assert getattr(pm, f) == getattr(jm, f), f
  assert (pm.nq, pm.nv, pm.nu, pm.ncon, pm.ncon_sel) == SIZES[name]
  for f in pT.OPT_TENSOR_FIELDS:
    np.testing.assert_array_equal(_np(getattr(pm.opt, f)),
                                  _np(getattr(jm.opt, f)), err_msg=f)
  for f in pT.OPT_STATIC_FIELDS:
    assert getattr(pm.opt, f) == getattr(jm.opt, f), f
  for f in pT.NUMERIC_FIELDS:
    x, y = _np(pm.numeric[f]), _np(getattr(jm, f))
    assert (x is None) == (y is None), f
    if x is not None:
      assert x.dtype == np.float32, f
      np.testing.assert_array_equal(x, y, err_msg=f)
  for f in pT.STATIC_FIELDS:
    np.testing.assert_array_equal(pm.static[f], getattr(jm, f).arr,
                                  err_msg=f)
  assert [n for n, _ in pm.pairs] == [n for n, _ in jm.pairs]
  for (_, x), (_, y) in zip(pm.pairs, jm.pairs):
    np.testing.assert_array_equal(x, y.arr)
  # the port also keeps the keyframe names (the JAX envs ask the MjModel)
  assert {k: v for k, v in pm.names.items() if k != 'key'} == {
      k: dict(v) for k, v in jm.names}


@pytest.mark.parametrize('variant', snapshot.VARIANTS)
def test_snapshot_round_trip(variant, tmp_path):
  committed = pio.load_model_npz(snapshot.path(variant), device='cpu')
  fresh = snapshot.build(variant)
  _assert_port_models_equal(fresh, committed)
  out = str(tmp_path / 'm.npz')
  pio.save_model_npz(fresh, out)
  _assert_port_models_equal(fresh, pio.load_model_npz(out, device='cpu'))


@pytest.mark.parametrize('name, rows, pairs', [
    ('AirbotCubePushTrain', (181, 1, 20, 16, 144), ('box_box', 30, 16, 0)),
    ('AirbotTPush', (223, 1, 14, 16, 192), ('box_box', 45, 16, 0)),
])
def test_layout_matches_jax(name, rows, pairs):
  """(nefc, n_eq, n_fri, n_lim, n_con) and the pair groups: T-push's 32
  selected contacts give 32 × 3 axes × 2 = 192 contact rows."""
  jm = jenvs.load(name).model
  pm = penvs.load(name, device='cpu').model
  jl, pl = jC.layout_cached(jm), pC.layout_cached(pm)
  assert (pl.nefc, pl.n_eq, pl.n_fri, pl.n_lim, pl.n_con) == rows
  assert (jl.nefc, jl.n_eq, jl.n_fri, jl.n_lim, jl.n_con) == (
      pl.nefc, pl.n_eq, pl.n_fri, pl.n_lim, pl.n_con)
  np.testing.assert_array_equal(pl.kind, jl.kind)
  assert pC.pair_groups(pm) == jC.pair_groups(jm) == [pairs]
  np.testing.assert_array_equal(pC.contact_dmask(pm), jC.contact_dmask(jm))


def _port_sources():
  paths = [os.path.join(ROOT, 'chip_smoke.py')]
  for dirpath, dirs, files in os.walk(os.path.join(ROOT, 'rsr_mjx_tpu_torch')):
    # build/ holds generated output (listed in .gitignore), not sources
    dirs[:] = [d for d in dirs if d != 'build']
    paths += [os.path.join(dirpath, f) for f in files if f.endswith('.py')]
  return paths


def test_port_imports_neither_jax_nor_the_jax_package():
  bad = []
  for path in _port_sources():
    with open(path) as f:
      tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        mods = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom) and node.level == 0:
        mods = [node.module or '']
      else:
        continue
      for mod in mods:
        top = mod.split('.')[0]
        if top in ('jax', 'jaxlib', 'flax', 'rsr_mjx_tpu', 'ml_collections'):
          bad.append(f'{os.path.relpath(path, ROOT)}:{node.lineno} {mod}')
    # mujoco only inside the functions that compile MJCF, never at import
    for node in tree.body:
      if isinstance(node, (ast.Import, ast.ImportFrom)):
        mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ''])
        if any(mod.split('.')[0] == 'mujoco' for mod in mods):
          bad.append(f'{os.path.relpath(path, ROOT)}:{node.lineno} mujoco')
  assert len(_port_sources()) > 25
  assert not bad, bad


def test_kernel_wrappers_refuse_what_they_do_not_take():
  n, B = 20, 3
  A = torch.eye(n)[:, :, None].expand(n, n, B).contiguous()
  b = torch.ones(n, B)
  np.testing.assert_allclose(plk.spd_solve_lanes(A, b).numpy(), b.numpy())
  with pytest.raises(TypeError):  # mixed dtypes
    plk.spd_solve_lanes(A.double(), b)
  with pytest.raises(TypeError):  # neither kernel nor plain version
    plk.spd_solve_lanes(A.half(), b.half())
  with pytest.raises(ValueError):
    plk.spd_solve_lanes(A[:, :, :2], b)
  with pytest.raises(ValueError):
    plk.spd_solve_lanes(A.transpose(0, 1), b)  # not contiguous
  with pytest.raises(ValueError):  # no kernel and no fallback off the CPU
    plk.spd_solve_lanes(A.to('meta'), b.to('meta'))
  assert plk.LAUNCHES['spd_solve_lanes'] == 0
