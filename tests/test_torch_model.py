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
from torch_testing import child_env, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

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
    # mujoco only inside the functions that compile MJCF, never at import;
    # the packages the card machine lacks only under try/except ImportError
    for node, guarded in _module_level_imports(tree.body):
      mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
              else [node.module or ''])
      for top in {mod.split('.')[0] for mod in mods}:
        if top == 'mujoco' or (top in OPTIONAL and not guarded):
          bad.append(f'{os.path.relpath(path, ROOT)}:{node.lineno} {top}')
  assert len(_port_sources()) > 25
  assert not bad, bad


# packages the card machine does not have: a module of the port imports
# them inside the functions that use them, or under try/except ImportError
OPTIONAL = ('cv2', 'rospy', 'matplotlib', 'tensorboardX', 'wandb', 'yaml',
            'PIL', 'geometry_msgs', 'sensor_msgs', 'std_msgs')


def _module_level_imports(body, guarded=False):
  """(import node, whether a try with an ImportError handler encloses it)
  for every import run when the module is imported (not those inside
  functions or classes)."""
  for node in body:
    if isinstance(node, (ast.Import, ast.ImportFrom)):
      yield node, guarded
    elif isinstance(node, ast.Try):
      catches = any(
          h.type is not None and any(
              isinstance(n, ast.Name)
              and n.id in ('ImportError', 'ModuleNotFoundError')
              for n in ast.walk(h.type)) for h in node.handlers)
      yield from _module_level_imports(node.body, guarded or catches)
      for part in (node.orelse, node.finalbody,
                   *(h.body for h in node.handlers)):
        yield from _module_level_imports(part, guarded)
    elif isinstance(node, (ast.If, ast.With)):
      yield from _module_level_imports(node.body, guarded)
      yield from _module_level_imports(getattr(node, 'orelse', []), guarded)


def test_import_rule_sees_guards():
  """The rule above on small sources: a bare top-level import of cv2 and
  one under a try that does not catch ImportError break it."""
  cases = {
      'import cv2\n': 1,
      'try:\n  import cv2\nexcept ImportError:\n  cv2 = None\n': 0,
      'try:\n  import rospy\nexcept ValueError:\n  pass\n': 1,
      'def f():\n  import matplotlib\n': 0,
      'if True:\n  from PIL import Image\n': 1,
  }
  for src, n in cases.items():
    found = [node for node, guarded in _module_level_imports(
        ast.parse(src).body) if not guarded]
    assert len(found) == n, src


def _modules(package):
  out = set()
  for dirpath, dirs, files in os.walk(os.path.join(ROOT, package)):
    dirs[:] = [d for d in dirs if d not in ('build', '__pycache__')]
    rel = os.path.relpath(dirpath, os.path.join(ROOT, package))
    out |= {os.path.normpath(os.path.join(rel, f)) for f in files
            if f.endswith('.py')}
  return out


def test_port_has_every_module_of_the_jax_package():
  """Every module of rsr_mjx_tpu/ has its counterpart in the port, but the
  per-env physics/kinematics.py and smooth.py, which ROADMAP.md argues the
  port does not need (its lanes stages are their batched form)."""
  missing = _modules('rsr_mjx_tpu') - _modules('rsr_mjx_tpu_torch')
  assert missing == {'physics/kinematics.py', 'physics/smooth.py'}
  for mod in ('utils/reward.py', 'utils/gait.py', 'utils/rendering.py',
              'envs/go2/visual.py', 'deploy/policy.py', 'bench_scaling.py'):
    assert mod in _modules('rsr_mjx_tpu_torch')


def test_port_imports_without_the_optional_packages():
  """Deployment, rendering and the programs import where none of the
  optional packages nor mujoco is installed (the card machine)."""
  import subprocess
  import sys

  blocked = ', '.join(repr(m) for m in OPTIONAL + ('mujoco',))
  code = (
      'import sys\n'
      f'for m in ({blocked}):\n'
      '  sys.modules[m] = None\n'
      'import rsr_mjx_tpu_torch.deploy, rsr_mjx_tpu_torch.deploy.perception\n'
      'import rsr_mjx_tpu_torch.deploy.ros_adapter, rsr_mjx_tpu_torch.utils\n'
      'import rsr_mjx_tpu_torch.utils.rendering\n'
      'import rsr_mjx_tpu_torch.envs.go2.visual, rsr_mjx_tpu_torch.train.cli\n'
      'import rsr_mjx_tpu_torch.train.eval_go2, rsr_mjx_tpu_torch.bench_scaling\n'
      "assert 'jax' not in sys.modules\n")
  done = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                        env=child_env(), capture_output=True, text=True,
                        timeout=120)
  assert done.returncode == 0, done.stderr[-2000:]


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
