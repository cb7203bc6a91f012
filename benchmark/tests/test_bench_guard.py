"""The import guard, the reference's independence from the port, and a run
without a card."""

import ast
import os
import subprocess
import sys

from benchmark import common, run


def test_forbidden_by_whole_top_level_name():
  names = ['jax', 'jax.numpy', 'jaxlib.xla', 'flax.linen', 'rsr_mjx_tpu',
           'rsr_mjx_tpu.physics', 'rsr_mjx_tpu_torch', 'rsr_mjx_tpu_torch.envs',
           'jaxtyping', 'flaxen', 'numpy']
  assert common.forbidden_modules(names) == [
      'flax.linen', 'jax', 'jax.numpy', 'jaxlib.xla', 'rsr_mjx_tpu',
      'rsr_mjx_tpu.physics']


def _imports(path):
  tree = ast.parse(open(path).read())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
  ref = os.path.join(common.HERE, 'reference')
  for root, _, files in os.walk(ref):
    for f in files:
      if f.endswith('.py'):
        for mod in _imports(os.path.join(root, f)):
          top = mod.split('.')[0]
          assert top not in ('rsr_mjx_tpu_torch',) + common.FORBIDDEN, (f, mod)


def test_a_run_loads_no_jax():
  """The harness, the port it drives and the two served weights load no
  module of JAX or of the JAX package."""
  code = (
      'import sys\n'
      'from benchmark import common, run\n'
      'from benchmark.generators import rollout, train\n'
      'from benchmark.reference import policy\n'
      'from rsr_mjx_tpu_torch.train import networks, ppo\n'
      'from rsr_mjx_tpu_torch import envs\n'
      'for w in ("logs/cube_ppo_15M_r4/final_params.pkl",\n'
      '          "logs/go2_joystick_50M_r5/final_params.pkl"):\n'
      '  policy.load(w); networks.load_ppo_params(w)\n'
      'print(common.forbidden_modules())\n')
  env = dict(os.environ)
  env.pop('JAX_PLATFORMS', None)
  out = subprocess.run([sys.executable, '-c', code], cwd=common.ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip().splitlines()[-1] == '[]'


def test_no_card_no_result(capsys):
  """Without CUDA the run fails and prints nothing on standard output."""
  import torch

  if torch.cuda.is_available():
    return  # the card's own runs cover the other branch
  assert run.main(['--workload', 'cube_push.rollout', '--seed', '1',
                   '--seconds', '1']) == 2
  assert capsys.readouterr().out == ''


def test_alone_it_fails(tmp_path):
  """In a folder holding only the manifest and the benchmark, a run exits
  with an error and prints no result."""
  import shutil

  shutil.copytree(common.HERE, tmp_path / 'benchmark',
                  ignore=shutil.ignore_patterns('__pycache__'))
  shutil.copy(os.path.join(common.ROOT, 'BENCHMARK.json'), tmp_path)
  out = subprocess.run(
      [sys.executable, '-m', 'benchmark.run', '--workload',
       'cube_push.rollout', '--seed', '1', '--seconds', '1'],
      cwd=tmp_path, capture_output=True, text=True, timeout=300)
  assert out.returncode != 0 and out.stdout == ''
