"""The port's benchmark script, ``python -m rsr_mjx_tpu_torch.bench``, on the
CPU at 4 envs, 2 control steps and 1 or 2 timed rollouts (the kernels'
plain versions): its last line is one JSON object with the metric names of
the JAX package's benchmarks, a finite positive rate, the unit and the
device; every earlier rate is on the line before.  Without a card it
raises unless given ``--device cpu``.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from rsr_mjx_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ['--device', 'cpu', '--num_envs', '4', '--steps', '2']


def _check_line(line: dict, metric: str) -> None:
  assert set(line) == {'metric', 'value', 'unit', 'device'}
  assert line['metric'] == metric
  assert math.isfinite(line['value']) and line['value'] > 0
  assert line['unit'] == 'env-steps/s' and line['device'] == 'cpu'


def test_bench_module_prints_one_json_line():
  out = subprocess.run(
      [sys.executable, '-m', 'rsr_mjx_tpu_torch.bench', *SMALL, '--reps',
       '1'], cwd=ROOT, capture_output=True, text=True, timeout=300,
      check=True).stdout.strip().splitlines()
  _check_line(json.loads(out[-1]), 'airbot_cube_push_env_steps_per_s')
  assert out[-2].startswith('AirbotCubePush B=4 2 control steps x 1')


def test_bench_go2_line(capsys):
  line = bench.main([*SMALL, '--env', 'Go2JoystickFlatTerrain', '--reps',
                     '2'])
  out = capsys.readouterr().out.strip().splitlines()
  assert json.loads(out[-1]) == line
  _check_line(line, 'go2_joystick_flat_env_steps_per_s')
  rates = [float(r) for r in out[-2].split('per rollout ')[1].split()]
  assert len(rates) == 2
  assert min(rates) <= line['value'] <= max(rates)  # their median


def test_bench_metric_names():
  assert bench.metric_name('AirbotCubePush') == (
      'airbot_cube_push_env_steps_per_s')
  assert bench.metric_name('Go2Getup') == 'go2_getup_env_steps_per_s'


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_bench_raises_without_a_card():
  with pytest.raises(RuntimeError, match='no CUDA device'):
    bench.run(num_envs=4, steps=2, reps=1)
