"""The port's scaling sweep, ``python -m rsr_mjx_tpu_torch.bench_scaling``,
on the CPU (the kernels' plain versions): one process prints the device
line and one JSON line with the JAX script's keys and a finite positive
rate; ``--spawn_two_process`` runs the sweep in two gloo processes (2 envs
a process, 2 control steps, 1 timed rollout) and process 0 prints
``devices 2, processes 2``.  A count above the processes raises, and
without a card the default device raises.
"""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from rsr_mjx_tpu_torch import bench_scaling
from torch_testing import child_env, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ['--envs_per_device', '2', '--steps', '2', '--reps', '1']
KEYS = {'metric', 'devices', 'processes', 'num_envs', 'value', 'unit'}


def _check(line, devices, processes, num_envs):
  assert set(line) == KEYS
  assert line['metric'] == 'AirbotCubePush_env_steps_per_s'
  assert (line['devices'], line['processes'], line['num_envs']) == (
      devices, processes, num_envs)
  assert math.isfinite(line['value']) and line['value'] > 0
  assert line['unit'] == 'env-steps/s'


def test_one_process_prints_one_line(capsys):
  lines = bench_scaling.main(SMALL + ['--device', 'cpu'])
  out = capsys.readouterr().out.strip().splitlines()
  assert out[-2] == 'cpu' and json.loads(out[-1]) == lines[0]
  (line,) = lines
  _check(line, 1, 1, 2)


def test_spawn_two_process():
  out = subprocess.run(
      [sys.executable, '-m', 'rsr_mjx_tpu_torch.bench_scaling',
       '--spawn_two_process'] + SMALL, cwd=ROOT, env=child_env(),
      capture_output=True, text=True, timeout=300,
      check=True).stdout.strip().splitlines()
  lines = [json.loads(s) for s in out if s.startswith('{')]
  assert len(lines) == 1 and 'cpu' in out
  _check(lines[0], 2, 2, 4)


def test_counts_above_the_processes_raise():
  with pytest.raises(ValueError, match='outside 1..1'):
    bench_scaling.main(SMALL + ['--device', 'cpu', '--device_counts', '1,2'])


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_raises_without_a_card():
  with pytest.raises(RuntimeError, match='no CUDA device'):
    bench_scaling.main(SMALL)
