"""The manifest against the benchmark's rules, and every file a cell is
made of found by its name, a file added later too, without an edit."""

import json
import os
import re
import shutil

import pytest

from benchmark import common

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.fixture(scope='module')
def spec():
  return common.manifest()


def test_top_level_keys(spec):
  assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                       'workloads', 'end_to_end', 'per_layer'}
  assert spec['paths'] == ['benchmark']
  assert 1 <= spec['run_seconds'] <= 51
  assert len(json.dumps(spec)) < 64 * 1024
  assert len(spec['command']) <= 32
  for word in spec['command']:
    assert not word.startswith('/') and '..' not in word


def test_names_units_and_lines(spec):
  names = [c['name'] for c in spec['configs']] + [
      w['name'] for w in spec['workloads']] + [
          m['name'] for m in spec['end_to_end'] + spec['per_layer']]
  assert len(names) == len(set(names))
  for n in names:
    assert NAME.match(n), n
  for m in spec['end_to_end'] + spec['per_layer']:
    assert UNIT.match(m['unit']), m
    assert m['better'] in ('lower', 'higher')
  for text in ([c['why'] for c in spec['configs']]
               + [w['why'] for w in spec['workloads']]
               + [m['layer'] for m in spec['per_layer']]):
    assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_every_cell_reports_setup_another_metric_and_a_layer(spec):
  e2e = {m['name'] for m in spec['end_to_end']}
  assert 'setup_s' in e2e
  for w in spec['workloads']:
    mine = {m['name'] for m in common.metrics_of(spec, 'end_to_end',
                                                 w['name'])}
    assert 'setup_s' in mine and len(mine) >= 2, w['name']
    layers = common.metrics_of(spec, 'per_layer', w['name'])
    assert layers, w['name']
    for m in layers:
      assert m['moves'] in mine, (w['name'], m['name'])


def test_bounds(spec):
  for m in spec['end_to_end']:
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0.01 <= m['bound'] <= 0.25, m
  for m in spec['per_layer']:
    assert 'bound' not in m
    assert m['source'] in ('device_trace', 'program_span', 'program_counter',
                           'host_clock')


def test_cells_name_their_files(spec):
  cfgs = {c['name']: c for c in spec['configs']}
  for w in spec['workloads']:
    assert w['chips'] in (1, 4)
    assert w['config'] in cfgs
    cfg = common.load_json('configs', w['config'])
    assert cfg['reduced'] == cfgs[w['config']]['reduced']
    traffic = common.load_json('traffic', w['traffic'])
    assert common.generator(traffic['generator']).run
    assert common.load_json('limits', w['name'])
  for c in spec['configs']:
    assert c['file'] == f'benchmark/configs/{c["name"]}.json'
    assert any(w['config'] == c['name'] for w in spec['workloads'])
  for m in spec['per_layer']:
    assert callable(common.load_file('metrics', m['name']).read)


def test_kernel_counts_found_by_name():
  files = common.roofline_files()
  assert {'K1', 'K2', 'K3', 'K4'} <= set(files)
  for cfg in ('cube_push', 'go2_joystick'):
    c = common.load_json('configs', cfg)
    for k, shape in c['kernels'].items():
      nbytes, flops = files[k].work(shape, 2048)
      assert nbytes > 0 and flops > 0 and files[k].NAMES


def test_a_file_added_later_is_found(tmp_path, monkeypatch):
  """A later cell brings a configuration, a traffic mix, limits, a metric
  and a kernel count as new files; the harness finds each by its name."""
  copy = tmp_path / 'benchmark'
  shutil.copytree(common.HERE, copy,
                  ignore=shutil.ignore_patterns('tests', '__pycache__'))
  (copy / 'configs' / 'probe.json').write_text(json.dumps({'env': 'x'}))
  (copy / 'traffic' / 'probe.json').write_text(
      json.dumps({'generator': 'rollout'}))
  (copy / 'limits' / 'probe.cell.json').write_text(json.dumps({'g': 1}))
  (copy / 'metrics' / 'probe_metric.x.py').write_text(
      'def read(ctx, out):\n  return 1.5\n')
  (copy / 'roofline' / 'K9.py').write_text(
      "NAMES = ('k9',)\n\ndef work(shape, B):\n  return 4 * B, B\n")
  monkeypatch.setattr(common, 'HERE', str(copy))
  assert common.load_json('configs', 'probe') == {'env': 'x'}
  assert common.load_json('traffic', 'probe')['generator'] == 'rollout'
  assert common.load_json('limits', 'probe.cell') == {'g': 1}
  assert common.load_file('metrics', 'probe_metric.x').read(None, None) == 1.5
  assert common.roofline_files()['K9'].work({}, 3) == (12, 3)
  # the existing files were not touched
  for name in os.listdir(os.path.join(os.path.dirname(common.__file__),
                                      'configs')):
    assert name != 'probe.json'
