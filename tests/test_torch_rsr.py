"""The port's RSR penalty pieces against the JAX package's, on the CPU.

Inputs come from numpy seeds or from ``data_rsr_demo/``; where a penalty
state is compared, JAX's grid is handed to the port (``grid=``), since the
two packages draw their grids from different generators.  Tolerances:
  - the KDE densities, KL and Wasserstein distance of seeded data: rtol 1e-5
    (fp32, sums in another order);
  - the penalty state of the demo data: ``anchor_logsum`` (log-sums of about
    -1e2 to -1e4) rtol 1e-6, ``target_cdf`` within 1e-6; the gain within
    1e-4 of its float64 value, in both packages (the KL of two nearby
    densities cancels: both fp32 gains are 2e-6 to 2e-5 from float64);
  - ``compute_rsr_loss`` where the gate is open, value and gradient with
    respect to the actions: each package's fp32 result within 2e-4 of the
    port's float64 evaluation (of the value, of the gradient's largest
    entry); the distance sums differences of CDFs near 1 and cancels as
    well (both packages measured up to 4.3e-5 from float64 in value);
  - in the saturated case, where fp32 and float64 differ in kind, the port
    against JAX in fp32: rtol 1e-4;
  - the loader and the validation: the same results and the same messages.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsr_mjx_tpu.rsr import datasets as jdatasets
from rsr_mjx_tpu.rsr import distribution as jdist
from rsr_mjx_tpu.rsr import loss as jloss
from rsr_mjx_tpu.rsr import pipeline as jpipeline
from rsr_mjx_tpu_torch import rsr as prsr
from rsr_mjx_tpu_torch.rsr import datasets as pdatasets
from rsr_mjx_tpu_torch.rsr import distribution as pdist
from rsr_mjx_tpu_torch.rsr import loss as ploss
from rsr_mjx_tpu_torch.rsr import pipeline as ppipeline
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, 'data_rsr_demo')


def _demo():
  """The five demo arrays (50 transitions, obs 23, act 5) as JAX loads
  them, and the three (50, 51) transition sets they make."""
  arrays = [np.asarray(a) for a in jdatasets.load_rsr_datasets(DEMO, 50)]
  s, a = arrays[:2]
  return arrays, [np.hstack([s, a, x]) for x in arrays[2:]]


def test_public_names_match_jax():
  import rsr_mjx_tpu.rsr as jrsr
  assert prsr.__all__ == jrsr.__all__
  assert pdatasets.REQUIRED_DATA_FILES == jdatasets.REQUIRED_DATA_FILES


def test_kde_kl_wasserstein_match_jax():
  rng = np.random.default_rng(0)
  data = rng.normal(size=(30, 11)).astype(np.float32)
  other = (data + 0.3 * rng.normal(size=data.shape)).astype(np.float32)
  grid = rng.uniform(-3, 3, size=(10, 11)).astype(np.float32)
  t = torch.from_numpy
  for bw in (0.5, 2.0):
    p = pdist.evaluate_kde(t(data), t(grid), bw)
    q = pdist.evaluate_kde(t(other), t(grid), bw)
    jp = jdist.evaluate_kde(jnp.asarray(data), jnp.asarray(grid), bw)
    jq = jdist.evaluate_kde(jnp.asarray(other), jnp.asarray(grid), bw)
    np.testing.assert_allclose(p.numpy(), jp, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pdist.kl_divergence(p, q).item(),
                               float(jdist.kl_divergence(jp, jq)), rtol=1e-5)
    np.testing.assert_allclose(pdist.wasserstein_distance(p, q).item(),
                               float(jdist.wasserstein_distance(jp, jq)),
                               rtol=1e-5)


def test_abs_gradient_at_zero_is_jax():
  """The Wasserstein sum's |d|: gradient +1 at an exact zero, as JAX's,
  where torch.abs gives 0."""
  x = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
  pdist.jax_abs(x).sum().backward()
  jg = jax.grad(lambda v: jnp.sum(jnp.abs(v)))(jnp.array([-2.0, 0.0, 3.0]))
  np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
  assert x.grad.tolist() == [-1.0, 1.0, 1.0]


def test_make_grid_is_seeded_and_the_same_on_every_device():
  g = prsr.make_grid(10, 51, seed=3, device='cpu')
  assert g.shape == (10, 51) and g.dtype == torch.float32
  assert float(g.min()) >= -3.0 and float(g.max()) < 3.0
  assert torch.equal(g, prsr.make_grid(10, 51, seed=3, device='cpu'))
  assert not torch.equal(g, prsr.make_grid(10, 51, seed=4, device='cpu'))


@pytest.mark.parametrize('bandwidth', [0.1, 2.0])
def test_build_rsr_data_on_the_demo_matches_jax(bandwidth):
  """At the demo's default bandwidth 0.1 every KDE on the 10-point grid is
  one-hot: the gain is exactly 0.0 in both packages, on either grid, and
  the penalty is identically zero.  At 2.0 the gate is open: 0.00680 on
  JAX's grid."""
  arrays, sets = _demo()
  jdata = jpipeline.build_policy_rsr_data(*arrays, bandwidth=bandwidth)
  pdata = ppipeline.build_policy_rsr_data(
      *arrays, bandwidth=bandwidth, grid=np.asarray(jdata.grid), device='cpu')
  own = ppipeline.build_policy_rsr_data(*arrays, bandwidth=bandwidth,
                                        device='cpu')
  assert (pdata.n_anchors, pdata.width, pdata.bandwidth) == (
      jdata.n_anchors, jdata.width, jdata.bandwidth) == (50, 51, bandwidth)
  np.testing.assert_array_equal(pdata.grid.numpy(), jdata.grid)
  np.testing.assert_allclose(pdata.anchor_logsum.numpy(), jdata.anchor_logsum,
                             rtol=1e-6)
  np.testing.assert_allclose(pdata.target_cdf.numpy(), jdata.target_cdf,
                             rtol=0, atol=1e-6)
  np.testing.assert_allclose(pdata.grid_sq.numpy(), jdata.grid_sq, rtol=1e-6)
  if bandwidth == 0.1:
    assert float(jdata.weight) == 0.0
    assert pdata.weight.item() == 0.0 and own.weight.item() == 0.0
    np.testing.assert_array_equal(jdata.target_cdf,
                                  [0, 0, 0, 1, 1, 1, 1, 1, 1, 1])
  else:
    w64 = ploss.build_rsr_data(
        *(torch.from_numpy(x).double() for x in sets), bandwidth=bandwidth,
        grid=np.asarray(jdata.grid)).weight.item()
    for w in (pdata.weight.item(), float(jdata.weight)):
      assert abs(w - w64) <= 1e-4 * w64
      assert round(w, 5) == 0.0068
    assert own.weight.item() > 0  # the port's own grid opens the gate too


def _rsr_cases():
  """(name, transition sets, bandwidth, obs, actions, next obs) of the
  penalty comparisons."""
  arrays, sets = _demo()
  s, a, _, _, ncs = arrays
  rng = np.random.default_rng(0)
  idx = rng.choice(50, 8, replace=False)
  act = (a[idx] + 0.1 * rng.normal(size=(8, 5))).astype(np.float32)
  for bw in (2.0, 0.5):
    yield f'demo, bandwidth {bw}', sets, bw, s[idx], act, ncs[idx]
  # tests/test_train_ppo.py::test_rsr_loss_gradient_flows_through_actions
  rng = np.random.RandomState(1)
  real = rng.randn(8, 8).astype(np.float32)
  obs, nobs = (rng.randn(4, 3).astype(np.float32) for _ in range(2))
  act = rng.randn(4, 2).astype(np.float32)
  yield ('gradient flows', [real, real + np.float32(0.1),
                            real + np.float32(0.05)], 2.0, obs, act, nobs)


def _port_penalty(sets, bw, grid, obs, act, nobs, dtype):
  """(value, distance, gradient w.r.t. the actions, the ``RSRData``) of the
  port in ``dtype``."""
  data = ploss.build_rsr_data(*(torch.from_numpy(x).to(dtype) for x in sets),
                              bandwidth=bw, grid=grid)
  at = torch.tensor(act, dtype=dtype, requires_grad=True)
  value, dist = ploss.compute_rsr_loss(torch.tensor(obs, dtype=dtype), at,
                                       torch.tensor(nobs, dtype=dtype), data)
  value.backward()
  return value.item(), dist.item(), at.grad.double().numpy(), data


@pytest.mark.parametrize('case', ['demo, bandwidth 2.0',
                                  'demo, bandwidth 0.5', 'gradient flows'])
def test_compute_rsr_loss_and_gradient_match_jax(case, monkeypatch):
  """Value and gradient with respect to the actions against jax.grad.  At
  bandwidth 0.5 the demo's densities saturate in fp32: the gain is
  1.4e-10, some entries of cumsum(density) − target are exact zeros, and
  the whole gradient (about 1e-20) comes from JAX's |0|' = +1 convention:
  with torch.abs the gradient falls below 1e-4 of it."""
  name, sets, bw, obs, act, nobs = next(c for c in _rsr_cases()
                                        if c[0] == case)
  jdata = jloss.build_rsr_data(*sets, bandwidth=bw)
  grid = np.asarray(jdata.grid)

  def jfun(a):
    return jloss.compute_rsr_loss(obs, a, nobs, jdata)

  (jvalue, jdist_), jgrad = jax.value_and_grad(jfun, has_aux=True)(
      jnp.asarray(act))
  jvalue, jdist_ = float(jvalue), float(jdist_)
  jgrad = np.asarray(jgrad, np.float64)
  pvalue, pdist_, pgrad, pdata = _port_penalty(sets, bw, grid, obs, act, nobs,
                                               torch.float32)
  assert np.abs(jgrad).max() > 0 and np.abs(pgrad).max() > 0
  if bw == 0.5:
    assert 0 < pdata.weight.item() < 1e-9
    online = torch.cat([torch.from_numpy(x) for x in (obs, act, nobs)], -1)
    logsum = torch.logsumexp(ploss._log_kernel_block(
        pdata.grid, pdata.grid_sq, online, bw), dim=-1)
    density = torch.softmax(torch.logaddexp(pdata.anchor_logsum, logsum), -1)
    assert (torch.cumsum(density, -1) == pdata.target_cdf).any()
    np.testing.assert_allclose(pvalue, jvalue, rtol=1e-4)
    np.testing.assert_allclose(pdist_, jdist_, rtol=1e-4)
    np.testing.assert_allclose(pgrad, jgrad, rtol=0,
                               atol=1e-4 * np.abs(jgrad).max())
    monkeypatch.setattr(pdist, 'jax_abs', torch.abs)
    assert np.abs(_port_penalty(sets, bw, grid, obs, act, nobs,
                                torch.float32)[2]).max() < (
                                    1e-4 * np.abs(jgrad).max())
    return
  rvalue, rdist, rgrad, _ = _port_penalty(sets, bw, grid, obs, act, nobs,
                                          torch.float64)
  for who, value, dist, grad in (('port', pvalue, pdist_, pgrad),
                                 ('jax', jvalue, jdist_, jgrad)):
    assert abs(value - rvalue) <= 2e-4 * abs(rvalue), (who, value, rvalue)
    assert abs(dist - rdist) <= 2e-4 * abs(rdist), (who, dist, rdist)
    err = np.abs(grad - rgrad).max()
    assert err <= 2e-4 * np.abs(rgrad).max(), (who, err)


def test_compute_rsr_loss_short_circuits_and_validates():
  rng = np.random.RandomState(1)
  real = torch.from_numpy(rng.randn(8, 8).astype(np.float32))
  data = prsr.build_rsr_data(real, real + 0.1, real + 0.05, bandwidth=2.0)
  obs = torch.zeros(4, 3, dtype=torch.float64)
  for past, scale in ((None, 1.0), (data, 0.0)):
    loss, dist = prsr.compute_rsr_loss(obs, obs[:, :2], obs, past,
                                       loss_scale=scale)
    assert loss.item() == 0.0 and dist.item() == 0.0
    assert loss.dtype == torch.float64
  with pytest.raises(TypeError) as pe:
    prsr.compute_rsr_loss(obs, obs[:, :2], obs, (1, 2, 3))
  with pytest.raises(TypeError) as je:
    jloss.compute_rsr_loss(jnp.zeros((4, 3)), jnp.zeros((4, 2)),
                           jnp.zeros((4, 3)), (1, 2, 3))
  assert str(pe.value) == str(je.value)
  with pytest.raises(ValueError) as pe:
    prsr.compute_rsr_loss(obs.float(), obs[:, :1].float(), obs.float(), data)
  jdata = jloss.build_rsr_data(real.numpy(), real.numpy() + 0.1,
                               real.numpy() + 0.05, bandwidth=2.0)
  with pytest.raises(ValueError) as je:
    jloss.compute_rsr_loss(jnp.zeros((4, 3)), jnp.zeros((4, 1)),
                           jnp.zeros((4, 3)), jdata)
  assert str(pe.value) == str(je.value)


def _errors(fn, *args):
  try:
    fn(*args)
  except (ValueError, FileNotFoundError) as e:
    return type(e), str(e)
  raise AssertionError(f'{fn} accepted {args!r}')


def _write(path, arr):
  np.savetxt(path, arr, delimiter=',')


def test_dataset_loader_contract_matches_jax(tmp_path):
  """tests/test_rsr_pipeline.py::test_dataset_loader_contract against the
  port: the same arrays (float32 tensors on the device asked for), and the
  same error and message for a missing file, a width mismatch and too few
  rows."""
  d = str(tmp_path)
  n, obs_dim, act_dim = 6, 23, 5
  rng = np.random.RandomState(0)
  for name, rows, width in (('real_obs.txt', n + 1, obs_dim),
                            ('real_action.txt', n, act_dim),
                            ('past_sim_obs.txt', n + 1, obs_dim),
                            ('current_sim_obs.txt', n + 1, obs_dim),
                            ('obs.txt', n + 1, obs_dim),
                            ('actions.txt', n, act_dim)):
    _write(os.path.join(d, name), rng.randn(rows, width))

  out = pdatasets.load_rsr_datasets(d, max_transitions=50, device='cpu')
  want = jdatasets.load_rsr_datasets(d, max_transitions=50)
  assert [tuple(x.shape) for x in out] == [(n, obs_dim), (n, act_dim)] + [
      (n, obs_dim)] * 3
  for p, j in zip(out, want):
    assert p.dtype == torch.float32 and p.device.type == 'cpu'
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
  short = pdatasets.load_rsr_datasets(d, max_transitions=4, device='cpu')
  assert short[0].shape == (4, obs_dim)

  os.remove(os.path.join(d, 'actions.txt'))
  err = _errors(pdatasets.load_rsr_datasets, d)
  assert err[0] is FileNotFoundError
  assert err == _errors(jdatasets.load_rsr_datasets, d)
  _write(os.path.join(d, 'actions.txt'), rng.randn(n, act_dim + 1))
  err = _errors(pdatasets.load_rsr_datasets, d)
  assert err[0] is ValueError and 'actions.txt must have 5 action' in err[1]
  assert err == _errors(jdatasets.load_rsr_datasets, d)
  _write(os.path.join(d, 'actions.txt'), rng.randn(n - 2, act_dim))
  assert _errors(pdatasets.load_rsr_datasets, d) == _errors(
      jdatasets.load_rsr_datasets, d)
  _write(os.path.join(d, 'real_obs.txt'), rng.randn(1, obs_dim))
  assert _errors(pdatasets.load_rsr_datasets, d) == _errors(
      jdatasets.load_rsr_datasets, d)


def test_txt_to_2d_array_matches_jax(tmp_path):
  path = tmp_path / 'loose.txt'
  path.write_text('1, 2 3\n\n4,5,6\n  7 8 9  \n')
  np.testing.assert_array_equal(pdatasets.txt_to_2d_array(str(path)),
                                jdatasets.txt_to_2d_array(str(path)))


def test_build_policy_rsr_data_validation_matches_jax():
  """tests/test_rsr_pipeline.py::test_build_policy_rsr_data_validation
  against the port, messages included."""
  rng = np.random.RandomState(1)
  s = rng.randn(5, 4)
  a = rng.randn(5, 2)
  data = ppipeline.build_policy_rsr_data(s, a, s + 0.1, s + 0.2, s + 0.05,
                                         device='cpu')
  assert (data.n_anchors, data.width) == (5, 10)
  assert data.anchor_logsum.shape == data.target_cdf.shape == (10,)
  assert data.grid.dtype == torch.float32
  for bad in ((s, a, s[:4] + 0.1, s + 0.2, s), (s[None], a, s, s, s),
              (s, a, s[:, :3], s, s), (s[:0], a[:0], s[:0], s[:0], s[:0])):
    err = _errors(functools.partial(ppipeline.build_policy_rsr_data,
                                    device='cpu'), *bad)
    assert err[0] is ValueError
    assert err == _errors(jpipeline.build_policy_rsr_data, *bad)
  for kw in ({'num_samples': 0}, {'bandwidth': 0.0}):
    with pytest.raises(ValueError) as pe:
      ppipeline.build_policy_rsr_data(s, a, s, s, s, device='cpu', **kw)
    with pytest.raises(ValueError) as je:
      jpipeline.build_policy_rsr_data(s, a, s, s, s, **kw)
    assert str(pe.value) == str(je.value)


def test_rsr_data_moves_between_devices_and_dtypes():
  rng = np.random.RandomState(2)
  s, a = rng.randn(5, 4), rng.randn(5, 2)
  data = ppipeline.build_policy_rsr_data(s, a, s + 0.1, s + 0.2, s + 0.05,
                                         device='cpu', bandwidth=2.0)
  d64 = data.to('cpu', torch.float64)
  assert d64.weight.dtype == d64.grid.dtype == torch.float64
  assert (d64.n_anchors, d64.width, d64.bandwidth) == (5, 10, 2.0)
  assert torch.equal(d64.grid.float(), data.grid)
  with pytest.raises(Exception):
    data.weight = data.weight  # frozen
