"""Airbot T-push in the port against the JAX package.

1. The tuned PPO and SAC tables, and no randomiser (the model, its
   snapshot and its layout, nv 14, 720 slots, 32 selected, 223 rows, are
   held in tests/test_torch_model.py with the cube-push models).
2. The slice: a JAX reset of the wrapped ``AirbotTPush`` env is handed to
   the port's wrapped env (obs within 1e-5: kinematics only), then both run
   3 control steps of one deterministic policy, a PPO network at the Airbot
   widths (16 → 32×4 → 10) initialised from a seed and carried to the JAX
   package through the params pickle.  The JAX Pallas kernels run in
   interpret mode, the port's kernels as their plain versions.  obs, the
   reward terms, ``xita``, ``new_T_pos`` and done agree within the repo's
   post-solve tolerance 1e-2 (tests/test_fwd_fused.py).  The reset is that
   of PRNGKey(4) split 3 ways, a mild regime: there the two packages'
   obs agree to 3e-7 after each of the 3 steps (the block of env 0 rests
   on the table, the other two fall onto it).  Not every reset is as mild:
   from PRNGKey(0), whose env 0 starts with the block pressed into the
   table, the JAX package's fp32 obs part from the port's by 4.2e-5 after
   3 steps while the port's fp32 stays within 1.2e-5 of its float64
   (tests/torch_tpush_parting.py prints both keys).
3. The kernels on the inputs of that slice's first substep: K2's plain
   version, 720 slots → 32 (past the CUDA kernel's 512-slot register path),
   exactly equal to the JAX kernel in interpret mode; K3's plain version at
   nv 14, 223 rows, 3 friction axes, and the JAX kernel alike, φ within
   1e-6·φ(x0) of the float64 solve's, as tests/test_torch_kernels.py holds
   them at nv 20.
"""

import jax
import numpy as np
import pytest
import torch

from rsr_mjx_tpu import envs as jenvs
from rsr_mjx_tpu.envs import wrappers as jwrappers
from rsr_mjx_tpu.physics import fwd_fused as jFF
from rsr_mjx_tpu.physics import linalg_kernels as jlk
from rsr_mjx_tpu.train import configs as jconfigs
from rsr_mjx_tpu.train import networks as jnets
from rsr_mjx_tpu.train import ppo as jppo
from rsr_mjx_tpu.train import running_statistics as jrs
from rsr_mjx_tpu.train import sac as jsac
from rsr_mjx_tpu_torch import envs as penvs
from rsr_mjx_tpu_torch.envs import wrappers as pwrappers
from rsr_mjx_tpu_torch.physics import linalg_kernels as plk
from rsr_mjx_tpu_torch.train import checkpoint
from rsr_mjx_tpu_torch.train import configs as pconfigs
from rsr_mjx_tpu_torch.train import networks as pnets
from rsr_mjx_tpu_torch.train import running_statistics as prs
from torch_testing import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

ENV = 'AirbotTPush'
B = 3
STEPS = 3
NSEL, NAXES = 32, 3
RESET_KEY = 4


def test_tuned_tables_match_jax():
  for fn in ('ppo_config', 'sac_config'):
    jcfg = getattr(jconfigs, fn)(ENV).to_dict()
    jcfg['network_factory'] = {
        k: list(v) if isinstance(v, tuple) else v
        for k, v in jcfg['network_factory'].items()}
    assert getattr(pconfigs, fn)(ENV) == jcfg, fn
  assert penvs.get_domain_randomizer(ENV) is None
  assert jenvs.get_domain_randomizer(ENV) is None


def _policy_params(path):
  """A PPO network at the Airbot widths, initialised from a seed, saved as
  the trainer saves ``final_params.pkl``; the normalizer holds a few
  observations so that normalisation is not the identity."""
  nf = pconfigs.ppo_config(ENV)['network_factory']
  net = pnets.make_ppo_networks(
      16, 5, policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes))
  net.init(torch.Generator().manual_seed(7))
  obs = torch.from_numpy(np.random.default_rng(7).normal(
      size=(64, 16)).astype(np.float32))
  normalizer = prs.update(prs.init_state(16, 'cpu'), obs)
  checkpoint.save_params(path, (normalizer, net))
  return path


@pytest.fixture(scope='module')
def slice_run(tmp_path_factory):
  """Both packages' 3 control steps from the same reset, and the inputs
  the port's first substep gave K2 and K3 (the block of env 0 in contact,
  8 slots of 720 penetrating)."""
  path = _policy_params(str(tmp_path_factory.mktemp('tpush') / 'p.pkl'))
  jparams = jsac.load_params(path)
  nf = jconfigs.ppo_config(ENV)['network_factory']
  jnet = jnets.make_ppo_networks(
      16, 5, policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes))
  jpol = jppo._make_policy_factory(jnet, jrs.normalize)(
      jparams, deterministic=True)
  jpolicy = jax.jit(lambda obs: jpol(obs, jax.random.PRNGKey(0))[0])
  ppolicy = pnets.make_policy(*pnets.load_ppo_params(path), device='cpu')

  jenv = jwrappers.wrap_for_training(jenvs.load(ENV), episode_length=1200)
  jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(RESET_KEY), B))
  base = penvs.load(ENV, device='cpu')
  d = jstate.data
  init = tuple(torch.from_numpy(np.array(x)) for x in (d.qpos, d.qvel, d.ctrl))
  recorded = {}

  def record(name, fn):
    def wrapped(*args):
      recorded.setdefault(name, tuple(
          a.clone() if torch.is_tensor(a) else a for a in args))
      return fn(*args)
    return wrapped

  out = {'obs0': (np.asarray(jstate.obs), None), 'steps': []}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(base, 'sample_init', lambda generator, batch: init)
    penv = pwrappers.wrap_for_training(base, episode_length=1200, num_envs=B)
    pstate = penv.reset(torch.Generator().manual_seed(0))
    out['obs0'] = (out['obs0'][0], pstate.obs.numpy())
    mp.setattr(plk, 'contact_select_lanes',
               record('k2', plk.contact_select_lanes))
    mp.setattr(plk, 'newton_lanes_pyr_t', record('k3', plk.newton_lanes_pyr_t))
    mp.setattr(jlk, '_INTERPRET', True)
    jFF._CACHE.clear()
    try:
      jstep = jax.jit(jenv.step)
      for _ in range(STEPS):
        jstate = jstep(jstate, jpolicy(jstate.obs))
        with torch.no_grad():
          pstate = penv.step(pstate, ppolicy(pstate.obs))
        out['steps'].append((jax.tree.map(np.asarray, jstate), pstate))
    finally:
      jFF._CACHE.clear()
  out['recorded'] = recorded
  return out


def test_slice_matches_jax(slice_run):
  jobs0, pobs0 = slice_run['obs0']
  assert pobs0.shape == (B, 16)
  np.testing.assert_allclose(pobs0, jobs0, rtol=1e-5, atol=1e-5)
  close = lambda p, j, what: np.testing.assert_allclose(
      p.numpy(), np.asarray(j), rtol=1e-2, atol=1e-2, err_msg=what)
  for js, ps in slice_run['steps']:
    close(ps.obs, js.obs, 'obs')
    close(ps.reward, js.reward, 'reward')
    for k in ('push_reward', 'siet2cube_reward', 'health_reward',
              'site_z_reward'):
      close(ps.metrics[k], js.metrics[k], k)
    for k in ('xita', 'new_T_pos', 'T_pos', 'site_pos'):
      close(ps.info[k], js.info[k], k)
    np.testing.assert_array_equal(ps.done.numpy(), np.asarray(js.done))
  # the policy moved the arm and the reward terms are live
  assert np.abs(pobs0 - slice_run['steps'][-1][1].obs.numpy()).max() > 1e-4
  assert (slice_run['steps'][-1][1].metrics['push_reward'] > 0).all()
  assert slice_run['steps'][-1][1].info['steps'].tolist() == [STEPS] * B


def test_contact_select_720_slots_matches_jax_exactly(slice_run, monkeypatch):
  """K2 at T-push's size on the port's first-substep inputs: 45 pairs ×
  16 slots, 32 picks, the pair table's 13 + 14 columns."""
  monkeypatch.setattr(jlk, '_INTERPRET', True)
  pair_struct, nsel, dist, feat, table = slice_run['recorded']['k2']
  assert pair_struct == ((45, 16, 0),) and nsel == NSEL
  assert tuple(dist.shape) == (720, B) and tuple(table.shape) == (45, 27)
  assert (dist < 0).any()  # the block rests on the table
  sj = np.asarray(jlk.contact_select_lanes(
      pair_struct, nsel, dist.numpy(), feat.numpy(), table.numpy()))
  sp, picks = plk.contact_select_lanes(pair_struct, nsel, dist, feat, table)
  assert sp.shape == (NSEL, 13 + 27, B)
  np.testing.assert_array_equal(sp.numpy(), sj)
  _, top = jax.lax.top_k(-(dist.numpy().T + 0.0), NSEL)
  np.testing.assert_array_equal(picks.numpy(), np.asarray(top).T)


def _phi(a64, x, kind_s):
  """The objective K3 minimises, per env, in float64: ½(x−a0)ᵀM(x−a0) plus
  the structured rows' penalties and the contact pyramid's."""
  Mt, a0t, _, Js, arefs, Ds, fls, U, arefU, Dc = a64
  ones_m, fric_m = plk._row_masks(tuple(kind_s.tolist()), x.device,
                                  torch.float64)
  xa = x - a0t
  phi = 0.5 * (xa * (Mt * xa[None]).sum(1)).sum(0)
  rs = (Js * x[:, None]).sum(0) - arefs
  phi = phi + plk._penalty_cost_rows(rs, Ds, fls, ones_m[:, None],
                                     fric_m[:, None]).sum(0)
  rU = (U * x[:, None]).sum(0) - arefU
  for i in range(NAXES):
    ri = rU[(1 + i) * NSEL:(2 + i) * NSEL]
    for r in (rU[:NSEL] + ri, rU[:NSEL] - ri):
      phi = phi + (0.5 * Dc * r * r * (r < 0)).sum(0)
  return phi


def test_newton_pyr_nv14_matches_jax(slice_run, monkeypatch):
  """K3 at T-push's shapes (nv 14, 31 structured rows + 32 contacts × 3
  axes × 2 = 223 rows) on the port's first-substep inputs, 6 × 6: the
  port's plain version and the JAX kernel in interpret mode each reach φ
  within 1e-6·φ(x0) of the float64 plain solve's, env by env."""
  monkeypatch.setattr(jlk, '_INTERPRET', True)
  args = slice_run['recorded']['k3']
  iters, ls, kind_s = args[:3]
  tensors, naxes = args[3:13], args[13]
  assert (iters, ls, naxes, len(kind_s)) == (6, 6, NAXES, 31)
  Mt, U = tensors[0], tensors[7]
  assert tuple(Mt.shape) == (14, 14, B)
  assert U.shape[1] == (NAXES + 1) * NSEL
  assert (tensors[9] > 0).any()  # some contacts are active
  outp = plk.newton_lanes_pyr_t(iters, ls, kind_s, *tensors, naxes)
  outj = jlk.newton_lanes_pyr_t(iters, ls, np.asarray(kind_s),
                                *(t.numpy() for t in tensors), naxes)
  a64 = [t.double() for t in tensors]
  x64 = plk.newton_pyr_plain(iters, ls, kind_s, *a64, naxes)[0]
  tol = 1e-6 * _phi(a64, a64[2], np.asarray(kind_s))
  phi64 = _phi(a64, x64, np.asarray(kind_s))
  for who, outs in (('port', outp), ('jax', outj)):
    x = torch.from_numpy(np.array(outs[0])).double()
    assert x.shape == (14, B) and torch.isfinite(x).all(), who
    assert np.asarray(outs[1]).shape == (223, B), who
    ratio = ((_phi(a64, x, np.asarray(kind_s)) - phi64).abs() / tol).max()
    assert ratio <= 1.0, (who, ratio.item())
