"""The frozen reference against the port's plain path, at a small size on
the CPU: one control step of each configuration from the same reset, and
the numpy policy against the port's served policy."""

import os

import numpy as np
import pytest
import torch

from benchmark import common
from benchmark.reference import follow
from benchmark.reference import policy as ref_policy


@pytest.mark.parametrize('name', ['cube_push', 'go2_joystick'])
def test_step_agrees_with_the_port(name):
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers

  cfg = common.load_json('configs', name)
  B = 3
  port = wrappers.wrap_for_training(
      envs.load(cfg['env'], device='cpu', **cfg['env_kwargs']),
      episode_length=cfg['episode_length'], num_envs=B)
  s = port.reset(torch.Generator().manual_seed(2))
  action = torch.rand((B, cfg['action_size']),
                      generator=torch.Generator().manual_seed(3)) * 2 - 1
  rng = follow.generator_state(s)
  _, ref32 = follow.training_stack(cfg, 'cpu', torch.float32, B)
  _, ref64 = follow.training_stack(cfg, 'cpu', torch.float64, B)
  r32 = follow.step(ref32, s, action, torch.float32, rng)
  r64 = follow.step(ref64, s, action, torch.float64, rng)
  p = port.step(s, action)
  got = follow.flat_obs(p.obs)
  # the same plain code in the same precision: the same numbers
  assert torch.equal(got, follow.flat_obs(r32.obs))
  assert torch.equal(p.reward, r32.reward)
  # float64: within fp32 rounding carried through one control step
  np.testing.assert_allclose(got.double().numpy(),
                             follow.flat_obs(r64.obs).numpy(), atol=1e-3)


def test_policy_agrees_with_the_port():
  from rsr_mjx_tpu_torch.train import networks

  path = os.path.join(common.ROOT, 'logs/cube_ppo_15M_r4/final_params.pkl')
  norm, params = ref_policy.load(path)
  obs = np.loadtxt(os.path.join(common.ROOT, 'data_rsr_demo/real_obs.txt'),
                   delimiter=',', dtype=np.float32)
  served = networks.make_policy(*networks.load_ppo_params(path), 'cpu')
  with torch.no_grad():
    got = served(torch.from_numpy(obs)).numpy()
  want = ref_policy.mode(norm, params, obs)
  np.testing.assert_allclose(got, want, atol=2e-6)
  # TF32 inputs move the action by orders of magnitude more
  tf32 = ref_policy.mode(norm, params, obs, precision='tf32')
  assert np.abs(tf32 - want).max() > 100 * np.abs(got - want).max()


def test_tf32_rounding():
  x = np.array([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0e-5],
               np.float32)
  r = common.tf32(x)
  assert r[0] == 1.0 and r[1] == 1.0  # a tie rounds to even
  assert r[2] == np.float32(1.0 + 2**-10)
  bits = r.view(np.uint32)
  assert not (bits & 0x1FFF).any()
