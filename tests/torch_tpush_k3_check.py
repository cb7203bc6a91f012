"""K3's φ criterion on T-push's first control step, old rule and new.

    python3 tests/torch_tpush_k3_check.py

Needs an NVIDIA card (run from the repository root).  Records K3's inputs
of the last substep of one control step of ``chip_smoke.py``'s T-push path
(B 2048, the seeded policy) and prints, over envs, the worst
(φ(x) − φ(x64)) / (tol·φ(x0)) after the full 6 × 6 schedule for the kernel,
the plain fp32 version on the card and the plain fp32 version on the CPU,
x64 being the plain version's result in float64: with tol 1e-6 in every
env (the earlier rule), and with tol 1e-5 in the envs whose float64
solve is done after its first Newton step (φ within 1e-7·φ(x0) of the full
schedule's; ``chip_smoke.k3_ratios``).  Also the number of such envs and
the float64 φ gap between 6 × 6 and 20 × 20 (whether x64 is converged).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
  if not torch.cuda.is_available():
    raise SystemExit('torch_tpush_k3_check: needs a CUDA card')
  print(cs.card_line(), flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  port = cs.import_port()
  port.cuda_build.build_all(verbose=False)
  torch.set_grad_enabled(False)
  cs.import_train(port)
  lk = port.lk
  env0 = port.envs.load(cs.TPUSH_ENV, device='cuda')
  env = port.wrappers.wrap_for_training(env0, episode_length=1200,
                                        num_envs=cs.ENVS)
  policy = cs.tpush_policy(torch, port, 'cuda')
  state = env.reset(torch.Generator(device='cuda').manual_seed(cs.SEED))
  args = cs.record_calls(lk, lambda: env.step(state, policy(state.obs)))[
      'newton_lanes_pyr_t'][-1]
  a64 = [a.double() if torch.is_tensor(a) else a for a in args]
  phi = lambda x: cs.k3_cost(torch, lk, args, x.cuda())
  phi0 = phi(args[5])
  phi64 = phi(lk.newton_pyr_plain(*a64)[0])
  phi64_1 = phi(lk.newton_pyr_plain(1, *a64[1:])[0])
  phi64_20 = phi(lk.newton_pyr_plain(20, 20, *a64[2:])[0])
  done1 = phi64_1 - phi64 <= 1e-7 * phi0
  cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
  xs = {'kernel': lk.newton_lanes_pyr_t(*args)[0],
        'plain fp32, card': lk.newton_pyr_plain(*args)[0],
        'plain fp32, CPU': lk.newton_pyr_plain(*cpu)[0]}
  print(f'T-push K3, B {phi0.shape[0]}: envs whose float64 solve is done '
        f'after one Newton step {int(done1.sum().item())}; float64 phi, '
        f'6 x 6 against 20 x 20, worst gap / phi(x0) '
        f'{((phi64 - phi64_20) / phi0).abs().max().item():.3g}', flush=True)
  for who, x in xs.items():
    gap = phi(x) - phi64
    old = (gap / (1e-6 * phi0)).max().item()
    new = (gap / (torch.where(done1, 1e-5, 1e-6) * phi0)).max().item()
    print(f'  {who}: worst error/tolerance, 1e-6 everywhere {old:.3g}; '
          f'1e-5 where float64 is done after one step {new:.3g}',
          flush=True)


if __name__ == '__main__':
  main()
