"""PPO training/sps with and without domain randomisation, on one card.

    python3 tests/torch_dr_ab.py

Needs an NVIDIA card (run from the repository root).  For the Go2 joystick
and then cube-push, one ``ppo.train`` step at the tuned table (as
``chip_smoke.py`` phase 4 and 9 take it) without and with the env's
randomiser, in the order plain, DR, DR, plain within one process, so that
the host's drift between runs falls on both sides alike; prints each
run's training/sps and wall time.  It is the within-one-call comparison
PERF.md's DR finding rests on.
"""

import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
  if not torch.cuda.is_available():
    raise SystemExit('torch_dr_ab: needs a CUDA card')
  print(cs.card_line(), flush=True)
  torch.backends.cuda.matmul.allow_tf32 = False
  port = cs.import_port()
  port.cuda_build.build_all(verbose=False)
  torch.set_grad_enabled(False)
  cs.import_train(port)
  for name in (cs.GO2_ENV, cs.ENV):
    for order in ('plain', 'dr', 'dr', 'plain'):
      cfg, nf, _ = cs.tuned_config(port, name, 1)
      factory = functools.partial(port.networks.make_ppo_networks, **nf)
      env0 = port.envs.load(name, device='cuda')
      rfn = port.envs.get_domain_randomizer(name) if order == 'dr' else None
      out = {}
      port.ppo.train(environment=env0, network_factory=factory,
                     seed=cs.SEED, device='cuda',
                     progress_fn=lambda step, m: out.update(m),
                     randomization_fn=rfn, **cfg)
      print(f'{name} {order}: training/sps {out["training/sps"]:.1f} '
            f'walltime {out["training/walltime"]:.3f} s', flush=True)


if __name__ == '__main__':
  main()
