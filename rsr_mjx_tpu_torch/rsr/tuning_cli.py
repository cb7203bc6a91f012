"""Physics-parameter tuning from real trajectories (the Airbot cube's
friction).

Counterpart of ``scripts/rsr_env_params_tuning.py``: loads the real obs and
action tables, takes ``--num_transitions`` consecutive transitions from
``--start``, and runs Adam on the cube's friction through the
differentiable physics step (``rsr.pipeline.env_params_tuning``).  The
flags and defaults are the JAX script's, plus ``--device``; it writes the
same ``tuned_params.json`` keys, appends the same line per step to
``--log_path`` and prints the result.

    python -m rsr_mjx_tpu_torch.rsr.tuning_cli --obs \\
        data_rsr_demo/real_obs.txt --actions data_rsr_demo/real_action.txt \\
        --num_transitions 30 --start 15 [--device cuda] [--num_steps N] ...
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--obs', default='real_obs.txt',
                 help='real observation table')
  p.add_argument('--actions', default='real_action.txt',
                 help='real action table')
  p.add_argument('--env', default='AirbotCubePush', help='registered env name')
  p.add_argument('--num_transitions', type=int, default=15,
                 help='consecutive transitions to fit (reference: 15)')
  p.add_argument('--start', type=int, default=0,
                 help='first transition index')
  p.add_argument('--num_steps', type=int, default=1000,
                 help='Adam steps (reference: 1000)')
  p.add_argument('--init_friction', type=float, default=0.4,
                 help='initial friction value')
  p.add_argument('--min_scale', type=float, default=0.2,
                 help='lower bound scale (min = init*scale)')
  p.add_argument('--max_scale', type=float, default=10.0,
                 help='upper bound scale')
  p.add_argument('--log_path', default='log.txt', help='per-step log file')
  p.add_argument('--out', default='tuned_params.json', help='result file')
  p.add_argument('--rollout_horizon', type=int, default=1,
                 help='k-step rollout loss (1 = the reference one-step '
                      'objective)')
  p.add_argument('--per_dim_error', action=argparse.BooleanOptionalAction,
                 default=False,
                 help='per-dimension |w_d err_d| error instead of the '
                      'scalar |w . err| projection')
  p.add_argument('--estimate_init_qvel',
                 action=argparse.BooleanOptionalAction, default=False,
                 help='start velocities from finite differences of '
                      'consecutive obs rows')
  p.add_argument('--lr', type=float, default=0.005,
                 help='Adam learning rate (reference: 0.005)')
  p.add_argument('--device', default='cuda',
                 help="device of the env ('cpu' for a run with the "
                      "kernels' plain versions)")
  return p.parse_args(argv)


def main(argv=None) -> dict:
  args = parse_args(argv)
  import torch

  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.rsr import datasets, pipeline

  obs = datasets.txt_to_2d_array(args.obs)
  actions = datasets.txt_to_2d_array(args.actions)
  n, s = args.num_transitions, args.start
  if len(obs) < s + n + 1 or len(actions) < s + n:
    raise ValueError(
        f'need {s + n + 1} obs rows and {s + n} action rows, have '
        f'{len(obs)}/{len(actions)}')
  env = envs.load(args.env, device=args.device)
  init = torch.tensor(args.init_friction, dtype=torch.float32)
  tuned, train_log = pipeline.env_params_tuning(
      env,
      num_steps=args.num_steps,
      init_env_params=init,
      env_params_min=init * args.min_scale,
      env_params_max=init * args.max_scale,
      obs=obs[s : s + n],
      actions=actions[s : s + n],
      next_obs_true=obs[s + 1 : s + n + 1],
      log_path=args.log_path,
      learning_rate=args.lr,
      rollout_horizon=args.rollout_horizon,
      per_dim_error=args.per_dim_error,
      estimate_init_qvel=args.estimate_init_qvel,
      device=args.device,
  )
  result = {
      'tuned_friction': float(tuned),
      'final_loss': train_log['loss'][-1],
      'num_steps': args.num_steps,
      'rollout_horizon': args.rollout_horizon,
      'per_dim_error': args.per_dim_error,
      'estimate_init_qvel': args.estimate_init_qvel,
  }
  with open(args.out, 'w') as f:
    json.dump(result, f, indent=1)
  print(f'tuned friction: {result}', flush=True)
  return result


if __name__ == '__main__':
  main()
