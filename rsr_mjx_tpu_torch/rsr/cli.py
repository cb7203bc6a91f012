"""RSR policy training from the six-file real/sim dataset.

Counterpart of ``scripts/rsr_policy_training.py``: loads and validates the
dataset (``rsr.datasets.load_rsr_datasets``), loads the env and runs
``rsr.pipeline.policy_params_training`` with the RSR penalty; logs a
``step / reward / sim2real`` line and rewrites ``progress.json`` after every
evaluation, saves checkpoints under ``<logdir>/checkpoints/`` (PPO: a
directory per step; SAC: ``run_sac_<step>.pkl``), and writes
``final_params.pkl`` at the end.  The flags and defaults are the JAX
script's (``--algorithm sac`` the default), plus ``--device`` and the
sizes that a short run cuts (by default ``policy_params_training``'s), and
``--multihost`` (one process per device under ``torchrun``, as in
``train.cli``; process 0 alone writes).  An env with dict observations feeds the policy its ``state`` entry through
``SelectObservationWrapper``, for either algorithm, as the JAX script does.

    python -m rsr_mjx_tpu_torch.rsr.cli --data_dir data_rsr_demo \\
        [--algorithm sac] [--device cuda] [--logdir DIR] [--num_timesteps N]
    torchrun --nproc_per_node N -m rsr_mjx_tpu_torch.rsr.cli --multihost ...
"""

from __future__ import annotations

import argparse
import functools
import json
import os

# policy_params_training arguments that a short run cuts; None leaves its
# default
_SIZE_FLAGS = (('episode_length', int), ('num_eval_envs', int),
               ('unroll_length', int), ('num_minibatches', int),
               ('num_updates_per_batch', int), ('bandwidth', float))


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--data_dir', default='data',
                 help='directory with the six files')
  p.add_argument('--algorithm', default='sac', choices=('ppo', 'sac'),
                 help='RL algorithm')
  p.add_argument('--env', default='AirbotCubePush', help='registered env name')
  p.add_argument('--max_transitions', type=int, default=50,
                 help='transition cap')
  p.add_argument('--num_timesteps', type=int, default=500_000)
  p.add_argument('--num_evals', type=int, default=10)
  p.add_argument('--num_envs', type=int, default=512)
  p.add_argument('--batch_size', type=int, default=128)
  p.add_argument('--min_replay_size', type=int, default=10_000,
                 help='SAC replay min')
  p.add_argument('--max_replay_size', type=int, default=200_000,
                 help='SAC replay max')
  p.add_argument('--rsr_loss_scale', type=float, default=1.0,
                 help='RSR penalty scale')
  p.add_argument('--logdir', default='logs/rsr', help='output directory')
  p.add_argument('--restore_checkpoint_path', default=None,
                 help='PPO restore path')
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--device', default='cuda',
                 help="device of the envs and networks ('cpu' for a run "
                      "with the kernels' plain versions)")
  p.add_argument('--multihost', action='store_true',
                 help='one process per device under torchrun: start the '
                      'process group from its environment (NCCL on cuda, '
                      'gloo on cpu) on cuda:LOCAL_RANK; process 0 writes')
  for name, kind in _SIZE_FLAGS:
    p.add_argument(f'--{name}', type=kind, default=None,
                   help="override policy_params_training's default")
  return p.parse_args(argv)


def main(argv=None):
  """Train as the flags say; returns (make_inference_fn, params)."""
  args = parse_args(argv)

  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.rsr import datasets, pipeline
  from rsr_mjx_tpu_torch.train import checkpoint, distributed
  from rsr_mjx_tpu_torch.train import networks as ppo_networks
  from rsr_mjx_tpu_torch.train import sac, sac_networks

  if args.multihost:
    args.device = distributed.init(args.device)
  main_process = distributed.world()[0] == 0
  arrays = datasets.load_rsr_datasets(args.data_dir, args.max_transitions,
                                      device=args.device)
  print(f'RSR dataset: {arrays[0].shape[0]} transitions, obs '
        f'{arrays[0].shape[1]}, act {arrays[1].shape[1]}', flush=True)

  env = envs.load(args.env, device=args.device)
  eval_env = None
  if not isinstance(env.observation_size, int):
    # dict-observation envs (Go2): the policy reads the 'state' entry
    env = wrappers.SelectObservationWrapper(env, 'state')
    eval_env = wrappers.SelectObservationWrapper(
        envs.load(args.env, device=args.device), 'state')
  ckpt_dir = os.path.join(args.logdir, 'checkpoints')
  if main_process:
    os.makedirs(ckpt_dir, exist_ok=True)
  progress_rows = []
  progress_path = os.path.join(args.logdir, 'progress.json')

  def progress_fn(step, metrics):
    print(f'step={step} '
          f'reward={metrics.get("eval/episode_reward", float("nan")):.3f} '
          f'sim2real={metrics.get("training/sim2real_loss", float("nan")):.5f}',
          flush=True)
    progress_rows.append({'step': int(step),
                          **{k: float(v) for k, v in metrics.items()
                             if isinstance(v, (int, float))}})
    with open(progress_path, 'w') as f:
      json.dump(progress_rows, f, indent=1)

  def policy_params_fn(step, make_policy, params):
    checkpoint.save(os.path.join(ckpt_dir, f'{step}'), params)

  # the reference's 32 x 4 networks (rsr_policy_training.py:260-270)
  ppo_run = args.algorithm == 'ppo'
  if ppo_run:
    network_factory = functools.partial(
        ppo_networks.make_ppo_networks,
        policy_hidden_layer_sizes=(32, 32, 32, 32),
        value_hidden_layer_sizes=(32, 32, 32, 32),
    )
  else:
    network_factory = functools.partial(
        sac_networks.make_sac_networks, hidden_layer_sizes=(32, 32, 32, 32))
  sizes = {name: getattr(args, name) for name, _ in _SIZE_FLAGS
           if getattr(args, name) is not None}
  make_inference_fn, params = pipeline.policy_params_training(
      env=env,
      algorithm=args.algorithm,
      past_states=arrays[0],
      past_actions=arrays[1],
      past_next_states_real=arrays[2],
      past_next_states_sim=arrays[3],
      current_next_states_sim=arrays[4],
      rsr_loss_scale=args.rsr_loss_scale,
      num_timesteps=args.num_timesteps,
      num_evals=args.num_evals,
      num_envs=args.num_envs,
      batch_size=args.batch_size,
      min_replay_size=args.min_replay_size,
      max_replay_size=args.max_replay_size,
      network_factory=network_factory,
      progress_fn=progress_fn,
      policy_params_fn=policy_params_fn if ppo_run else None,
      checkpoint_logdir=None if ppo_run else os.path.join(ckpt_dir, 'run'),
      restore_checkpoint_path=args.restore_checkpoint_path,
      eval_env=eval_env,
      seed=args.seed,
      device=args.device,
      **sizes,
  )
  if args.multihost:
    distributed.finish()
  if main_process:
    save = checkpoint.save_params if ppo_run else sac.save_params
    save(os.path.join(args.logdir, 'final_params.pkl'), params)
    print(f'done; params in {args.logdir}', flush=True)
  return make_inference_fn, params


if __name__ == '__main__':
  main()
