"""PPO and SAC training from the command line.

Counterpart of ``scripts/train.py``: the tuned config of the env
(``configs.ppo_config`` or ``configs.sac_config``), flags given on the
command line over it, ``ppo.train`` or ``sac.train`` on one device,
``progress.json`` after every epoch, a checkpoint after every epoch (PPO:
the directory ``<logdir>/checkpoints/<step>``; SAC:
``<logdir>/checkpoints/run_sac_<step>.pkl``) and ``final_params.pkl`` at
the end.  SAC on an env with dict observations feeds the policy the
config's ``policy_obs_key`` entry (``SelectObservationWrapper``).
``--domain_randomization`` trains on the env's registered randomiser (one
randomised model per training env; the evaluator keeps the nominal model)
and refuses an env that has none.  ``--multihost`` trains on one process
per device (``scripts/train.py``'s flag; ``train.distributed``), started
by ``torchrun``; process 0 alone writes.
Rendering and experiment-logging sinks are not ported (ROADMAP items 4
and 6).

    python -m rsr_mjx_tpu_torch.train.cli --env AirbotCubePushTrain \\
        [--algorithm ppo|sac] [--domain_randomization] [--device cuda] \\
        [--logdir DIR] ...
    torchrun --nproc_per_node N -m rsr_mjx_tpu_torch.train.cli \\
        --multihost ...
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time

# flags that override the tuned value of the same name where the config
# has it, as scripts/train.py's
_INT_FLAGS = ('num_timesteps', 'num_envs', 'num_evals', 'batch_size',
              'episode_length', 'num_eval_envs', 'unroll_length',
              'num_minibatches', 'num_updates_per_batch',
              'grad_updates_per_step', 'min_replay_size', 'max_replay_size')
_FLOAT_FLAGS = ('learning_rate', 'discounting')


def parse_args(argv=None) -> argparse.Namespace:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--env', default='AirbotCubePushTrain',
                 help='registered env name')
  p.add_argument('--algorithm', default='ppo', choices=('ppo', 'sac'),
                 help='RL algorithm')
  p.add_argument('--logdir', default=None,
                 help='output directory (default: logs/<run>)')
  p.add_argument('--restore_checkpoint_path', default=None,
                 help='a checkpoint directory to start from (PPO)')
  p.add_argument('--domain_randomization', action='store_true',
                 help="train on the env's domain randomiser")
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--device', default='cuda',
                 help="device of the envs and networks ('cpu' for a run "
                      'with the kernels\' plain versions)')
  p.add_argument('--multihost', action='store_true',
                 help='one process per device under torchrun: start the '
                      'process group from its environment (NCCL on cuda, '
                      'gloo on cpu) on cuda:LOCAL_RANK; process 0 writes')
  for name in _INT_FLAGS:
    p.add_argument(f'--{name}', type=int, default=None,
                   help='override the tuned value')
  for name in _FLOAT_FLAGS:
    p.add_argument(f'--{name}', type=float, default=None,
                   help='override the tuned value')
  return p.parse_args(argv)


def main(argv=None):
  """Train as the flags say; returns (make_policy, params, metrics)."""
  args = parse_args(argv)

  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.train import checkpoint, configs, distributed
  from rsr_mjx_tpu_torch.train import networks as ppo_networks
  from rsr_mjx_tpu_torch.train import ppo, sac, sac_networks

  algo = args.algorithm
  randomization_fn = None
  if args.domain_randomization:
    randomization_fn = envs.get_domain_randomizer(args.env)
    if randomization_fn is None:
      raise ValueError(f'{args.env} has no domain randomiser; registered '
                       'ones: ' + ', '.join(
                           n for n in envs.registered_envs()
                           if envs.get_domain_randomizer(n)))
  if args.multihost:
    args.device = distributed.init(args.device)
  main_process = distributed.world()[0] == 0
  env = envs.load(args.env, device=args.device)
  eval_env = envs.load(args.env, device=args.device)
  cfg = (configs.ppo_config if algo == 'ppo' else configs.sac_config)(
      args.env)
  for key in _INT_FLAGS + _FLOAT_FLAGS:
    if getattr(args, key) is not None and key in cfg:
      cfg[key] = getattr(args, key)

  logdir = args.logdir or os.path.join(
      'logs', f'{args.env}-{algo}-{time.strftime("%Y%m%d-%H%M%S")}')
  ckpt_dir = os.path.join(logdir, 'checkpoints')
  if main_process:
    os.makedirs(ckpt_dir, exist_ok=True)
  history = []

  def progress_fn(step, metrics):
    reward = metrics.get('eval/episode_reward', float('nan'))
    print(f'step={step} reward={reward:.3f} '
          f'sps={metrics.get("training/sps", 0.0):.0f}', flush=True)
    history.append({'step': step, **{k: float(v) for k, v in
                                     metrics.items()}})
    with open(os.path.join(logdir, 'progress.json'), 'w') as f:
      json.dump(history, f, indent=1)

  def policy_params_fn(step, make_policy, params):
    checkpoint.save(os.path.join(ckpt_dir, f'{step}'), params)

  nf_cfg = dict(cfg.pop('network_factory'))
  if algo == 'ppo':
    network_factory = functools.partial(
        ppo_networks.make_ppo_networks,
        policy_obs_key=nf_cfg.pop('policy_obs_key', 'state'),
        value_obs_key=nf_cfg.pop('value_obs_key', 'state'),
        **{k: tuple(v) for k, v in nf_cfg.items()})
    make_policy, params, metrics = ppo.train(
        environment=env, eval_env=eval_env, network_factory=network_factory,
        progress_fn=progress_fn, policy_params_fn=policy_params_fn,
        restore_checkpoint_path=args.restore_checkpoint_path, seed=args.seed,
        randomization_fn=randomization_fn, device=args.device, **cfg)
    save_params = checkpoint.save_params
  else:
    obs_key = cfg.pop('policy_obs_key', 'state')
    if not isinstance(env.observation_size, int):
      env = wrappers.SelectObservationWrapper(env, obs_key)
      eval_env = wrappers.SelectObservationWrapper(eval_env, obs_key)
    network_factory = functools.partial(
        sac_networks.make_sac_networks,
        **{k: tuple(v) for k, v in nf_cfg.items()})
    make_policy, params, metrics = sac.train(
        environment=env, eval_env=eval_env, network_factory=network_factory,
        progress_fn=progress_fn,
        checkpoint_logdir=os.path.join(ckpt_dir, 'run'), seed=args.seed,
        randomization_fn=randomization_fn, device=args.device, **cfg)
    save_params = sac.save_params

  if args.multihost:
    distributed.finish()
  if main_process:
    final_path = os.path.join(logdir, 'final_params.pkl')
    save_params(final_path, params)
    print(f'training done; final params at {final_path}', flush=True)
    print(f'final metrics: {metrics}', flush=True)
  return make_policy, params, metrics


if __name__ == '__main__':
  main()
