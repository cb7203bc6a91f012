"""PPO and SAC training from the command line.

Counterpart of ``scripts/train.py``: the tuned config of the env
(``configs.ppo_config`` or ``configs.sac_config``), flags given on the
command line over it, ``ppo.train`` or ``sac.train`` on one device,
``progress.json`` after every epoch, a checkpoint after every epoch (PPO:
the directory ``<logdir>/checkpoints/<step>``; SAC:
``<logdir>/checkpoints/run_sac_<step>.pkl``) and ``final_params.pkl`` at
the end, with ``tracing.json``: the run's host time by span and its
counters (``utils.tracing.snapshot``).  SAC on an env with dict
observations feeds the policy the config's ``policy_obs_key`` entry
(``SelectObservationWrapper``).
``--domain_randomization`` trains on the env's registered randomiser (one
randomised model per training env; the evaluator keeps the nominal model)
and refuses an env that has none.  ``--multihost`` trains on one process
per device (``scripts/train.py``'s flag; ``train.distributed``), started
by ``torchrun``; process 0 alone writes.  ``--use_tb`` logs every
metric to TensorBoard under ``<logdir>/tb`` (tensorboardX), ``--use_wandb``
to Weights & Biases; either warns and trains on where its package is
missing.  ``progress.png``, the evaluation reward against env-steps, is
drawn once there are two evaluations, where matplotlib imports.
``--render`` rolls the trained policy out deterministically for
``--render_steps`` control steps on the device and renders it to
``<logdir>/rollout.mp4`` (``utils.rendering``); it needs ``mujoco`` and a
GL backend, checked before training starts.

    python -m rsr_mjx_tpu_torch.train.cli --env AirbotCubePushTrain \\
        [--algorithm ppo|sac] [--domain_randomization] [--device cuda] \\
        [--logdir DIR] [--use_tb] [--use_wandb] [--render] ...
    torchrun --nproc_per_node N -m rsr_mjx_tpu_torch.train.cli \\
        --multihost ...
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import time
import warnings

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
  p.add_argument('--render', action='store_true',
                 help='after training, render a deterministic rollout to '
                      '<logdir>/rollout.mp4 (needs mujoco and a GL backend)')
  p.add_argument('--render_steps', type=int, default=300,
                 help='control steps of the --render rollout')
  p.add_argument('--use_wandb', action='store_true',
                 help='log metrics to Weights & Biases where installed')
  p.add_argument('--use_tb', action='store_true',
                 help='log metrics to TensorBoard (tensorboardX) under '
                      '<logdir>/tb where installed')
  for name in _INT_FLAGS:
    p.add_argument(f'--{name}', type=int, default=None,
                   help='override the tuned value')
  for name in _FLOAT_FLAGS:
    p.add_argument(f'--{name}', type=float, default=None,
                   help='override the tuned value')
  return p.parse_args(argv)


def plot_progress(history, path: str, title: str) -> bool:
  """The evaluation reward (± its std) against env-steps, saved to
  ``path``; False where there are fewer than two evaluations or no
  matplotlib."""
  rows = [h for h in history if 'eval/episode_reward' in h]
  if len(rows) < 2:
    return False
  try:
    import matplotlib
  except ImportError:
    return False
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt

  fig, ax = plt.subplots(figsize=(7, 4))
  ax.errorbar([h['step'] for h in rows],
              [h['eval/episode_reward'] for h in rows],
              yerr=[h.get('eval/episode_reward_std', 0.0) for h in rows],
              capsize=2)
  ax.set_xlabel('environment steps')
  ax.set_ylabel('eval/episode_reward')
  ax.set_title(title)
  fig.tight_layout()
  fig.savefig(path, dpi=110)
  plt.close(fig)
  return True


def _sinks(args, logdir: str, config: dict):
  """(wandb run, tensorboardX writer), each None unless asked for and
  installed; a missing package warns."""
  wandb_run = tb_writer = None
  if args.use_wandb:
    try:
      import wandb
    except ImportError:
      warnings.warn('wandb not installed; skipping --use_wandb')
    else:
      wandb_run = wandb.init(project='rsr_mjx_tpu',
                             name=os.path.basename(logdir), config=config)
  if args.use_tb:
    try:
      from tensorboardX import SummaryWriter
    except ImportError:
      warnings.warn('tensorboardX not installed; skipping --use_tb')
    else:
      tb_writer = SummaryWriter(os.path.join(logdir, 'tb'))
  return wandb_run, tb_writer


def render(args, make_policy, params, policy_obs_key: str, logdir: str):
  """A deterministic rollout of the trained policy, rendered to
  ``<logdir>/rollout.mp4``; returns the path written."""
  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.utils import rendering

  video_env = envs.load(args.env, device=args.device)
  if args.algorithm == 'sac' and not isinstance(video_env.observation_size,
                                                int):
    # SAC trained on one entry of the dict observation: feed it the same
    video_env = wrappers.SelectObservationWrapper(video_env, policy_obs_key)
  frames = rendering.render_env_rollout(
      video_env, make_policy(params, deterministic=True),
      n_steps=args.render_steps, seed=args.seed, device=args.device)
  return rendering.save_video(frames, os.path.join(logdir, 'rollout.mp4'),
                              fps=1.0 / video_env.ctrl_dt)


def main(argv=None):
  """Train as the flags say; returns (make_policy, params, metrics)."""
  args = parse_args(argv)
  if args.render:
    # fail now, not after training: the renderer needs mujoco
    import mujoco  # noqa: F401

  from rsr_mjx_tpu_torch import envs
  from rsr_mjx_tpu_torch.envs import wrappers
  from rsr_mjx_tpu_torch.train import checkpoint, configs, distributed
  from rsr_mjx_tpu_torch.train import networks as ppo_networks
  from rsr_mjx_tpu_torch.train import ppo, sac, sac_networks
  from rsr_mjx_tpu_torch.utils import tracing

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
  wandb_run = tb_writer = None
  if main_process:
    os.makedirs(ckpt_dir, exist_ok=True)
    wandb_run, tb_writer = _sinks(
        args, logdir, dict(cfg, env=args.env, algorithm=algo))
  history = []

  def progress_fn(step, metrics):
    reward = metrics.get('eval/episode_reward', float('nan'))
    print(f'step={step} reward={reward:.3f} '
          f'sps={metrics.get("training/sps", 0.0):.0f}', flush=True)
    scalars = {k: float(v) for k, v in metrics.items()}
    history.append({'step': step, **scalars})
    with open(os.path.join(logdir, 'progress.json'), 'w') as f:
      json.dump(history, f, indent=1)
    if wandb_run is not None:
      wandb_run.log(scalars, step=step)
    if tb_writer is not None:
      for k, v in scalars.items():
        tb_writer.add_scalar(k, v, step)
    plot_progress(history, os.path.join(logdir, 'progress.png'),
                  f'{args.env} ({algo})')

  def policy_params_fn(step, make_policy, params):
    checkpoint.save(os.path.join(ckpt_dir, f'{step}'), params)

  nf_cfg = dict(cfg.pop('network_factory'))
  obs_key = cfg.pop('policy_obs_key', 'state')
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
    with open(os.path.join(logdir, 'tracing.json'), 'w') as f:
      json.dump(tracing.snapshot(), f, indent=1)
    print(f'training done; final params at {final_path}', flush=True)
    print(f'final metrics: {metrics}', flush=True)
    if wandb_run is not None:
      wandb_run.finish()
    if tb_writer is not None:
      tb_writer.close()
    if args.render:
      print(f'rollout video at '
            f'{render(args, make_policy, params, obs_key, logdir)}',
            flush=True)
  return make_policy, params, metrics


if __name__ == '__main__':
  main()
