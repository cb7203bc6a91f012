"""PPO trainer, on one device or one process per device.

Counterpart of ``rsr_mjx_tpu/train/ppo.py`` with the same argument surface
and loop arithmetic: rollouts of the stochastic policy through the wrapped
env (the fused physics step and its kernels), the observation normalizer
updated on every rollout observation, then ``num_updates_per_batch``
passes over a permutation of the sequences in ``num_minibatches`` Adam
steps on the PPO loss, its gradient clipped to ``max_grad_norm`` as
``optax.clip_by_global_norm`` does.

Rollouts run under ``torch.no_grad()`` and the SGD under
``torch.enable_grad()``, so training works whatever the caller's grad
mode; the physics never sees a tensor that requires grad.  The random
draws come from ``torch.Generator``s seeded from ``seed``: the networks'
initialisation on the CPU (the same on every device), the env reset, the
rollout noise, the permutations and entropy draws, and the evaluation,
each its own stream on ``device``.  ``past_data`` (an ``rsr.RSRData``)
puts the RSR penalty, times ``rsr_loss_scale``, into every minibatch's
loss.  ``randomization_fn`` (``envs.get_domain_randomizer``) gives the
training envs one randomised model each, drawn once from the env stream
before the reset (JAX: ``rando_key, key_env = split(key_env)``); the
evaluator's envs keep the nominal model, as in JAX.

Under a ``torch.distributed`` process group (``distributed``) each of the
``world`` processes steps ``num_envs // world`` envs, their resets and
action noise rows of the whole batch's draws (the same whatever the
number of processes), and runs the SGD on its own rollouts: the gradient
is averaged over the processes before the clip and the Adam step, the
normalizer's sums are summed, the loss metrics averaged; the permutation
and entropy streams are the process's own.  The env steps count all
processes.  Process 0 alone evaluates and calls ``progress_fn`` and
``policy_params_fn``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Callable, Optional, Sequence

import torch

from rsr_mjx_tpu_torch.envs import wrappers
from rsr_mjx_tpu_torch.envs.core import Env
from rsr_mjx_tpu_torch.envs.wrappers import tree_map
from rsr_mjx_tpu_torch.train import acting
from rsr_mjx_tpu_torch.train import checkpoint as _checkpoint
from rsr_mjx_tpu_torch.train import distributed
from rsr_mjx_tpu_torch.train import losses as ppo_losses
from rsr_mjx_tpu_torch.train import networks as ppo_networks
from rsr_mjx_tpu_torch.train import running_statistics
from rsr_mjx_tpu_torch.utils import tracing


@dataclasses.dataclass
class TrainingState:
  """The Adam optimizer (with its state), the networks it updates, the
  normalizer and the env steps taken."""

  optimizer: torch.optim.Optimizer
  params: ppo_networks.PPONetworks
  normalizer_params: running_statistics.RunningStatisticsState
  env_steps: int


def clip_by_global_norm_(grads, max_norm: float) -> None:
  """``optax.clip_by_global_norm`` in place: where the global norm ‖g‖ is
  not below ``max_norm``, each g becomes (g / ‖g‖)·max_norm
  (``torch.nn.utils.clip_grad_norm_`` divides by ‖g‖ + 1e-6 instead)."""
  norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
  for g in grads:
    g.copy_(torch.where(norm < max_norm, g, (g / norm) * max_norm))


def make_optimizer(params, learning_rate: float) -> torch.optim.Adam:
  """Adam as ``optax.adam``: betas (0.9, 0.999), eps 1e-8 outside the
  square root."""
  return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                          eps=1e-8)


def minibatch_step(networks, optimizer, normalizer_params, data,
                   entropy_noise, loss_kwargs, max_grad_norm):
  """One SGD step on a [B, T] minibatch: the PPO loss and its gradient,
  its mean over the processes (``distributed``), the clip, one Adam step.
  Returns the loss metrics; the clipped gradients stay in each
  parameter's ``.grad``.  Span ``ppo.minibatch_step``: the host's time,
  the device's work not waited for."""
  with tracing.span('ppo.minibatch_step'):
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
      loss, metrics = ppo_losses.compute_ppo_loss(
          networks, normalizer_params, data, entropy_noise, **loss_kwargs)
      loss.backward()
    distributed.mean_grads_([p.grad for p in networks.parameters()])
    if max_grad_norm is not None:
      with torch.no_grad():
        clip_by_global_norm_([p.grad for p in networks.parameters()],
                             max_grad_norm)
    optimizer.step()
    return metrics


def permutation(n: int, generator: torch.Generator) -> torch.Tensor:
  """A random permutation of range(n) on the generator's device."""
  return torch.randperm(n, generator=generator, device=generator.device)


def randomization_bound(randomization_fn: Optional[Callable],
                        generator: torch.Generator, num_envs: int):
  """``randomization_fn(model, generator, batch_size)`` with the trainer's
  env generator and batch size bound, for ``wrap_for_training`` (None
  stays None)."""
  if randomization_fn is None:
    return None
  return functools.partial(randomization_fn, generator=generator,
                           batch_size=num_envs)


def _generators(seed: int, devices, own: Sequence[int] = ()):
  """One generator on each of ``devices``, their seeds drawn from
  ``seed``; those at the indices ``own`` are the process's own: their
  seeds are offset by its rank (JAX: ``fold_in(local_key, process_id)``)."""
  base = torch.Generator().manual_seed(seed)
  seeds = torch.randint(0, 2**62, (len(devices),), generator=base).tolist()
  rank = distributed.world()[0]
  return [torch.Generator(device=d).manual_seed(s + (rank if i in own else 0))
          for i, (d, s) in enumerate(zip(devices, seeds))]


def local_envs(num_envs: int) -> int:
  """This process's share of ``num_envs`` (all of them without a process
  group); ``num_envs`` must divide evenly."""
  world = distributed.world()[1]
  if num_envs % world:
    raise ValueError(f'num_envs ({num_envs}) is no multiple of the '
                     f'{world} processes')
  return num_envs // world


def _sync(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def train(
    environment: Env,
    num_timesteps: int,
    episode_length: int,
    action_repeat: int = 1,
    num_envs: int = 1,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    seed: int = 0,
    unroll_length: int = 10,
    batch_size: int = 32,
    num_minibatches: int = 16,
    num_updates_per_batch: int = 2,
    num_evals: int = 1,
    normalize_observations: bool = False,
    reward_scaling: float = 1.0,
    clipping_epsilon: float = 0.3,
    gae_lambda: float = 0.95,
    deterministic_eval: bool = False,
    network_factory: Callable[..., ppo_networks.PPONetworks] = (
        ppo_networks.make_ppo_networks),
    progress_fn: Callable[[int, dict], None] = lambda *args: None,
    policy_params_fn: Callable[..., None] = lambda *args: None,
    normalize_advantage: bool = True,
    eval_env: Optional[Env] = None,
    restore_checkpoint_path: Optional[str] = None,
    randomization_fn: Optional[Callable] = None,
    past_data: Any = None,
    rsr_loss_scale: float = 1.0,
    max_grad_norm: Optional[float] = None,
    device='cuda',
):
  """Train a PPO policy.  Returns (make_policy, (normalizer, networks),
  metrics), as the JAX ``train``; ``environment`` must live on
  ``device``, this process's device under a process group.  Span
  ``ppo.setup``: from the entry to the evaluator's build (networks,
  restore, the env's reset), before any evaluation or training step."""
  with tracing.span('ppo.setup'):
    if batch_size * num_minibatches % num_envs:
      raise ValueError(f'batch_size * num_minibatches ({batch_size} * '
                       f'{num_minibatches}) is no multiple of num_envs '
                       f'({num_envs})')
    rank, world = distributed.world()
    envs_local = local_envs(num_envs)
    if batch_size % world:
      raise ValueError(f'batch_size ({batch_size}) is no multiple of the '
                       f'{world} processes')
    # loop arithmetic (RSR/train.py:150-168)
    env_step_per_training_step = (
        batch_size * unroll_length * num_minibatches * action_repeat)
    num_evals_after_init = max(num_evals - 1, 1)
    num_training_steps_per_epoch = math.ceil(
        num_timesteps / (num_evals_after_init * env_step_per_training_step))
    unrolls_per_step = batch_size * num_minibatches // num_envs

    gen_init, gen_env, gen_act, gen_sgd, gen_eval = _generators(
        seed, ['cpu'] + [device] * 4, own=(3,))
    gen_env = distributed.rows(gen_env, envs_local)
    gen_act = distributed.rows(gen_act, envs_local)

    env = wrappers.wrap_for_training(
        environment, episode_length=episode_length, action_repeat=action_repeat,
        num_envs=envs_local,
        randomization_fn=randomization_bound(randomization_fn, gen_env,
                                             envs_local))
    obs_size = environment.observation_size
    action_size = environment.action_size
    network = network_factory(obs_size, action_size).init(gen_init).to(device)
    normalize_fn = (running_statistics.normalize if normalize_observations
                    else None)
    make_policy = ppo_networks.make_inference_fn(network, normalize_fn)
    optimizer = make_optimizer(network.parameters(), learning_rate)
    normalizer = running_statistics.init_state(obs_size, device)

    if restore_checkpoint_path is not None:
      normalizer, state_dict = _checkpoint.restore(restore_checkpoint_path,
                                                   device)
      network.load_state_dict(state_dict)
    ts = TrainingState(optimizer, network, normalizer, 0)

    if num_timesteps == 0:
      return make_policy, (ts.normalizer_params, ts.params), {}

    loss_kwargs = dict(
        past_data=past_data, entropy_cost=entropy_cost,
        discounting=discounting, reward_scaling=reward_scaling,
        gae_lambda=gae_lambda, clipping_epsilon=clipping_epsilon,
        normalize_advantage=normalize_advantage, rsr_loss_scale=rsr_loss_scale)

    def training_step(ts: TrainingState, env_state):
      policy = make_policy((ts.normalizer_params, ts.params))
      unrolls = []
      for _ in range(unrolls_per_step):
        env_state, data = acting.generate_unroll(
            env, env_state, policy, gen_act, unroll_length,
            extra_fields=('truncation',))
        unrolls.append(data)
      # (iters, T, B, ...) → (iters·B, T, ...)
      data = tree_map(lambda *xs: torch.stack(xs).swapaxes(1, 2).flatten(0, 1),
                      *unrolls)
      normalizer = ts.normalizer_params
      if normalize_observations:
        with tracing.span('ppo.normalizer_update'):
          normalizer = running_statistics.update(
              normalizer, data.observation, distributed.all_sum_, world)
      n = data.reward.shape[0]
      metrics = []
      for _ in range(num_updates_per_batch):
        perm = permutation(n, gen_sgd)
        shuffled = tree_map(
            lambda x: x[perm].reshape((num_minibatches, -1) + x.shape[1:]),
            data)
        for i in range(num_minibatches):
          minibatch = tree_map(lambda x: x[i], shuffled)
          noise = ppo_networks.standard_normal(
              (unroll_length, n // num_minibatches, action_size), gen_sgd)
          metrics.append(minibatch_step(ts.params, ts.optimizer, normalizer,
                                        minibatch, noise, loss_kwargs,
                                        max_grad_norm))
      ts = TrainingState(ts.optimizer, ts.params, normalizer,
                         ts.env_steps + env_step_per_training_step // world)
      return ts, env_state, metrics

    env_state = env.reset(gen_env)

    eval_wrapped = wrappers.EvalWrapper(wrappers.wrap_for_training(
        eval_env if eval_env is not None else environment,
        episode_length=episode_length, action_repeat=action_repeat,
        num_envs=num_eval_envs))
    evaluator = acting.Evaluator(
        eval_wrapped, functools.partial(make_policy,
                                        deterministic=deterministic_eval),
        num_eval_envs=num_eval_envs, episode_length=episode_length,
        action_repeat=action_repeat, generator=gen_eval)

  metrics = {}
  training_walltime = 0.0
  current_step = 0
  if rank == 0 and num_evals > 1:
    metrics = evaluator.run_evaluation(
        (ts.normalizer_params, ts.params), training_metrics={})
    progress_fn(0, metrics)

  for _ in range(num_evals_after_init):
    t = time.time()
    loss_metrics = []
    for _ in range(num_training_steps_per_epoch):
      ts, env_state, step_metrics = training_step(ts, env_state)
      loss_metrics += step_metrics
    _sync(device)
    epoch_training_time = time.time() - t
    training_walltime += epoch_training_time
    current_step = ts.env_steps * world
    sps = (num_training_steps_per_epoch * env_step_per_training_step
           / epoch_training_time)
    loss_means = distributed.mean_metrics(
        {k: torch.stack([m[k] for m in loss_metrics]).mean()
         for k in loss_metrics[0]})
    metrics = {
        'training/sps': sps,
        'training/walltime': training_walltime,
        **{f'training/{k}': v.item() for k, v in loss_means.items()},
    }
    params_tuple = (ts.normalizer_params, ts.params)
    if rank == 0:
      if num_evals > 0:
        metrics = evaluator.run_evaluation(params_tuple, metrics)
      policy_params_fn(current_step, make_policy, params_tuple)
      progress_fn(current_step, metrics)

  assert current_step >= num_timesteps, (current_step, num_timesteps)
  return make_policy, (ts.normalizer_params, ts.params), metrics
