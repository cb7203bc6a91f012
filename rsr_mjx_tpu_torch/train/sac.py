"""SAC trainer, on one device or one process per device, with the RSR
penalty in the actor loss.

Counterpart of ``rsr_mjx_tpu/train/sac.py`` with the same argument surface
and loop arithmetic: ``ceil(min_replay_size / num_envs)`` prefill actor
steps of the stochastic policy, then epochs of training steps, each one
actor step (through the wrapped env: the fused physics step and its
kernels) and ``grad_updates_per_step`` SGD steps on batches drawn from a
replay ring on the device (``replay_buffer``).  The observation normalizer
updates on every actor step's observations, prefill included, after the
step.  An SGD step takes the three gradients (temperature, twin critics,
actor) at the old parameters, then applies three Adams (α at a fixed
3e-4, the others at ``learning_rate``; each clipped to ``max_grad_norm``
when given), then moves the target critics by τ (``sgd_step``).

The random draws come from ``torch.Generator``s seeded from ``seed``: the
networks' initialisation on the CPU, the env reset, the acting noise, the
replay indices, the SGD noise and the evaluation, each its own stream on
``device``.  Checkpoints ``<checkpoint_logdir>_sac_<step>.pkl`` and
``save_params`` pickle (normalizer, policy layers) in the JAX layout,
which the JAX ``sac.load_params`` reads without torch.
``randomization_fn`` works as in ``ppo.train``: one randomised model per
training env, drawn before the reset; none in the evaluator.

Under a ``torch.distributed`` process group each process steps
``num_envs // world`` envs (their draws as in ``ppo.train``), keeps a ring
of ``max_replay_size // world`` transitions and draws ``batch_size //
world`` of them for each SGD step from its own stream, as the JAX
trainer's per-device rings do (``batch_size · grad_updates_per_step //
num_devices`` a device), so that an SGD step sees ``batch_size``
transitions over all processes; its noise is drawn at the local size.
Each of the three gradients is averaged over the processes, the
normalizer's sums are summed and the metrics averaged.
The env steps count all processes (the local count times the world).
Process 0 alone evaluates, checkpoints and calls ``progress_fn``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from rsr_mjx_tpu_torch.envs import wrappers
from rsr_mjx_tpu_torch.envs.core import Env
from rsr_mjx_tpu_torch.train import acting
from rsr_mjx_tpu_torch.train import checkpoint as _checkpoint
from rsr_mjx_tpu_torch.train import distributed
from rsr_mjx_tpu_torch.train import networks as ppo_networks
from rsr_mjx_tpu_torch.train import ppo
from rsr_mjx_tpu_torch.train import replay_buffer
from rsr_mjx_tpu_torch.train import running_statistics
from rsr_mjx_tpu_torch.train import sac_losses
from rsr_mjx_tpu_torch.train import sac_networks
from rsr_mjx_tpu_torch.train.losses import Transition


@dataclasses.dataclass
class TrainingState:
  """The networks (policy and critics), the target critics, log α, their
  three Adams, the normalizer and the step counts."""

  networks: sac_networks.SACNetworks
  target_q: nn.ModuleList
  log_alpha: torch.Tensor  # a 0-dim leaf that requires grad
  policy_optimizer: torch.optim.Optimizer
  q_optimizer: torch.optim.Optimizer
  alpha_optimizer: torch.optim.Optimizer
  normalizer_params: running_statistics.RunningStatisticsState
  env_steps: int = 0
  gradient_steps: int = 0


def sgd_step(ts: TrainingState, losses, transitions: Transition, noise,
             tau: float, max_grad_norm: Optional[float] = None):
  """One SAC update on a batch of transitions, as the JAX ``sgd_step``:
  the temperature, critic and actor gradients, each with respect to its
  own parameters and all three at the old parameters (the critic and the
  actor with α = exp(old log α)); then the three Adam steps; then target
  ← (1 − τ)·target + τ·critics.  Each gradient is averaged over the
  processes (``distributed``) before its step.  ``losses`` are
  ``sac_losses.make_losses``' three; ``noise`` their three standard-normal
  draws, in that order.
  Returns the loss metrics and the new α (detached)."""
  alpha_loss, critic_loss, actor_loss = losses
  net = ts.networks
  policy_params = list(net.policy.parameters())
  q_params = list(net.q.parameters())
  with torch.enable_grad():
    alpha_l = alpha_loss(ts.log_alpha, ts.normalizer_params, transitions,
                         noise[0])
    alpha_grads = torch.autograd.grad(alpha_l, [ts.log_alpha])
    alpha = torch.exp(ts.log_alpha.detach())
    critic_l = critic_loss(ts.normalizer_params, ts.target_q, alpha,
                           transitions, noise[1])
    critic_grads = torch.autograd.grad(critic_l, q_params)
    actor_l = actor_loss(ts.normalizer_params, alpha, transitions, noise[2])
    actor_grads = torch.autograd.grad(actor_l, policy_params)
  for grads in (alpha_grads, critic_grads, actor_grads):
    distributed.mean_grads_(grads)
  for optimizer, params, grads in (
      (ts.alpha_optimizer, [ts.log_alpha], alpha_grads),
      (ts.q_optimizer, q_params, critic_grads),
      (ts.policy_optimizer, policy_params, actor_grads)):
    if max_grad_norm is not None:
      with torch.no_grad():
        ppo.clip_by_global_norm_(grads, max_grad_norm)
    for p, g in zip(params, grads):
      p.grad = g
    optimizer.step()
  with torch.no_grad():
    targets = list(ts.target_q.parameters())
    torch._foreach_mul_(targets, 1 - tau)
    torch._foreach_add_(targets, torch._foreach_mul(q_params, tau))
  ts.gradient_steps += 1
  return {'critic_loss': critic_l.detach(), 'actor_loss': actor_l.detach(),
          'alpha_loss': alpha_l.detach(),
          'alpha': torch.exp(ts.log_alpha.detach())}


def save_params(path: str, params) -> None:
  """Pickle ``params`` = (normalizer, SACNetworks) as the JAX trainer's
  SAC checkpoint: (normalizer, [{'w', 'b'}, ...] policy layers) of numpy
  arrays."""
  normalizer, net = params
  _checkpoint.dump_numpy(path, (
      running_statistics.map_state(ppo_networks.to_numpy, normalizer),
      sac_networks.sac_params_to_numpy(net)['policy']))


def load_params(path: str):
  """(normalizer RunningStatisticsState, [{'w', 'b'}, ...] policy layers)
  of numpy arrays, from a SAC checkpoint or ``final_params.pkl`` of either
  package."""
  return ppo_networks.load_ppo_params(path)


def _transition(tr: Transition) -> Transition:
  """What the buffer keeps of an actor step: no policy extras (the
  acting policy's log-probability and pre-tanh action)."""
  return tr._replace(extras={
      'policy_extras': {},
      'state_extras': {'truncation': tr.extras['state_extras']['truncation']},
  })


def train(
    environment: Env,
    num_timesteps: int,
    episode_length: int,
    past_data: Any = None,
    wrap_env_fn: Optional[Callable] = None,
    action_repeat: int = 1,
    num_envs: int = 1,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    discounting: float = 0.9,
    seed: int = 0,
    batch_size: int = 256,
    num_evals: int = 1,
    normalize_observations: bool = False,
    reward_scaling: float = 1.0,
    tau: float = 0.005,
    min_replay_size: int = 0,
    max_replay_size: Optional[int] = None,
    grad_updates_per_step: int = 1,
    deterministic_eval: bool = False,
    network_factory: Callable[..., sac_networks.SACNetworks] = (
        sac_networks.make_sac_networks),
    progress_fn: Callable[[int, dict], None] = lambda *args: None,
    checkpoint_logdir: Optional[str] = None,
    eval_env: Optional[Env] = None,
    randomization_fn: Optional[Callable] = None,
    rsr_loss_scale: float = 1.0,
    max_grad_norm: Optional[float] = None,
    device='cuda',
):
  """Train a SAC policy.  Returns (make_policy, (normalizer, networks),
  metrics), as the JAX ``train``; ``environment`` must live on ``device``.
  ``wrap_env_fn(env, episode_length=, action_repeat=, num_envs=,
  randomization_fn=)`` takes the place of ``wrappers.wrap_for_training``
  (the evaluator's call gets no ``randomization_fn``)."""
  if rsr_loss_scale < 0:
    raise ValueError(
        f'rsr_loss_scale must be non-negative, got {rsr_loss_scale}')
  rank, world = distributed.world()
  envs_local = ppo.local_envs(num_envs)
  if batch_size % world:
    raise ValueError(f'batch_size ({batch_size}) is no multiple of the '
                     f'{world} processes')
  batch_local = batch_size // world
  if max_replay_size is None:
    max_replay_size = num_timesteps
  # loop arithmetic (sac.py:104-117)
  env_steps_per_actor_step = action_repeat * num_envs
  num_prefill_actor_steps = math.ceil(min_replay_size / num_envs)
  num_prefill_env_steps = num_prefill_actor_steps * env_steps_per_actor_step
  if num_timesteps < num_prefill_env_steps:
    raise ValueError(f'num_timesteps ({num_timesteps}) is less than the '
                     f'prefill ({num_prefill_env_steps} env-steps)')
  num_evals_after_init = max(num_evals - 1, 1)
  num_training_steps_per_epoch = math.ceil(
      (num_timesteps - num_prefill_env_steps)
      / (num_evals_after_init * env_steps_per_actor_step))

  gen_init, gen_env, gen_act, gen_rb, gen_sgd, gen_eval = ppo._generators(
      seed, ['cpu'] + [device] * 5, own=(3, 4))
  gen_env = distributed.rows(gen_env, envs_local)
  gen_act = distributed.rows(gen_act, envs_local)

  wrap = wrap_env_fn or wrappers.wrap_for_training
  env = wrap(environment, episode_length=episode_length,
             action_repeat=action_repeat, num_envs=envs_local,
             randomization_fn=ppo.randomization_bound(randomization_fn,
                                                      gen_env, envs_local))
  obs_size = environment.observation_size
  action_size = environment.action_size
  if not isinstance(obs_size, int):
    raise NotImplementedError('dict observations: wrap the env in '
                              'SelectObservationWrapper')

  network = network_factory(obs_size, action_size).init(gen_init).to(device)
  normalize_fn = (running_statistics.normalize if normalize_observations
                  else None)
  # the policy of PPO's networks: the mode, or a tanh-normal sample
  make_policy = ppo_networks.make_inference_fn(network, normalize_fn)
  target_q = copy.deepcopy(network.q).requires_grad_(False)  # not shared
  log_alpha = torch.zeros((), device=device, requires_grad=True)
  ts = TrainingState(
      networks=network,
      target_q=target_q,
      log_alpha=log_alpha,
      policy_optimizer=ppo.make_optimizer(network.policy.parameters(),
                                          learning_rate),
      q_optimizer=ppo.make_optimizer(network.q.parameters(), learning_rate),
      alpha_optimizer=ppo.make_optimizer([log_alpha], 3e-4),
      normalizer_params=running_statistics.init_state(obs_size, device),
  )
  losses = sac_losses.make_losses(
      network, reward_scaling=reward_scaling, discounting=discounting,
      action_size=action_size, normalize_fn=normalize_fn,
      past_data=past_data, rsr_loss_scale=rsr_loss_scale)

  zeros = lambda *shape: torch.zeros(shape, device=device)
  buffer = replay_buffer.init(max_replay_size // world, Transition(
      observation=zeros(obs_size), action=zeros(action_size),
      reward=zeros(), discount=zeros(), next_observation=zeros(obs_size),
      extras={'policy_extras': {}, 'state_extras': {'truncation': zeros()}}))

  def actor_step(ts, env_state, buffer):
    """One step of the stochastic policy; the normalizer and the buffer
    take its transitions."""
    policy = make_policy((ts.normalizer_params, ts.networks))
    env_state, transitions = acting.actor_step(
        env, env_state, policy, gen_act, extra_fields=('truncation',))
    if normalize_observations:
      ts.normalizer_params = running_statistics.update(
          ts.normalizer_params, transitions.observation,
          distributed.all_sum_, world)
    buffer = replay_buffer.insert(buffer, _transition(transitions))
    ts.env_steps += action_repeat * envs_local
    return env_state, buffer

  def training_step(ts, env_state, buffer):
    env_state, buffer = actor_step(ts, env_state, buffer)
    batch = replay_buffer.sample(buffer, batch_local * grad_updates_per_step,
                                 gen_rb)
    metrics = []
    for g in range(grad_updates_per_step):
      minibatch = wrappers.tree_map(
          lambda x: x[g * batch_local:(g + 1) * batch_local], batch)
      noise = [ppo_networks.standard_normal((batch_local, action_size),
                                            gen_sgd) for _ in range(3)]
      metrics.append(sgd_step(ts, losses, minibatch, noise, tau,
                              max_grad_norm))
    return env_state, buffer, metrics

  env_state = env.reset(gen_env)

  eval_wrapped = wrappers.EvalWrapper(wrap(
      eval_env if eval_env is not None else environment,
      episode_length=episode_length, action_repeat=action_repeat,
      num_envs=num_eval_envs))
  evaluator = acting.Evaluator(
      eval_wrapped, functools.partial(make_policy,
                                      deterministic=deterministic_eval),
      num_eval_envs=num_eval_envs, episode_length=episode_length,
      action_repeat=action_repeat, generator=gen_eval)

  metrics = {}
  if rank == 0 and num_evals > 1:
    metrics = evaluator.run_evaluation((ts.normalizer_params, ts.networks),
                                       training_metrics={})
    progress_fn(0, metrics)

  for _ in range(num_prefill_actor_steps):
    env_state, buffer = actor_step(ts, env_state, buffer)

  training_walltime = 0.0
  current_step = ts.env_steps * world
  for _ in range(num_evals_after_init):
    t = time.time()
    sgd_metrics = []
    for _ in range(num_training_steps_per_epoch):
      env_state, buffer, step_metrics = training_step(ts, env_state, buffer)
      sgd_metrics += step_metrics
    ppo._sync(device)
    epoch_time = time.time() - t
    training_walltime += epoch_time
    current_step = ts.env_steps * world
    sps = (env_steps_per_actor_step * num_training_steps_per_epoch
           / epoch_time)
    sgd_means = distributed.mean_metrics(
        {k: torch.stack([m[k] for m in sgd_metrics]).mean()
         for k in (sgd_metrics[0] if sgd_metrics else {})})
    metrics = {
        'training/sps': sps,
        'training/walltime': training_walltime,
        **{f'training/{k}': v.item() for k, v in sgd_means.items()},
    }
    params = (ts.normalizer_params, ts.networks)
    if rank == 0:
      if num_evals > 0:
        metrics = evaluator.run_evaluation(params, metrics)
      if checkpoint_logdir:
        save_params(f'{checkpoint_logdir}_sac_{current_step}.pkl', params)
      progress_fn(current_step, metrics)

  assert current_step >= num_timesteps, (current_step, num_timesteps)
  return make_policy, (ts.normalizer_params, ts.networks), metrics
