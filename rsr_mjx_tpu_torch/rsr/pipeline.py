"""RSR pipeline: physics-parameter tuning through the differentiable
step, and RSR policy training with the penalty in the policy's loss.

Counterpart of ``rsr_mjx_tpu/rsr/pipeline.py``:

- ``env_params_tuning`` (its :146-335) fits a physics parameter (the
  cube's friction by default, ``default_param_setter``) to observed
  transitions by Adam on the gradient through ``env.step``, which the
  fused step gives by the implicit function theorem
  (``physics.fwd_fused.FusedRegion``).  The loss, ``_make_tuning_loss``
  (:59-143), is one batched step over every transition (k = 1) or a
  k-step rollout over every window, a Python loop of batched steps.  It
  keeps the reference's behaviour, ADVICE.md's defects included: the
  forward-difference start velocity reads the target row (:251), the
  validity mask exists only with ``estimate_init_qvel`` (:271), an empty
  valid set gives a silent zero loss at k = 1 (:128), and non-finite
  gradient entries are zeroed without a word (:296).
- ``build_policy_rsr_data`` / ``policy_params_training``: validate the
  five dataset arrays, precompute the penalty state and train with the
  port's ``train.ppo`` or ``train.sac``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from rsr_mjx_tpu_torch.rsr import loss as rsr_loss

# ---------------------------------------------------------------------------
# env params tuning
# ---------------------------------------------------------------------------

# hand-tuned 23-dim weights of the reference objective (rsr_pipeline.py:120)
DEFAULT_ERROR_WEIGHTS = (1, 1, 1, 1, 1, 1, 10, 10, 10, 0, 0, 0, 10, 10, 10,
                         10, 10, 0, 0, 0, 0, 0, 0)


def default_param_setter(model, params):
  """Write a friction scalar into the last geom's whole friction row (the
  reference's ``geom_friction.at[-1, :].set(params)``)."""
  f = model.geom_friction
  row = params.reshape(1, 1).to(f.dtype).expand(1, f.shape[1])
  return model.replace(geom_friction=torch.cat([f[:-1], row], dim=0))


def gravity_param_setter(model, params):
  g = model.opt.gravity
  gravity = torch.cat([g[:-1], params.reshape(1).to(g.dtype)])
  return model.replace(opt=dataclasses.replace(model.opt, gravity=gravity))


def body_mass_param_setter(model, params):
  bm = model.body_mass
  return model.replace(
      body_mass=torch.cat([bm[:-1], params.reshape(1).to(bm.dtype)]))


def _index_state(state, idx):
  """The envs ``idx`` of a batched ``core.State`` (a generator or other
  non-tensor entry of ``info`` passes through), or of a NamedTuple of
  tensors."""
  pick = lambda x: x[idx] if isinstance(x, torch.Tensor) else x
  if hasattr(state, '_fields'):
    return type(state)(*(pick(x) for x in state))
  return state.replace(
      data=state.data.map(pick), obs=pick(state.obs),
      reward=pick(state.reward), done=pick(state.done),
      metrics={k: pick(v) for k, v in state.metrics.items()},
      info={k: pick(v) for k, v in state.info.items()})


def _make_tuning_loss(
    step_with_params,
    states,
    actions,
    next_obs_true,
    error_weights,
    rollout_horizon: int,
    per_dim_error: bool,
    valid=None,
):
  """The tuning objective ``params -> scalar loss``, JAX's
  ``_make_tuning_loss`` over a batched state.

  ``step_with_params(params, state, action) -> next_state`` steps a batch;
  ``states`` is the batch of start states (one per transition), a
  ``core.State`` or a NamedTuple of tensors with ``obs``.  At k > 1 the
  rows are one
  consecutive trajectory and every window of k free of invalid
  transitions is rolled out from its start; the loss sums the error of
  every step and divides by k.  At k = 1 the loss sums the error of every
  valid transition."""
  index = lambda idx: _index_state(states, idx)

  def step_error(pred_obs, true_obs):  # one value per env
    if per_dim_error:
      return torch.sum(torch.abs(error_weights * (pred_obs - true_obs)),
                       dim=-1)
    return torch.abs(torch.sum(error_weights * (pred_obs - true_obs),
                               dim=-1))

  k = int(rollout_horizon)
  n = actions.shape[0]
  dev = actions.device
  if k > 1:
    if n < k:
      raise ValueError(
          f'rollout_horizon={k} needs at least {k} transitions, have {n}')
    all_starts = np.arange(n - k + 1)
    if valid is not None:
      # static filtering: a window across an episode boundary must not run
      # at all (0·NaN = NaN would still reach the shared parameter)
      vmat = np.asarray(valid)[all_starts[:, None] + np.arange(k)[None, :]]
      all_starts = all_starts[np.all(vmat, axis=1)]
      if all_starts.size == 0:
        raise ValueError(
            'no k-step window free of invalid transitions; shorten '
            'rollout_horizon or pick a different segment')
    starts = torch.as_tensor(all_starts, device=dev)
    widx = starts[:, None] + torch.arange(k, device=dev)[None, :]  # (S, k)
    act_w = actions[widx]  # (S, k, act)
    true_w = next_obs_true[widx]  # (S, k, obs)

    def loss_fn(params):
      s = index(starts)
      total = 0.0
      for j in range(k):
        s = step_with_params(params, s, act_w[:, j])
        total = total + step_error(s.obs, true_w[:, j])
      return torch.sum(total) / k
  else:
    keep = (torch.as_tensor(np.flatnonzero(np.asarray(valid)), device=dev)
            if valid is not None else torch.arange(n, device=dev))

    def loss_fn(params):
      next_state = step_with_params(params, index(keep), actions[keep])
      return torch.sum(step_error(next_state.obs, next_obs_true[keep]))

  return loss_fn


def tuning_update(loss_fn, params, optimizer, params_min, params_max):
  """One Adam step: the loss and its gradient at ``params``, non-finite
  gradient entries set to zero (the reference's containment, silent), the
  update, the clip to the bounds.  Returns the loss."""
  optimizer.zero_grad(set_to_none=True)
  with torch.enable_grad():
    loss = loss_fn(params)
    loss.backward()
  with torch.no_grad():
    g = params.grad
    g.copy_(torch.where(torch.isfinite(g), g, torch.zeros_like(g)))
    optimizer.step()
    params.copy_(torch.clamp(params, params_min, params_max))
  return loss.detach()


def tuning_template(env, device):
  """The reference's template: a one-env reset (seed 0) and one
  zero-action step from it, as (reset state, stepped state)."""
  with torch.no_grad():
    state_0 = env.reset(torch.Generator(device=device).manual_seed(0), 1)
    zero = torch.zeros((1, env.action_size), dtype=state_0.obs.dtype,
                       device=state_0.obs.device)
    return state_0, env.step(state_0, zero)


def tuning_states(env, obs, next_obs_true, template=None,
                  estimate_init_qvel: bool = False, device='cuda'):
  """The batch of start states, one per obs row, and the validity mask
  (rsr_pipeline.py:75-98 and JAX's :241-276): the template's reset qpos
  with each row's arm joints and cube position, the rest of its stepped
  state.  ``obs`` and ``next_obs_true`` are tensors on ``device`` in the
  model's dtype; ``template`` as in ``env_params_tuning``.  Returns
  (states, valid), valid None unless ``estimate_init_qvel``."""
  m = env.model
  state_0, state_1 = template or tuning_template(env, device)
  n = obs.shape[0]
  joint_qadr = torch.as_tensor(np.asarray(env._joint_qadr), device=device)
  box_qadr = env._box_qadr

  qpos = state_0.data.qpos.expand(n, m.nq).clone()
  qpos[:, joint_qadr] = obs[:, 0:6]
  qpos[:, box_qadr : box_qadr + 3] = obs[:, 12:15]
  states = _index_state(state_1, torch.zeros(n, dtype=torch.long,
                                             device=device))
  data = states.data.replace(qpos=qpos)
  valid = None
  if estimate_init_qvel:
    # dof addresses of the arm joints and the cube's free joint, from
    # their qpos addresses (qposadr ↔ joint id is 1:1)
    qadr_to_jnt = {int(q): j for j, q in enumerate(m.jnt_qposadr)}
    joint_dofadr = torch.as_tensor(
        [int(m.jnt_dofadr[qadr_to_jnt[int(q)]]) for q in env._joint_qadr],
        device=device)
    box_dofadr = int(m.jnt_dofadr[qadr_to_jnt[int(box_qadr)]])
    # forward difference to the NEXT row (ADVICE.md: it reads the target)
    v = torch.clamp((next_obs_true - obs) / env.ctrl_dt, -10.0, 10.0)
    qvel = torch.zeros_like(data.qvel)
    qvel[:, joint_dofadr] = v[:, 0:6]
    qvel[:, box_dofadr : box_dofadr + 3] = v[:, 12:15]
    data = data.replace(qvel=qvel)
    # transitions across an episode boundary (the cube re-spawned) cannot
    # be fitted; only this option marks them (ADVICE.md)
    jump = torch.amax(torch.abs(next_obs_true - obs)[:, 12:15], dim=1)
    valid = (jump < 0.15).cpu().numpy()
  return states.replace(data=data), valid


def _as_model_dtype(env, device):
  dtype = env.model.qpos0.dtype
  return lambda x: rsr_loss.as_tensor(x, device).to(torch.float32).to(dtype)


def make_env_tuning_loss(
    env,
    obs: Any,
    actions: Any,
    next_obs_true: Any,
    param_setter: Callable = default_param_setter,
    error_weights: Any = None,
    rollout_horizon: int = 1,
    per_dim_error: bool = False,
    estimate_init_qvel: bool = False,
    template=None,
    device='cuda',
):
  """The loss ``env_params_tuning`` descends, ``params -> scalar``: the
  start states of ``tuning_states`` stepped by ``env.step`` under
  ``param_setter(env.model, params)`` and scored by ``_make_tuning_loss``.
  Arguments as in ``env_params_tuning``."""
  f = _as_model_dtype(env, device)
  obs, actions, next_obs_true = f(obs), f(actions), f(next_obs_true)
  error_weights = f(DEFAULT_ERROR_WEIGHTS if error_weights is None
                    else error_weights)
  states, valid = tuning_states(env, obs, next_obs_true, template,
                                estimate_init_qvel, device)
  m = env.model

  def step_with_params(p, state, action):
    bound = copy.copy(env)
    bound.bind_model(param_setter(m, p))
    return bound.step(state, action)

  return _make_tuning_loss(step_with_params, states, actions, next_obs_true,
                           error_weights, rollout_horizon, per_dim_error,
                           valid=valid)


def env_params_tuning(
    init_env,
    num_steps: int,
    init_env_params,
    env_params_min,
    env_params_max,
    obs: Any,
    actions: Any,
    next_obs_true: Any,
    log_path: Optional[str] = None,
    param_setter: Callable = default_param_setter,
    learning_rate: float = 0.005,
    error_weights: Any = None,
    progress_every: int = 1,
    rollout_horizon: int = 1,
    per_dim_error: bool = False,
    estimate_init_qvel: bool = False,
    template=None,
    device='cuda',
):
  """Tune a physics parameter to match observed transitions; returns
  (tuned_params, train_log) as the reference does.

  ``init_env`` is a port env on ``device`` (its model's dtype is the
  parameter's); ``obs``, ``actions`` and ``next_obs_true`` are (n, 23),
  (n, 5) and (n, 23), made float32 first as ``jnp.asarray`` makes them.
  ``template`` = (reset state, stepped state), two one-env states, takes
  the place of ``tuning_template(init_env)`` (a torch generator cannot
  draw the JAX reset of PRNGKey(0): the tests hand that state over).  See
  the JAX docstring for ``rollout_horizon``, ``per_dim_error`` and
  ``estimate_init_qvel``."""
  loss_fn = make_env_tuning_loss(
      init_env, obs, actions, next_obs_true, param_setter, error_weights,
      rollout_horizon, per_dim_error, estimate_init_qvel, template, device)
  f = _as_model_dtype(init_env, device)
  params = f(init_env_params).clone()
  params_min, params_max = f(env_params_min), f(env_params_max)

  from rsr_mjx_tpu_torch.train import ppo

  params.requires_grad_(True)
  optimizer = ppo.make_optimizer([params], learning_rate)
  train_time, train_loss, train_params = [], [], []
  for i in range(num_steps):
    t0 = time.time()
    loss = tuning_update(loss_fn, params, optimizer, params_min, params_max)
    loss_v = float(loss)  # waits for the device
    dt = time.time() - t0
    p = params.detach().cpu().numpy().copy()
    train_time.append(dt)
    train_loss.append(loss_v)
    train_params.append(p)
    if log_path is not None and i % progress_every == 0:
      line = f'step {i}: {dt:.2f}s. params = {p}. loss = {loss_v}.'
      with open(log_path, 'a') as fh:
        fh.write(line + '\n')

  train_log = {
      'time_cost': train_time,
      'loss': train_loss,
      'params': train_params,
  }
  return params.detach(), train_log


# ---------------------------------------------------------------------------
# policy training facade
# ---------------------------------------------------------------------------


def build_policy_rsr_data(
    past_states: Any,
    past_actions: Any,
    past_next_states_real: Any,
    past_next_states_sim: Any,
    current_next_states_sim: Any,
    num_samples: int = 10,
    min_val: float = -3.0,
    max_val: float = 3.0,
    bandwidth: float = 0.1,
    seed: int = 0,
    grid=None,
    device='cuda',
) -> rsr_loss.RSRData:
  """Validate the five arrays and precompute the ``RSRData`` on
  ``device``; ``grid`` as in ``loss.build_rsr_data``."""
  arrays = tuple(
      rsr_loss.as_tensor(v, device)
      for v in (past_states, past_actions, past_next_states_real,
                past_next_states_sim, current_next_states_sim)
  )
  (past_states, past_actions, past_next_states_real, past_next_states_sim,
   current_next_states_sim) = arrays

  if any(v.ndim != 2 for v in arrays):
    shapes = tuple(tuple(v.shape) for v in arrays)
    raise ValueError(f'all RSR datasets must be rank 2, got {shapes}')
  sample_counts = {v.shape[0] for v in arrays}
  if len(sample_counts) != 1:
    shapes = tuple(tuple(v.shape) for v in arrays)
    raise ValueError(f'RSR datasets must have equal lengths, got {shapes}')
  if next(iter(sample_counts)) == 0:
    raise ValueError('RSR datasets must not be empty')
  for name, v in (
      ('real next-state', past_next_states_real),
      ('previous sim next-state', past_next_states_sim),
      ('current sim next-state', current_next_states_sim),
  ):
    if v.shape[1] != past_states.shape[1]:
      raise ValueError(f'{name} width must match state width')

  real_data = torch.hstack([past_states, past_actions, past_next_states_real])
  previous_sim_data = torch.hstack(
      [past_states, past_actions, past_next_states_sim])
  current_sim_data = torch.hstack(
      [past_states, past_actions, current_next_states_sim])
  return rsr_loss.build_rsr_data(
      real_data,
      previous_sim_data,
      current_sim_data,
      num_samples=num_samples,
      min_value=min_val,
      max_value=max_val,
      bandwidth=bandwidth,
      seed=seed,
      grid=grid,
  )


def policy_params_training(
    env,
    restore_checkpoint_path: Optional[str] = None,
    policy_params_fn: Optional[Callable[..., None]] = None,
    network_factory: Optional[Callable[..., Any]] = None,
    progress_fn: Optional[Callable[..., None]] = None,
    past_states: Any = None,
    past_actions: Any = None,
    past_next_states_real: Any = None,
    past_next_states_sim: Any = None,
    current_next_states_sim: Any = None,
    algorithm: str = 'ppo',
    num_samples: int = 10,
    min_val: float = -3.0,
    max_val: float = 3.0,
    bandwidth: float = 0.1,
    rsr_loss_scale: float = 1.0,
    num_timesteps: int = 5_000_000,
    num_evals: int = 10,
    reward_scaling: float = 0.1,
    episode_length: int = 1200,
    normalize_observations: bool = True,
    action_repeat: int = 1,
    discounting: float = 0.96,
    learning_rate: float = 1e-4,
    num_envs: int = 512,
    batch_size: int = 128,
    seed: int = 0,
    num_eval_envs: int = 128,
    deterministic_eval: bool = False,
    # PPO-specific
    unroll_length: int = 10,
    num_minibatches: int = 32,
    num_updates_per_batch: int = 8,
    entropy_cost: float = 2e-2,
    # SAC-specific
    tau: float = 0.005,
    min_replay_size: int = 0,
    max_replay_size: Optional[int] = None,
    grad_updates_per_step: int = 1,
    checkpoint_logdir: Optional[str] = None,
    wrap_env_fn: Optional[Callable[..., Any]] = None,
    eval_env=None,
    device='cuda',
):
  """Train an RSR policy with PPO or SAC, the penalty built from the five
  datasets (``rsr_loss_scale`` times it) in the PPO loss or the SAC actor
  loss.  ``env`` and ``eval_env`` live on ``device``.  Returns
  (make_inference_fn, params), params being (normalizer, ``PPONetworks``
  or ``SACNetworks``)."""
  if rsr_loss_scale < 0:
    raise ValueError(
        f'rsr_loss_scale must be non-negative, got {rsr_loss_scale}'
    )
  required = (
      past_states,
      past_actions,
      past_next_states_real,
      past_next_states_sim,
      current_next_states_sim,
  )
  if any(v is None for v in required):
    raise ValueError('all five RSR policy datasets are required')

  past_data = build_policy_rsr_data(
      past_states,
      past_actions,
      past_next_states_real,
      past_next_states_sim,
      current_next_states_sim,
      num_samples=num_samples,
      min_val=min_val,
      max_val=max_val,
      bandwidth=bandwidth,
      seed=seed,
      device=device,
  )
  progress_fn = progress_fn or (lambda *args: None)
  algorithm = algorithm.strip().lower()

  if algorithm == 'ppo':
    from rsr_mjx_tpu_torch.train import networks as ppo_networks
    from rsr_mjx_tpu_torch.train import ppo

    make_inference_fn, params, _ = ppo.train(
        environment=env,
        past_data=past_data,
        num_timesteps=num_timesteps,
        num_evals=num_evals,
        num_eval_envs=num_eval_envs,
        reward_scaling=reward_scaling,
        episode_length=episode_length,
        normalize_observations=normalize_observations,
        action_repeat=action_repeat,
        unroll_length=unroll_length,
        num_minibatches=num_minibatches,
        num_updates_per_batch=num_updates_per_batch,
        discounting=discounting,
        learning_rate=learning_rate,
        entropy_cost=entropy_cost,
        num_envs=num_envs,
        batch_size=batch_size,
        restore_checkpoint_path=restore_checkpoint_path,
        policy_params_fn=policy_params_fn or (lambda *args: None),
        network_factory=network_factory or ppo_networks.make_ppo_networks,
        progress_fn=progress_fn,
        deterministic_eval=deterministic_eval,
        rsr_loss_scale=rsr_loss_scale,
        seed=seed,
        eval_env=eval_env,
        device=device,
    )
    return make_inference_fn, params

  if algorithm == 'sac':
    from rsr_mjx_tpu_torch.train import sac, sac_networks

    if restore_checkpoint_path:
      raise ValueError(
          'SAC cannot resume complete training state; use '
          'checkpoint_logdir to save inference checkpoints instead'
      )
    make_inference_fn, params, _ = sac.train(
        environment=env,
        past_data=past_data,
        num_timesteps=num_timesteps,
        num_evals=num_evals,
        num_eval_envs=num_eval_envs,
        reward_scaling=reward_scaling,
        episode_length=episode_length,
        normalize_observations=normalize_observations,
        action_repeat=action_repeat,
        discounting=discounting,
        learning_rate=learning_rate,
        num_envs=num_envs,
        batch_size=batch_size,
        tau=tau,
        min_replay_size=min_replay_size,
        max_replay_size=max_replay_size,
        grad_updates_per_step=grad_updates_per_step,
        checkpoint_logdir=checkpoint_logdir,
        network_factory=network_factory or sac_networks.make_sac_networks,
        progress_fn=progress_fn,
        deterministic_eval=deterministic_eval,
        rsr_loss_scale=rsr_loss_scale,
        seed=seed,
        wrap_env_fn=wrap_env_fn,
        eval_env=eval_env,
        device=device,
    )
    return make_inference_fn, params

  raise ValueError(
      f'unsupported algorithm {algorithm!r}; expected "ppo" or "sac"'
  )
