"""Run the PyTorch/H100 port on one card and check it.

    python3 chip_smoke.py [--kernels-only | --wrapper-times [DIR]]

Run from the root of the repository.  ``--kernels-only`` stops after phase 2
and prints no result line (for work on a kernel).  ``--wrapper-times`` prints
only the times of K1 and K2 through the public wrappers of the port found
under DIR, a directory inside this repository that holds another commit of
it (this tree when DIR is left out): the way to time a parent's kernels and
this tree's within one call on one card (see wrapper_times).  It imports
the port (``rsr_mjx_tpu_torch``) and nothing of the JAX package.  Twenty-six
paths are driven.  Eight serve a policy run deterministically, each
through ``envs.load`` → ``wrap_for_training`` → ``env.step``: cube-push
(``AirbotCubePushTrain``, kernels K1, K2, K3) with a PPO and a SAC policy,
Airbot T-push (``AirbotTPush``, K1, K2, K3) with a seeded PPO policy, the
Go2 joystick (``Go2JoystickFlatTerrain``, kernels K1, K4), and the other
Go2 tasks (K1, K4): getup, handstand and footstand on the full-collision
scene (K4 at 366 rows) and the joystick on rough terrain.  Ten
train: PPO on cube-push through ``ppo.train`` at the tuned width (K1, K2,
K3 in its rollouts), RSR policy training on cube-push through
``rsr.pipeline.policy_params_training`` with the penalty on (K1, K2, K3),
PPO on the Go2 joystick at its tuned table (K1, K4), the same three
with SAC (``sac.train``, its replay ring on the card), PPO on T-push,
PPO with domain randomisation on cube-push and on the Go2 joystick, and
PPO on Go2 getup (K1, K4 at 366 rows).  One
tunes the
cube's friction through ``rsr.pipeline.env_params_tuning`` with gradients
through the step (K1, K2, K3 forward; K1, K2, K4 in the recomputation and
the backward).  And the port's command-line programs: the evaluation CLIs
(``train.eval_policy``, ``train.eval_go2``) on cube-push and getup, and PPO
and SAC training in a ``torch.distributed`` group of one.  And deployment and
its neighbours: ``deploy.PolicyInference`` serving the PPO and SAC
checkpoints on the card, the cube-push and T-push control loops against stub
arms, the rollouts behind ``--render`` and ``--video`` at one env
(cube-push: K1, K2, K3; the Go2 joystick: K1, K4, a batch no other path
sends to the kernels) and the scaling sweep (``python -m
rsr_mjx_tpu_torch.bench_scaling``).  Rasterising those rollouts into frames
needs ``mujoco`` and a GL context, which the card machine lacks: phase 12
checks the qpos that would be rendered, not frames.

On the card every physics substep outside the tuning gradient is replayed
from a CUDA graph (``physics/graphed.py``), and a replay calls no kernel
wrapper: the launch counts the phases check (``linalg_kernels.LAUNCHES``)
are inferred there, the capture's counts added at each replay.  Each
``profile_control_step`` holds them to the card: the K1-K4 kernels a
profiled control step ran, counted by name in the device trace, equal the
counts.  The kernels' recorded inputs come from one eager control step
(``record_calls``); the paths measured run as they run for a user.

Phases; any failure exits non-zero before the result line is printed:

  1. device   a CUDA card is required (no CPU path); print the card's name and
              power limit; TF32 off; build the four CUDA kernels from
              ``csrc/``.
  2. kernels  each kernel on the inputs its path gives it (recorded from
              one control step of the batch), held against its plain
              PyTorch version on the same inputs, env by env (see
              check_kernels and check_k4): K1 spd_solve_lanes at nv 20
              (cube-push) and nv 18 (Go2), K2 contact_select_lanes (its
              rows and its picked slots, both exact) also on dist rounded
              to create exact ties, K3 newton_lanes_pyr_t,
              K4 _newton_lanes_core on the Go2 rows at the Go2 schedule
              (1 x 5) and at 6 x 6, and on the cube-push model's generic
              rows (basis off, nv 20) at 6 x 6, where its objective is also
              held beside K3's and its time is taken.  Every kernel also on
              its recorded inputs cut by 3 envs (a batch that is no
              multiple of the envs per block), K1, K2 and K3 at every
              number of envs per block that fits (K1: both of its
              decompositions at both widths), K1 and K2 also on the first
              5 envs, same criteria;
              K1 with NaN in the triangle it must not read (see k1_row).
              Times of the kernel, the plain version and, for K1 and K2,
              one PyTorch library call; for every kernel also the device
              time by kernel name from torch.profiler (CUDA events over
              back-to-back launches include the wrapper's host time; the
              library call's device time is the sum of its kernels) and
              that time at each number of envs per block; for the two
              Newton kernels at the schedules 0 x 0, 1 x 0, 1 x ls,
              iters x ls (load and store, one Newton step, one line-search
              step).  Widths and sizes that are not compiled in, on seeded
              inputs: both Newton kernels (check_runtime_widths), K1 at
              n 1, 7, 31, 32 (check_k1_widths) and, for the batch at which
              its two decompositions cross, at n 20 and B 3072 and 16384
              at every E; K2 at slot counts that are no multiple of 32,
              past 512 and with every slot selected, on ties, inf, -0 and
              NaN (check_k2_sizes).
  3. paths    for each path: 256 envs of the batch run 3 control steps on
              the card, on the CPU (plain versions) and on the CPU in
              float64; the card must be as close to float64 as the CPU's
              fp32 path is (see reference()).  Then the rollout: cube-push
              10 control steps of 4 substeps at B = 2048, Go2 15 control
              steps of 5 substeps at B = 8192 (the tuned config's
              num_envs).  The kernels' launch counts, zeroed just before
              each rollout, must match the substeps run.  The Go2 rollout
              also reports the share of envs done and the command-tracking
              errors over alive steps, and fails if more than 5 % of the
              envs terminate.  Then one more control step of each path
              runs under torch.profiler: wall and device busy time, the
              device's idle share, the number of device kernels, and the
              host time of each stage.
  4. training ``ppo.train`` with ``configs.ppo_config('AirbotCubePushTrain')``
              (1024 envs, batch 256 x 32 minibatches, unroll 10, 8 updates
              per batch, policy 32 x 4, value 256 x 5) for one training
              step (81920 env-steps) in one epoch; training env-steps/s,
              rollout ms per control step and SGD ms per minibatch (CUDA
              events, no synchronise), each step's loss metrics; fails on a
              non-finite metric, on env steps or a normalizer count other
              than the rollouts gave, on parameters left unchanged, on
              launch counts other than the rollouts' substeps give.  Then
              K1, K2 and K3 on the recorded inputs of the last training
              substep (B 1024) under phase 2's checks, one recorded
              minibatch step on the card against the CPU in fp32 and
              float64 (see sgd_check), and the evaluator, deterministic, on
              128 envs for a cut episode of 5 control steps.
  5. rsr      ``rsr.pipeline.policy_params_training(algorithm='ppo')`` on
              ``AirbotCubePush`` with ``data_rsr_demo/`` at the RSR CLI's
              width (512 envs, batch 128, unroll 10, 8 updates, policy
              and value 32 x 4) with 8 of its 32 minibatches, bandwidth
              2.0 (at the demo's 0.1 the penalty is identically zero) and
              rsr_loss_scale 1.0, for one training step (10240 env-steps):
              the gate weight, each step's loss metrics with
              sim2real_loss and rsr_distribution_distance, the rates as in
              phase 4 and its checks (launches 2·S + 1, S + 1, S + 1, 0),
              a nonzero penalty in every minibatch; K1, K2 and K3 on the
              inputs of the control step after training (B 512) at every
              E; the SGD check, with the gradient of sim2real_loss alone
              also held to float64 and nonzero.
  6. go2      ``ppo.train`` with ``configs.ppo_config(
              'Go2JoystickFlatTerrain')`` (8192 envs, batch 256 x 32,
              unroll 20, 4 updates, 512-256-128 networks, the value network
              on ``privileged_state``) for one training step (163840
              env-steps): phase 4's rates and checks (launches S + 1 of K1
              and K4), K1 and K4 on the control step after training, the
              SGD check on dict observations, the evaluator as in phase 4.
  7. tuning   ``rsr.pipeline.env_params_tuning`` on ``AirbotCubePush``
              with ``data_rsr_demo/``, the gradient through the physics
              step (FusedRegion: the forward on K1, K2, K3; the
              recomputation on K1, K2, K4; the backward on K1, the IFT
              solve included), in two runs: the demo's command (30
              transitions from 15, k = 1, init 0.4, bounds x0.2 and x10,
              lr 0.005) for 2 Adam steps and the slip run of
              tuned_params_slip_k8pd.json (k = 8, per_dim_error, 23
              windows) for 1.  Per Adam step after the first: seconds from
              CUDA events, split into the forward and the backward; the
              loss and friction trajectory; one step under torch.profiler
              (device busy time, idle share, kernels).  Checks: at 0.4 (a
              tie with the table's friction) and 0.6 the card's loss and
              gradient held to the CPU's float64 as closely as the CPU's
              fp32 is, the float64 gradient printed beside central and
              one-sided differences (step 1e-4; not held, the IFT gradient
              at an unconverged solve is JAX's: see tuning_reference);
              finite losses, the friction moved
              and within its bounds; the launches of every Adam step equal
              7 S - 1, 2 S, S, S for its S substeps (K1, K2, K3, K4; the
              first substep's smooth solve has no backward); K4 on the last
              recomputation's inputs (nv 20, R0 181, 6 x 6, B 30) at every
              E that fits and K1 on the IFT systems under phase 2's
              criteria, NaN-triangle check included, with their times and
              bounds; K2 and K3 on the last Adam step's forward (B 30)
              under phase 2's criteria, with their times; K2's picks equal
              the plain version's and its backward the plain gather's.
  8. sac      three SAC runs at full width, each SAC_TRAIN_STEPS (4)
              training steps after its replay prefill, in one epoch with
              no evaluation inside: ``sac.train`` with
              ``configs.sac_config('AirbotCubePushTrain')`` (1024 envs,
              batch 256, 256 x 256 policy and twin critics, ring of
              1 000 000, prefill 12 actor steps, SAC_PREFILL_STEPS,
              where the table's min_replay_size gives 98); ``rsr.pipeline.
              policy_params_training(algorithm='sac')`` at the RSR CLI's
              table (512 envs, batch 128, 32 x 4, ring 200 000, prefill 20,
              bandwidth 2.0); ``sac.train`` on the Go2 joystick's 'state'
              entry (SelectObservationWrapper) at its SAC table (4096
              envs, batch 512, 512-256-128, ring 1 000 000, prefill 12 of
              the table's 49).
              Each: prefill seconds, training/sps, actor-step and SGD-step
              ms (CUDA events, no synchronise), the loss metrics, the
              ring's size, position and bytes on the card; fails on a
              non-finite metric, on env steps, normalizer count or ring
              size other than the actor steps give, on parameters or log α
              left unchanged, on target critics other than the τ update of
              the last step, on launch counts other than the substeps give
              (see sac_checks).  The kernels of the control step after
              training (K1, K2, K3 at B 1024 and 512; K1, K4 at B 4096)
              under phase
              2's criteria at every E; the first SGD step replayed on the
              card and on the CPU in fp32 and float64 (sac_sgd_check; in
              the RSR run also the penalty's own gradient); one SGD step
              under the profiler; the evaluator after the cube-push and Go2
              runs.  Then logs/cube_sac_500k_r5's policy served through
              ``sac_networks.make_policy`` on cube-push, B 2048, 10 control
              steps, as phase 3's rollout.
  9. tpush+dr (a) T-push served: ``envs.load('AirbotTPush')``,
              ``wrap_for_training`` at B = 2048, the seeded policy; K1 (n 14),
              K2 (720 slots -> 32, keys in shared memory) and K3 (nv 14, 223
              rows, the run-time width route) on one control step's inputs
              under phase 2's checks at every E, with the shared memory of
              the E chosen; 256 envs against the CPU in fp32 and float64; 10
              control steps and one under the profiler (tpush_phase).
              (b) ``ppo.train`` on T-push at the Airbot table (8 of its
              32 minibatches) for one training step, with phase 4's checks
              and evaluator.  (c) and (d) ``ppo.train`` with
              ``randomization_fn=envs.get_domain_randomizer(...)`` on
              cube-push (1024 envs, 8 of 32 minibatches) and on the Go2
              joystick (8192) for one training step each: the
              randomised fields on the card within their ranges and
              distinct across envs, every other leaf nominal, no
              randomisation in the evaluator; the terminated share; K1, K2
              (Fd 26) and K3, or K1 and K4, on the randomised substep's
              inputs at every E; env i keeps model i through an auto-reset
              (dr_train_phase).
 10. go2 tasks ``Go2Getup`` (logs/go2_getup_5M_r5), ``Go2Handstand``
              (logs/go2_handstand_5M_r5), ``Go2Footstand`` (a seeded
              512-256-128 policy: none is trained) and
              ``Go2JoystickRoughTerrain`` (logs/go2_joystick_50M_r5, the flat
              policy on the reference terrain), each served at B = 8192 for
              10 control steps of 5 substeps (go2_tasks_phase): the reset
              timed (getup's: a forward and 125 settle substeps, its
              launches counted); K4 at nv 18, R0 366 on getup's recorded
              inputs at 1 x 5 and 6 x 6, at every E that fits, on B - 3
              envs and the first 5 (check_k4_full), at every E on
              handstand's and footstand's; K1 and K4 (R0 58) on rough
              terrain's; 256 envs of each task against the CPU in fp32 and
              float64 for 3 control steps (getup from the served batch's
              first 256 envs, settled on the card, handed over); the
              rollout's rates, launches (K1 and K4 once a substep), share
              upright at the end (getup) and share terminated; for getup
              and rough terrain one control step under the profiler, host
              ms per stage with narrowphase_leaves first.  Then one PPO
              step of getup at its table (8192 envs; launches S + 126 of K1
              and K4, the settle included) with phase 6's checks, K4 held
              as check_k4_full holds it, and the evaluator.
 11. cli      (a) ``eval_policy.main`` on logs/cube_ppo_15M_r4 and
              ``eval_go2.main`` on getup (logs/go2_getup_5M_r5), 128
              episodes x 10 control steps each, the summaries printed and
              finite (cli_phase); each run's launches counted from zero,
              only its path's kernels launched; (b) one PPO and one SAC
              run on cube-push at 256 envs (world1_phase) with no process
              group and in an NCCL group of one started here: the trained
              parameters and the normalizer the same bits.  Groups of more
              than one run only in the gloo tests on the CPU.
 12. deploy   (a) ``deploy.PolicyInference`` on logs/cube_ppo_15M_r4 and
              logs/cube_sac_500k_r5 (``algorithm='sac'``), on the card and
              on the CPU, over 200 rows of the demo's observation files
              (data_rsr_demo/: real_obs.txt holds 51, the four files 204):
              raw actions within 1e-5, the action log one row a call; the
              warm latency of one ``get_action`` (median, p99); the
              cube-push control loop (50 steps, the PPO policy) and the
              T-push loop (20 steps, phase 9's seeded policy written by
              ``checkpoint.save_params`` and read back) against stub arms,
              their joint couplings and limits (deploy_phase).  (b) The
              render rollouts at B 1, 15 control steps each: cube-push
              through ``rendering.rollout_qpos`` and the joystick through
              ``eval_go2.video_rollout`` (command and heading recorded),
              each held to the CPU in fp32 by phase 3's elementwise
              criterion at every step before the CPU's own fp32 rollout
              parts from float64 (both gaps to float64 printed), and each
              kernel of their last substep at B 1 under phase 2's criteria
              (render_phase); not rasterised.  (c)
              ``bench_scaling.main`` at one device, 1024 envs, 5 control
              steps of warm-up and 2 x 5 timed, a finite rate.
 13. result   one JSON line of the kernels (launches of every path; K1 on
              the Go2 tasks, K4 at R0 366 and each kernel at B 1 with
              entries of their own), the card's name and power limit, and
              last the line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import math
import os
import subprocess
import sys
import time

from benchmark.roofline import K1, K2, K3, K4, peaks

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, 'logs', 'cube_ppo_15M_r4', 'final_params.pkl')
ENV = 'AirbotCubePushTrain'
ENVS = 2048  # the cube_push.rollout cell's batch
# control steps of the cube-push (and T-push) rollout, 4 substeps each; cut
# from 20 to 10 once phase 9 came, to keep the script within 12 minutes
STEPS = 10
GO2_PARAMS = os.path.join(ROOT, 'logs', 'go2_joystick_50M_r5',
                          'final_params.pkl')
GO2_ENV = 'Go2JoystickFlatTerrain'
GO2_ENVS = 8192  # num_envs of the tuned joystick config
# the joystick's asymmetric actor-critic: policy and value observation keys
GO2_KEYS = {'obs_key': 'state', 'value_obs_key': 'privileged_state'}
# control steps of the Go2 rollout, 5 substeps each; cut from 50 to 25 once
# phase 9 came, and to 15 once phase 10 came, to keep the script within 12
# minutes
GO2_STEPS = 15
# a trained policy does not fall within half a second: at most this share
# of the envs may terminate within GO2_STEPS control steps
GO2_MAX_DONE_SHARE = 0.05
SEED = 0
DEV = 'cuda'  # every phase runs on the card
REF_ENVS = 256  # envs of the batch run also on the CPU, fp32 and float64
# PPO training steps of the tuned cube-push config (81920 env-steps each;
# cut from 2 to keep the script within 12 minutes once phase 8 came)
TRAIN_STEPS = 1
EVAL_ENVS = 128  # the evaluator's envs after training (ppo.train's default)
# control steps of its episode, cut from 1200 (Go2: 1000) to 25, to 10 once
# phase 9 came and to 5 once phase 11 came, to keep the script within 12
# minutes
EVAL_STEPS = 5
RSR_ENV = 'AirbotCubePush'  # the RSR CLI's default env (the rsr variant)
RSR_DATA = os.path.join(ROOT, 'data_rsr_demo')
# at the demo's default bandwidth 0.1 every KDE on the grid is one-hot and
# the penalty is identically zero; at 2.0 its gate is open
RSR_BANDWIDTH = 2.0
RSR_STEPS = 1  # RSR training steps (10240 env-steps at 512 envs)
# the training steps of RSR (phase 5), T-push and cube-push with domain
# randomisation (phase 9) take this many of their tables' 32 minibatches
# of the batch size: 2 of their 8 unrolls, cut once phase 11 came, to keep
# the script within 12 minutes (cube-push's own step, phase 4, keeps 32)
SHORT_MINIBATCHES = 8
# the RSR CLI's PPO width (policy_params_training's defaults at 512 envs),
# its minibatches cut to SHORT_MINIBATCHES
RSR_SIZES = dict(num_envs=512, batch_size=128, unroll_length=10,
                 num_minibatches=SHORT_MINIBATCHES, num_updates_per_batch=8)
GO2_TRAIN_STEPS = 1  # Go2 PPO training steps (163840 env-steps at 8192)

KERNELS = {
    # wrapper name: (short name, source, TPU kernel it replaces)
    'spd_solve_lanes': (
        'K1', 'rsr_mjx_tpu_torch/csrc/spd_solve.cu',
        'rsr_mjx_tpu/physics/linalg_kernels.py:108'),
    'contact_select_lanes': (
        'K2', 'rsr_mjx_tpu_torch/csrc/contact_select.cu',
        'rsr_mjx_tpu/physics/linalg_kernels.py:421'),
    'newton_lanes_pyr_t': (
        'K3', 'rsr_mjx_tpu_torch/csrc/newton_pyr.cu',
        'rsr_mjx_tpu/physics/linalg_kernels.py:702'),
    '_newton_lanes_core': (
        'K4', 'rsr_mjx_tpu_torch/csrc/newton_generic.cu',
        'rsr_mjx_tpu/physics/linalg_kernels.py:878'),
}
# the device kernels each wrapper launches, by their names in a trace
DEVICE_KERNELS = {
    'spd_solve_lanes': ('spd_solve_kernel', 'spd_solve_thread_kernel'),
    'contact_select_lanes': ('contact_select_kernel',),
    'newton_lanes_pyr_t': ('newton_pyr_kernel',),
    '_newton_lanes_core': ('newton_generic_kernel',),
}


def log(*a):
  print(*a, flush=True)


def card_line() -> str:
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, timeout=60, check=True,
  )
  return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
  """Mean device time of fn() over reps calls, by CUDA events."""
  for _ in range(warmup):
    fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def profiler_ms(torch, fn, reps: int, kernel_name: str) -> float:
  """Mean device time of the kernels whose name contains ``kernel_name``
  over reps calls of fn(), from torch.profiler: the kernel alone, without
  the host time between launches that CUDA events include.  A trace that
  does not hold all reps launches is taken again; after three such traces
  the CUDA-event time is returned instead, and a line says so."""
  from torch.profiler import ProfilerActivity, profile

  fn()
  for _ in range(3):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel_name in e.key]
    count = sum(e.count for e in hits)
    if count == reps:
      return sum(e.self_device_time_total for e in hits) / 1e3 / count
  log(f'profiler: {count} launches of {kernel_name} traced, expected {reps}; '
      'CUDA-event time used instead')
  return time_ms(torch, fn, reps)


def profiler_total_ms(torch, fn, reps: int) -> float:
  """Mean summed device time of every kernel that fn() launches, from
  torch.profiler: the device time of a call made of several library
  kernels, to set beside a kernel's ``profiler_ms``."""
  from torch.profiler import ProfilerActivity, profile

  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / reps


def schedule_split(torch, tag, run, iters: int, ls_iters: int,
                   kernel_name: str) -> None:
  """Device times of a Newton kernel (torch.profiler, by kernel name: at
  0 x 0 the wrapper's host time per launch exceeds the kernel's) at the
  schedules 0 x 0, 1 x 0, 1 x ls and iters x ls on the same inputs
  (``run(iters, ls_iters)`` launches it): the differences are the time of
  load and store, of one Newton step without line search, and of one
  line-search step."""
  scheds = [(0, 0), (1, 0), (1, ls_iters)]
  if iters > 1:
    scheds.append((iters, ls_iters))
  ms = {s: profiler_ms(torch, lambda s=s: run(*s), 20, kernel_name)
        for s in scheds}
  log(f'{tag} schedule split, profiler ms: ' + ', '.join(
      f'{a} x {b} {t:.5f}' for (a, b), t in ms.items())
      + f'; load+store {ms[0, 0]:.5f}, Newton step without line search '
      f'{ms[1, 0] - ms[0, 0]:.5f}, one line-search step '
      f'{(ms[1, ls_iters] - ms[1, 0]) / max(ls_iters, 1):.5f}')


@contextlib.contextmanager
def force_E(lk, E, seen=None):
  """Within the block every wrapper takes E envs per block wherever E is one
  of its candidates and fits (else its own choice; E None: always its own
  choice).  ``seen`` receives the last call's chosen E and the Es that fit."""
  chooser = lk.envs_per_block

  def pick(smem_bytes, B, n_sm, candidates=(8, 4, 2, 1)):
    chosen = chooser(smem_bytes, B, n_sm, candidates)
    fits = [c for c in candidates if smem_bytes(c) <= lk._SMEM_LIMIT]
    if seen is not None:
      seen.update(chosen=chosen, fits=fits)
    return E if E in fits else chosen

  lk.envs_per_block = pick
  try:
    yield
  finally:
    lk.envs_per_block = chooser


def e_sweep(torch, lk, tag, fn, kernel_name: str) -> None:
  """Device time (torch.profiler) of a kernel at each E (envs per block)
  among its wrapper's candidates whose working set fits, and the E the
  wrapper chooses; fn() launches it."""
  seen, times = {}, {}
  with force_E(lk, None, seen):
    fn()
  for E in seen['fits']:
    with force_E(lk, E):
      times[E] = profiler_ms(torch, fn, 10, kernel_name)
  log(f'{tag} envs per block: chosen E {seen["chosen"]}; profiler ms by E: '
      + ', '.join(f'E {E} {t:.5f}' for E, t in times.items()))


# -- the least time of each kernel: benchmark/roofline at a call's shape ---

ROOFLINE = {'K1': K1, 'K2': K2, 'K3': K3, 'K4': K4}


def call_shape(name, args):
  """(K1 ... K4, the ``shape`` that kernel's ``benchmark/roofline`` module
  takes, the batch B) of one call of the kernel wrapper ``name`` with
  ``args``, as ``record_calls`` keeps them."""
  if name == 'spd_solve_lanes':
    n, B = args[1].shape
    return 'K1', {'n': n}, B
  if name == 'contact_select_lanes':
    _, nsel, _, feat_dyn, ptab = args
    ncon, Fd, B = feat_dyn.shape
    Ptot, nst = ptab.shape
    return 'K2', {'ncon': ncon, 'nsel': nsel, 'Fd': Fd, 'Ptot': Ptot,
                  'nst': nst}, B
  if name == 'newton_lanes_pyr_t':
    nv, Rs, B = args[6].shape
    return 'K3', {'iters': args[0], 'ls_iters': args[1], 'nv': nv, 'Rs': Rs,
                  'NU': args[10].shape[1], 'C': args[12].shape[0],
                  'naxes': args[13]}, B
  if name == '_newton_lanes_core':
    nv, R, B = args[6].shape
    return 'K4', {'iters': args[1], 'ls_iters': args[2], 'nv': nv,
                  'R': R}, B
  raise ValueError(f'no kernel wrapper {name}')


def kernel_work(name, args):
  """(bytes, FLOPs) of that call."""
  short, shape, B = call_shape(name, args)
  return ROOFLINE[short].work(shape, B)


def least_ms(nbytes, flops):
  """(the least time in ms of a call of that work, the term that sets it:
  'bytes' or 'operations')."""
  by_bytes = nbytes / peaks.HBM_BYTES_S >= flops / peaks.FP32_FLOP_S
  return (peaks.bound_s(nbytes, flops) * 1e3,
          'bytes' if by_bytes else 'operations')


# -- phases ------------------------------------------------------------------


def record_calls(lk, fn, keep=None):
  """Run fn() with the kernel wrappers recording their arguments (of the
  last ``keep`` calls of each wrapper; all calls by default).  The physics
  substeps run eagerly meanwhile, since a substep replayed from a CUDA
  graph (``physics/graphed.py``) calls no wrapper: fn() is a short call
  beside the path measured (a control step, ``record_last_step``), not the
  path itself."""
  calls = {name: [] for name in KERNELS}
  real = {name: getattr(lk, name) for name in KERNELS}
  graphed = sys.modules.get(lk.__name__.rpartition('.')[0] + '.graphed')
  on_card = graphed and graphed._on_card
  if graphed:
    graphed._on_card = lambda d: False

  def recorder(name):
    def rec(*args):
      calls[name].append(args)
      if keep is not None:
        del calls[name][:-keep]
      return real[name](*args)
    return rec

  for name in KERNELS:
    setattr(lk, name, recorder(name))
  try:
    fn()
  finally:
    for name, f in real.items():
      setattr(lk, name, f)
    if graphed:
      graphed._on_card = on_card
  return calls


def last_step_args(fn, a, k, out):
  """(env, the state it ended in, policy, generator, extra_fields) of a
  call ``fn(*a, **k) -> out`` of ``acting.generate_unroll`` or
  ``acting.actor_step``: the arguments of one more ``actor_step`` from
  where it ended.  None for an evaluation's."""
  if 'eval_metrics' in out[0].info:
    return None
  b = inspect.signature(fn).bind(*a, **k).arguments
  return (b['env'], out[0], b['policy'], b['generator'],
          b.get('extra_fields', ()))


def record_last_step(lk, port, last, keep=2):
  """record_calls of one eager control step (``acting.actor_step``) from
  ``last`` (``last_step_args`` of the last training rollout): the kernels'
  inputs at the training batch, where training replays graphs and calls
  no wrapper."""
  if last is None:
    raise SystemExit('no training rollout was recorded')
  return record_calls(lk, lambda: port.acting.actor_step(*last), keep=keep)


def per_env_max(x):
  """max |x| of each env (the trailing axis) over all other axes."""
  return x.abs().reshape(-1, x.shape[-1]).amax(0)


def k3_cost(torch, lk, args, x):
  """The objective K3 minimises, per env, in float64: ½(x−a0)ᵀM(x−a0) plus
  the structured rows' and the contact pyramid's penalties."""
  (_, _, kind_s, Mt, a0t, _, Js, arefs, Ds, fls, U, arefU, Dc,
   naxes) = [a.double() if torch.is_tensor(a) else a for a in args]
  x = x.double()
  ones_m, fric_m = lk._row_masks(tuple(kind_s.tolist()), x.device,
                                 torch.float64)
  xa = x - a0t
  phi = 0.5 * (xa * (Mt * xa[None]).sum(1)).sum(0)
  rs = (Js * x[:, None]).sum(0) - arefs
  phi = phi + lk._penalty_cost_rows(rs, Ds, fls, ones_m[:, None],
                                    fric_m[:, None]).sum(0)
  rU = (U * x[:, None]).sum(0) - arefU
  C = Dc.shape[0]
  for i in range(naxes):
    ri = rU[(1 + i) * C:(2 + i) * C]
    for r in (rU[:C] + ri, rU[:C] - ri):
      phi = phi + (0.5 * Dc * r * r * (r < 0)).sum(0)
  return phi


U32 = 2.0 ** -24  # unit roundoff of float32


def k3_split(torch, args, force):
  """K3's force rows [structured | contact, axis, ±] → (structured (Rs, B),
  basis weights w (NU, B) with qfrc = Js·fs + U·w), as the kernel forms
  them: w = [Σ_axes (f₊ + f₋) | f₊ − f₋ per axis]."""
  naxes, Dc, Rs = args[13], args[12], args[6].shape[1]
  C, B = Dc.shape
  fc = force[Rs:].reshape(C, naxes, 2, B)
  fp, fm = fc[:, :, 0], fc[:, :, 1]
  w = torch.cat([(fp + fm).sum(1)] + [fp[:, i] - fm[:, i]
                                      for i in range(naxes)], dim=0)
  return force[:Rs], w


def k3_force_scale(torch, args, x):
  """Per force row, its stiffness times the size of the terms its residual
  is summed from, D·(Σ|J||x| + |aref|): the scale of its fp32 rounding."""
  (_, _, _, _, _, _, Js, arefs, Ds, _, U, arefU, Dc,
   naxes) = [a.double() if torch.is_tensor(a) else a for a in args]
  ax = x.double().abs()[:, None]
  s_rows = Ds * ((Js.abs() * ax).sum(0) + arefs.abs())
  rU = (U.abs() * ax).sum(0) + arefU.abs()
  C, B = Dc.shape
  s_con = torch.stack([Dc * (rU[:C] + rU[(1 + i) * C:(2 + i) * C])
                       for i in range(naxes)], dim=1)  # (C, naxes, B)
  s_con = s_con[:, :, None].expand(C, naxes, 2, B).reshape(-1, B)
  return torch.cat([s_rows, s_con], dim=0)


def worst(err, tol):
  return (err / tol).max().item()


def worst_kernel(torch, err, tol, err_plain):
  """The kernel's worst error/tolerance.  Where the plain fp32 version
  itself misses the tolerance against float64 (a step that fp32 rounding
  rejects and float64 accepts: the criterion's fault, not a kernel's), the
  kernel is held to twice the plain version's miss instead."""
  return worst(err, torch.where(err_plain > tol, 2 * err_plain, tol))


def k1_ratios(torch, lk, At, bt):
  """K1 on one (A, b), per env: max|k − p| <= 1e-5·max|p| + 1e-6, and the
  normwise backward error ‖Ax − b‖ / (‖A‖‖x‖ + ‖b‖), in float64, <= 1e-6 (a
  Cholesky solve is backward stable: fp32 gives ~n·eps whatever A's
  condition number).  Returns (max |k − p|, worst error/tolerance over
  envs: [kernel, kernel backward, plain backward, plain vs float64])."""
  xk, xp = lk.spd_solve_lanes(At, bt), lk.spd_solve_plain(At, bt)
  x64 = lk.spd_solve_plain(At.double(), bt.double())
  ratios = [worst(per_env_max(xk - xp), 1e-5 * per_env_max(xp) + 1e-6)]
  for x in (xk, xp):
    res = torch.einsum('ijb,jb->ib', At.double(), x.double()) - bt.double()
    eta = per_env_max(res) / (
        At.double().abs().sum(1).amax(0) * per_env_max(x.double())
        + per_env_max(bt.double()))
    ratios.append(worst(eta, torch.full_like(eta, 1e-6)))
  ratios.append(worst(per_env_max(xp.double() - x64),
                      1e-5 * per_env_max(x64) + 1e-6))
  if not bool(torch.isfinite(xk).all().item()):
    ratios[0] = float('inf')
  return (xk - xp).abs().max().item(), ratios


def cut_batch(torch, args, envs):
  """The recorded arguments of a wrapper with the batch (the trailing axis
  of every tensor) cut to the slice ``envs`` and made contiguous."""
  return tuple(a[..., envs].contiguous() if torch.is_tensor(a) else a
               for a in args)


def ragged(torch, args, drop: int = 3):
  """The recorded arguments with the last ``drop`` envs cut off: a batch
  that is no multiple of the envs per block."""
  return cut_batch(torch, args, slice(None, -drop))


def cuts(B):
  """The smaller batches a kernel is also checked on: cut by 3 envs
  (where B > 3: phase 12's batches of one have none) and the first 5."""
  return ((('ragged', slice(None, -3)),) if B > 3 else ()) + (
      ('first 5', slice(None, 5)),)


def k1_row(torch, lk, tag, systems):
  """K1 on each (A, b) of ``systems`` under k1_ratios' criteria; on the last
  one also at every E that fits (both decompositions at the widths that have
  both), on the batch cut by 3 envs and on its first 5 envs, and with the
  triangle that the function never reads filled with NaN, where x must be,
  bit for bit, the x of the clean matrix (the plain version cannot take that
  input: it masks by multiplying with 0).  Times on the last system."""
  err, ratios = 0.0, []
  for At, bt in systems:
    e, r = k1_ratios(torch, lk, At, bt)
    err, ratios = max(err, e), ratios + r
  At, bt = systems[-1]
  n, B = bt.shape
  lo = torch.tril_indices(n, n, -1, device=At.device)
  A_nan = At.clone()
  A_nan[lo[0], lo[1]] = float('nan')
  seen, parts, extra_ok = {}, [], True
  with force_E(lk, None, seen):
    lk.spd_solve_lanes(At, bt)
  for E in seen['fits']:
    with force_E(lk, E):
      r = k1_ratios(torch, lk, At, bt)[1][0]
      same = torch.equal(lk.spd_solve_lanes(A_nan, bt),
                         lk.spd_solve_lanes(At, bt))
    parts.append(f'E {E} {r:.3g}{"" if same else " NaN-triangle DIFFERS"}')
    extra_ok = extra_ok and r <= 1.0 and same
  for what, envs in cuts(B):
    a, b = cut_batch(torch, (At, bt), envs)
    r = k1_ratios(torch, lk, a, b)[1]
    parts.append(f'{what} (B {b.shape[1]}) {max(r[:2]):.3g}')
    extra_ok = extra_ok and max(r[:2]) <= 1.0
  log(f'K1 {tag}: kernel error/tolerance at each E, NaN in the unread '
      f'triangle bit-identical at each, ragged and tiny batches: '
      + ', '.join(parts) + (' ok' if extra_ok else ' FAIL'))
  run = lambda: lk.spd_solve_lanes(At, bt)
  e_sweep(torch, lk, f'K1 {tag}', run, 'spd_solve_')
  A_bm = At.permute(2, 0, 1).contiguous()
  b_bm = bt.t().contiguous()[..., None]
  library = lambda: torch.cholesky_solve(b_bm, torch.linalg.cholesky(A_bm))
  return dict(
      max_abs_err=err, ok=max(ratios) <= 1.0 and extra_ok,
      ratios=f'kernel {max(ratios[0::4]):.3g}, kernel backward '
             f'{max(ratios[1::4]):.3g}, plain backward '
             f'{max(ratios[2::4]):.3g}, plain vs f64 {max(ratios[3::4]):.3g}',
      work=kernel_work('spd_solve_lanes', (At, bt)),
      ms=time_ms(torch, run, 50),
      profiler_ms=profiler_ms(torch, run, 50, 'spd_solve_'),
      plain_ms=time_ms(torch, lambda: lk.spd_solve_plain(At, bt), 10),
      library_ms=time_ms(torch, library, 50),
      library_device_ms=profiler_total_ms(torch, library, 20),
      note=f'n {n}, B {B}; per env: |k-p| <= 1e-5*max|p| + 1e-6; backward '
           'error <= 1e-6',
  )


def spd_systems(torch, rng, n, B):
  """Seeded SPD systems in lanes layout on the card: A (n, n, B), b (n, B)."""
  import numpy as np

  R = rng.normal(size=(B, n, n))
  A = R @ np.swapaxes(R, 1, 2) / n + 0.05 * np.eye(n)
  f32 = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=DEV)
  return f32(np.transpose(A, (1, 2, 0))), f32(rng.normal(size=(n, B)))


def check_k1_widths(torch, lk):
  """K1 at widths that are not compiled in (the same solve in shared memory
  with n at run time), on seeded SPD systems at a batch that is no multiple
  of any E, under k1_ratios' criteria.  Then seeded systems of width 20 at
  two batches on either side of the switch between its two decompositions:
  the same criteria at the chosen E, and its time at every E."""
  import numpy as np

  rng = np.random.default_rng(SEED)
  parts, ok = [], True
  for n in (1, 7, 31, 32):
    r = k1_ratios(torch, lk, *spd_systems(torch, rng, n, 301))[1]
    parts.append(f'n {n} {max(r[:2]):.3g}')
    ok = ok and max(r[:2]) <= 1.0
  log('K1 at widths not compiled in, B 301: worst error/tolerance: '
      + ', '.join(parts) + (' ok' if ok else ' FAIL'))
  if not ok:
    raise SystemExit('K1 disagrees at a width not compiled in')
  # where the warp per env (E <= 8) and the thread per env (E = 32) cross
  for B in (3072, 16384):
    At, bt = spd_systems(torch, rng, 20, B)
    r = k1_ratios(torch, lk, At, bt)[1]
    log(f'K1 seeded systems, n 20, B {B}: worst error/tolerance '
        f'{max(r[:2]):.3g}' + (' ok' if max(r[:2]) <= 1.0 else ' FAIL'))
    if max(r[:2]) > 1.0:
      raise SystemExit('K1 disagrees on seeded systems')
    e_sweep(torch, lk, f'K1 seeded systems, n 20, B {B}',
            lambda: lk.spd_solve_lanes(At, bt), 'spd_solve_')


def check_k2_sizes(torch, lk):
  """K2 on seeded inputs with exact ties, exact against the plain version
  (the gathered rows and the picked slots):
  a number of slots that is no multiple of 32, all slots selected
  (nsel == ncon), more than 512 slots (the keys in shared memory instead of
  registers), batches that are no multiple of any E; some dists are +inf,
  -0 beside +0, and NaN, which the kernel counts as +inf (the plain version
  is given them as +inf)."""
  import numpy as np

  rng = np.random.default_rng(SEED)
  parts, ok = [], True
  for ncon, nsel, B in ((100, 24, 301), (100, 100, 13), (33, 33, 2045),
                        (1000, 24, 301), (513, 513, 13)):
    d = np.round(rng.uniform(-0.01, 0.3, size=(ncon, B)) * 20) / 20
    d[3], d[5, ::2], d[0, 1::3], d[2, 1::3] = np.inf, np.nan, -0.0, 0.0
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=DEV)
    dist, feat = f32(d), f32(rng.normal(size=(ncon, 13, B)))
    ptab = f32(rng.normal(size=(ncon, 33)))
    struct = ((ncon, 1, 0),)
    same = all(torch.equal(k, p) for k, p in zip(
        lk.contact_select_lanes(struct, nsel, dist, feat, ptab),
        lk.contact_select_plain(struct, nsel,
                                torch.nan_to_num(dist, nan=float('inf'),
                                                 posinf=float('inf'),
                                                 neginf=-float('inf')),
                                feat, ptab)))
    parts.append(f'ncon {ncon} nsel {nsel} B {B} '
                 f'{"exact" if same else "DIFFERS"}')
    ok = ok and same
  log('K2 on seeded inputs with ties, inf, -0 and NaN: ' + ', '.join(parts)
      + (' ok' if ok else ' FAIL'))
  if not ok:
    raise SystemExit('K2 disagrees with its plain version')


def k2_row(torch, lk, args, tag='cube-push'):
  """K2 on the recorded selection: exact equality with the plain version
  (the gathered rows, and the picked slots, which must be equal too) on the
  recorded dist and on dist rounded to exact ties, each also at every E
  that fits, on the batch cut by 3 envs and on its first 5 envs.  Times on
  the recorded inputs, and the time at each E also on the batch tiled to
  8192 envs."""
  pair_struct, nsel, dist_l, feat_dyn, ptab = args
  tied = (torch.round(dist_l * 20) / 20).contiguous()

  def differs(a):
    (sk, pk), (sp, pp) = lk.contact_select_lanes(*a), lk.contact_select_plain(*a)
    return (sk - sp).abs().max().item() if torch.equal(pk, pp) else math.inf
  seen, err, parts = {}, 0.0, []
  with force_E(lk, None, seen):
    lk.contact_select_lanes(*args)
  for d in (dist_l, tied):
    a = (pair_struct, nsel, d, feat_dyn, ptab)
    for E in seen['fits']:
      with force_E(lk, E):
        err = max(err, differs(a))
    for _, envs in cuts(dist_l.shape[-1]):  # ptab has no batch
      err = max(err, differs(a[:2] + cut_batch(torch, a[2:4], envs) + a[4:]))
  ncon, Fd, B = feat_dyn.shape
  slot_pair = lk._slot_pair(pair_struct, dist_l.device).long()

  def topk_gather():
    idx = torch.topk(dist_l, nsel, dim=0, largest=False, sorted=True).indices
    dyn = torch.gather(feat_dyn, 0, idx[:, None, :].expand(nsel, Fd, B))
    return dyn, ptab[slot_pair[idx]]

  run = lambda: lk.contact_select_lanes(*args)
  name = 'contact_select_kernel'
  e_sweep(torch, lk, f'K2 {tag}, B {B}', run, name)
  big = tuple(torch.cat([a] * (GO2_ENVS // B), dim=-1).contiguous()
              if torch.is_tensor(a) and a is not ptab else a for a in args)
  e_sweep(torch, lk, f'K2 {tag} inputs tiled to B {big[2].shape[-1]}',
          lambda: lk.contact_select_lanes(*big), name)
  n_tied = int((tied[:-1] == tied[1:]).sum().item())
  return dict(
      max_abs_err=err, ok=err == 0.0, ratios='exact',
      work=kernel_work('contact_select_lanes', args),
      ms=time_ms(torch, run, 50),
      profiler_ms=profiler_ms(torch, run, 50, name),
      plain_ms=time_ms(torch, lambda: lk.contact_select_plain(*args), 10),
      library_ms=time_ms(torch, topk_gather, 50),
      library_device_ms=profiler_total_ms(torch, topk_gather, 20),
      note=f'rows and picks exact, at every E ({seen["fits"]}), on '
           + ' and '.join(f'{min(B, 5) if w == "first 5" else B - 3}'
                          for w, _ in cuts(B))
           + f' envs; tie case has {n_tied} equal neighbouring slots',
  )


def k4_cost(torch, lk, args, x):
  """The objective K4 minimises, per env, in float64:
  ½(x−a0)ᵀM(x−a0) + Σ sᵢ(Jᵢx − arefᵢ)."""
  kind = args[0]
  Mt, a0t, _, Jt, areft, Dt, flt = (a.double() for a in args[3:])
  x = x.double()
  ones_m, fric_m = lk._row_masks(tuple(kind.tolist()), x.device,
                                 torch.float64)
  xa = x - a0t
  phi = 0.5 * (xa * (Mt * xa[None]).sum(1)).sum(0)
  r = (Jt * x[:, None]).sum(0) - areft
  return phi + lk._penalty_cost_rows(r, Dt, flt, ones_m[:, None],
                                     fric_m[:, None]).sum(0)


def k4_ratios(torch, lk, args, schedules, one_step_done=None,
              first_order=None):
  """K4 on one system (the arguments of ``_newton_lanes_core``), per env,
  at each (Newton, line-search) schedule, under K3's criteria:
   - φ(xk) − φ(x64) <= tol·φ(x0), φ >= 0 in float64, x64 the plain version's
     result in float64 (x is held by the objective it reaches: fp32
     rounding moves x along the directions where φ is flat).  tol is 1e-6
     after several Newton steps, as for K3, and 1e-5 after a single one:
     there x is not at the minimum, so φ changes to first order with the
     rounding of the step and of the line-search t (the plain fp32 version
     is past 1e-6 on the Go2 rows as well);
   - force: |fk − f(xk)| <= 1024·u·D(Σ|J||xk| + |aref|) row by row, f(xk)
     the plain version run for 0 steps from xk in float64;
   - qfrc: |qk − Jᵀfk| <= 64·u·|J|ᵀ|fk|.
  Returns (max |kernel − plain|, {(who, schedule): (φ, force, qfrc) worst
  error/tolerance over envs}) for the kernel and the plain fp32 version.
  Only the kernel's ratios decide; see worst_kernel for the envs in which
  the plain version itself misses.  With ``one_step_done`` (a dict), an
  env whose float64 solve is done after its first Newton step (later steps
  lower φ by under 1e-7·φ(x0)) is held to the one-step tolerance at every
  schedule, as k3_ratios holds K3 (the fp32 accept test cannot resolve
  that step's rounding); the dict receives the number of such envs.  With
  ``first_order`` (a dict), a schedule of one Newton step adds to the φ
  tolerance the first-order change of φ under a perturbation of x by 1024
  units of fp32 rounding (the force check's allowance),
  1024·u·Σ|∇φ(x64)||x64|: after one step x is not at the minimum, and
  with many stiff rows (the full-collision scene's 366) the rounding of x
  moves φ past 1e-5·φ(x0) in a few envs of 8192, for the plain fp32
  version as for the kernel; the dict receives the number of envs in
  which the kernel needed it."""
  kind = args[0]
  a64 = [a.double() for a in args[3:]]
  Jt, areft, Dt = a64[3], a64[4], a64[5]
  phi0 = k4_cost(torch, lk, args, args[5])
  err, ratios = 0.0, {}
  phi64_1 = None
  if one_step_done is not None:
    phi64_1 = k4_cost(torch, lk, args, lk.newton_generic_plain(
        kind, 1, schedules[0][1], *a64)[0])
  for sched in schedules:
    x64 = lk.newton_generic_plain(kind, *sched, *a64)[0]
    phi64 = k4_cost(torch, lk, args, x64)
    tol_phi = (1e-5 if sched[0] == 1 else 1e-6) * phi0 + 1e-30
    if phi64_1 is not None and sched[0] > 1:
      done1 = phi64_1 - phi64 <= 1e-7 * phi0
      one_step_done[sched] = int(done1.sum().item())
      tol_phi = torch.where(done1, 1e-5, 1e-6) * phi0 + 1e-30
    tol_phi_base = tol_phi
    if first_order is not None and sched[0] == 1:
      ones_m, fric_m = lk._row_masks(tuple(kind.tolist()), x64.device,
                                     torch.float64)
      s64 = lk._penalty_se((Jt * x64[:, None]).sum(0) - areft, Dt, a64[6],
                           ones_m[:, None], fric_m[:, None])[0]
      g64 = (a64[0] * (x64 - a64[1])[None]).sum(1) + (Jt * s64[None]).sum(1)
      tol_phi = tol_phi + 1024 * U32 * (g64.abs() * x64.abs()).sum(0)
    outs = {'plain': lk.newton_generic_plain(kind, *sched, *args[3:]),
            'kernel': lk._newton_lanes_core(kind, *sched, *args[3:])}
    err = max([err] + [(k - p).abs().max().item()
                       for k, p in zip(outs['kernel'], outs['plain'])])
    for who, out in outs.items():
      x, force, qfrc = (o.double() for o in out)
      f_x = lk.newton_generic_plain(kind, 0, sched[1], a64[0], a64[1], x,
                                    *a64[3:])[1]
      tol_f = 1024 * U32 * Dt * ((Jt.abs() * x.abs()[:, None]).sum(0)
                                 + areft.abs()) + 1e-30
      proj = (Jt * force[None]).sum(1)
      tol_q = 64 * U32 * (Jt.abs() * force.abs()[None]).sum(1) + 1e-30
      errs = (k4_cost(torch, lk, args, x) - phi64, (force - f_x).abs(),
              (qfrc - proj).abs())
      tols = (tol_phi, tol_f, tol_q)
      if who == 'plain':
        plain_errs = errs
        ratios[who, sched] = tuple(worst(e, t) for e, t in zip(errs, tols))
      else:
        ratios[who, sched] = tuple(
            worst_kernel(torch, e, t, p)
            for e, t, p in zip(errs, tols, plain_errs))
        if first_order is not None and sched[0] == 1:
          first_order[sched] = int((errs[0] > tol_phi_base).sum().item())
  return err, ratios


def fmt_ratios(ratios):
  return 'phi/force/qfrc ' + ', '.join(
      f'{who} {it} x {ls} ' + '/'.join(f'{v:.3g}' for v in r)
      for (who, (it, ls)), r in ratios.items())


def k4_row(torch, lk, tag, args, schedules):
  """K4 on one recorded system at each of ``schedules`` under k4_ratios'
  criteria, on the batch cut by 3 envs at the first schedule, its time at
  each E and its row."""
  err, ratios = k4_ratios(torch, lk, args, schedules)
  ragged_ok = True
  if args[6].shape[-1] > 3:
    cut = ragged(torch, args)
    rerr, rratios = k4_ratios(torch, lk, cut, schedules[:1])
    ragged_ok = kernel_ok(rratios)
    log(f'K4 {tag} on a ragged batch (B {cut[6].shape[-1]}): max |kernel - '
        f'plain| {rerr:.3e}; {fmt_ratios(rratios)} '
        f'{"ok" if ragged_ok else "FAIL"}')
  run = lambda: lk._newton_lanes_core(*args)
  e_sweep(torch, lk, f'K4 {tag}', run, 'newton_generic_kernel')
  sched = schedules[0]
  return dict(
      max_abs_err=err,
      profiler_ms=profiler_ms(torch, run, 50, 'newton_generic_kernel'),
      ok=kernel_ok(ratios) and ragged_ok,
      ratios=fmt_ratios(ratios) + ('' if ragged_ok else ' (ragged FAIL)'),
      work=kernel_work('_newton_lanes_core', args),
      ms=time_ms(torch, run, 50),
      plain_ms=time_ms(torch, lambda: lk.newton_generic_plain(*args), 5, 1),
      library_ms=None,
      note=f'nv {args[6].shape[0]}, R0 {args[6].shape[1]}, B '
           f'{args[6].shape[2]}, schedule {sched[0]} x {sched[1]}; per '
           'env, at each schedule: phi(xk) within 1e-5 (1 Newton step) or '
           '1e-6 (6 steps) of the float64 solve; force and qfrc those of xk '
           'and of the force to fp32 rounding (1024u, 64u of their sums)',
  )


def kernel_ok(ratios):
  return max(max(r) for (who, _), r in ratios.items()
             if who == 'kernel') <= 1.0


def check_k4(torch, lk, go2_args, cube_args, cube_k3_args):
  """K4 on the Go2 rows of one substep (at the path's schedule and at
  6 x 6) and on the cube-push model's generic rows (6 x 6).  On the cube
  rows it also prints how far K4's objective is from K3's on the same
  states: both minimise the same φ."""
  sched = (go2_args[1], go2_args[2])
  row = k4_row(torch, lk, 'Go2', go2_args, [sched, (6, 6)])
  cerr, cratios = k4_ratios(torch, lk, cube_args, [(6, 6)])
  log(f'K4 on the cube-push generic rows (nv {cube_args[6].shape[0]}, R0 '
      f'{cube_args[6].shape[1]}, B {cube_args[6].shape[2]}): max |kernel - '
      f'plain| {cerr:.3e}; {fmt_ratios(cratios)}')
  x4 = lk._newton_lanes_core(cube_args[0], 6, 6, *cube_args[3:])[0]
  x3 = lk.newton_lanes_pyr_t(*cube_k3_args)[0]
  phi4 = k4_cost(torch, lk, cube_args, x4)
  phi3 = k4_cost(torch, lk, cube_args, x3)
  phi0 = k4_cost(torch, lk, cube_args, cube_args[5])
  gap = ((phi4 - phi3).abs() / (phi0 + 1e-30))
  log(f'K4 against K3 on the same cube-push states, 6 x 6: '
      f'|phi(x_K4) - phi(x_K3)| / phi(x0) per env max {gap.max().item():.3g} '
      f'median {gap.median().item():.3g}')
  cube_ok = kernel_ok(cratios)
  # the same on a batch that is no multiple of the envs per block
  cut = ragged(torch, cube_args)
  rerr, rratios = k4_ratios(torch, lk, cut, [(6, 6)])
  log(f'K4 on a ragged batch of the cube-push generic rows (B '
      f'{cut[6].shape[-1]}): max |kernel - plain| {rerr:.3e}; '
      f'{fmt_ratios(rratios)} {"ok" if kernel_ok(rratios) else "FAIL"}')
  cube_ok = cube_ok and kernel_ok(rratios)
  # the two assemblies pose one problem: the objectives must agree to 1e-4
  # of the start's in the median env (a handful of envs are ill-conditioned)
  cube_ok = cube_ok and gap.median().item() <= 1e-4
  run = lambda a: (lambda it, ls: lk._newton_lanes_core(a[0], it, ls, *a[3:]))
  name = 'newton_generic_kernel'
  e_sweep(torch, lk, 'K4 cube-push generic rows',
          lambda: lk._newton_lanes_core(*cube_args), name)
  schedule_split(torch, 'K4 Go2', run(go2_args), *sched, name)
  schedule_split(torch, 'K4 cube-push generic rows', run(cube_args), 6, 6,
                 name)
  cube_ms = time_ms(torch, lambda: lk._newton_lanes_core(*cube_args), 20)
  cube_prof = profiler_ms(torch, lambda: lk._newton_lanes_core(*cube_args),
                          20, 'newton_generic_kernel')
  cube_plain = time_ms(
      torch, lambda: lk.newton_generic_plain(*cube_args), 5, 1)
  cube_bound = least_ms(*kernel_work('_newton_lanes_core', cube_args))
  log(f'K4 on the cube-push generic rows, 6 x 6: kernel_ms {cube_ms:.5f} '
      f'(profiler {cube_prof:.5f}) plain_ms {cube_plain:.5f} bound_ms '
      f'{cube_bound[0]:.5f} ({cube_bound[1]})')
  row['ok'] = row['ok'] and cube_ok
  if not cube_ok:
    row['ratios'] += ' (cube rows or a ragged batch FAIL)'
  return row


def k3_ratios(torch, lk, args):
  """K3 on one system (the arguments of ``newton_lanes_pyr_t``), per env,
  after 1 Newton step and after the full schedule, under the criteria set
  out in k3_row.  Returns (max |kernel − plain|, {(who, steps): (φ, force,
  qfrc) worst error/tolerance over envs})."""
  f64 = lambda a: a.double() if torch.is_tensor(a) else a
  outk = lk.newton_lanes_pyr_t(*args)
  outp = lk.newton_pyr_plain(*args)
  err = max((a - b).abs().max().item() for a, b in zip(outk, outp))
  a64 = [f64(a) for a in args]
  phi0 = k3_cost(torch, lk, args, args[5])
  ratios = {}
  for iters in (1, args[0]):
    a_it = (iters,) + tuple(args[1:])
    phi64 = k3_cost(torch, lk, args, lk.newton_pyr_plain(
        iters, *a64[1:])[0])
    if iters == 1:
      phi64_1, tol_phi = phi64, 1e-5 * phi0 + 1e-30
    else:
      # an env whose float64 solve is done after its first Newton step
      # gains nothing from the later steps in exact arithmetic, and the
      # fp32 accept test cannot resolve the rounding of that first step
      # (T-push: the plain fp32 version stays at its first step's phi,
      # 4.7e-6 phi(x0) above float64's): held to the one-step tolerance
      done1 = phi64_1 - phi64 <= 1e-7 * phi0
      tol_phi = torch.where(done1, 1e-5, 1e-6) * phi0 + 1e-30
    for who, outs in (('plain', lk.newton_pyr_plain(*a_it)),
                      ('kernel', lk.newton_lanes_pyr_t(*a_it))):
      x, force, qfrc = (o.double() for o in outs)
      f_x = lk.newton_pyr_plain(0, args[1], args[2], a64[3], a64[4], x,
                                *a64[6:])[1]
      tol_f = 1024 * U32 * k3_force_scale(torch, args, x) + 1e-30
      fs, w = k3_split(torch, args, force)
      Js, U = a64[6], a64[10]
      proj = (Js * fs[None]).sum(1) + (U * w[None]).sum(1)
      tol_q = 64 * U32 * ((Js.abs() * fs.abs()[None]).sum(1)
                          + (U.abs() * w.abs()[None]).sum(1)) + 1e-30
      errs = (k3_cost(torch, lk, args, x) - phi64, (force - f_x).abs(),
              (qfrc - proj).abs())
      tols = (tol_phi, tol_f, tol_q)
      if who == 'plain':
        plain_errs = errs
        ratios[who, iters] = tuple(worst(e, t) for e, t in zip(errs, tols))
      else:
        ratios[who, iters] = tuple(
            worst_kernel(torch, e, t, p)
            for e, t, p in zip(errs, tols, plain_errs))
  return err, ratios


def seeded_system(torch, rng, nv, Rs, C, naxes, B):
  """A seeded system for the Newton wrappers: SPD M, every row kind (one
  equality row, friction rows of which one is inert, limits), separated
  contacts among the C.  Returns (kind_s, K3's tensor arguments)."""
  import numpy as np

  n_fric = (Rs - 1) // 2
  kind_s = np.array([0] + [1] * n_fric + [2] * (Rs - 1 - n_fric), np.int32)
  A = rng.normal(size=(B, nv, nv))
  M = A @ np.swapaxes(A, 1, 2) / nv + 0.55 * np.eye(nv)
  fls = np.where(kind_s[:, None] == 1, rng.uniform(0, 2, size=(Rs, B)), 0.0)
  fls[1] = 0.0
  Dc = rng.uniform(1.0, 50.0, size=(C, B))
  Dc[::5] = 0.0
  NU = (naxes + 1) * C
  arrs = (np.transpose(M, (1, 2, 0)), rng.normal(size=(nv, B)),
          0.1 * rng.normal(size=(nv, B)), 0.5 * rng.normal(size=(nv, Rs, B)),
          rng.normal(size=(Rs, B)), rng.uniform(1.0, 50.0, size=(Rs, B)), fls,
          0.3 * rng.normal(size=(nv, NU, B)), rng.normal(size=(NU, B)), Dc)
  return kind_s, tuple(
      torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device=DEV)
      for a in arrs)


def check_runtime_widths(torch, lk):
  """The Newton kernels where the width or the number of axes is not one
  compiled in (the same source with nv and naxes at run time, the Cholesky
  in shared memory; past nv 32 a lane owns two rows of H), on seeded
  systems at a batch that is no multiple of any E: each output within
  1e-4 of its scale of the plain version's after one Newton step (fp32
  sums in another order; the systems are well conditioned and start
  cold, so no accept is marginal)."""
  import numpy as np

  rng = np.random.default_rng(SEED)
  B, worst_ratio, parts = 301, 0.0, []
  cases = [('K3', 7, 9, 5, 2), ('K3', 20, 37, 24, 2), ('K3', 31, 12, 6, 3),
           ('K4', 7, 9, 0, 0), ('K4', 33, 40, 0, 0), ('K4', 64, 70, 0, 0)]
  for which, nv, Rs, C, naxes in cases:
    kind_s, a = seeded_system(torch, rng, nv, Rs, max(C, 1), max(naxes, 1), B)
    if which == 'K3':
      outs = (lk.newton_lanes_pyr_t(1, 6, kind_s, *a, naxes),
              lk.newton_pyr_plain(1, 6, kind_s, *a, naxes))
    else:
      outs = (lk._newton_lanes_core(kind_s, 1, 5, *a[:7]),
              lk.newton_generic_plain(kind_s, 1, 5, *a[:7]))
    ratio = max(((k - p).abs().max() / (1e-4 * p.abs().max())).item()
                for k, p in zip(*outs))
    if not all(bool(torch.isfinite(k).all().item()) for k in outs[0]):
      ratio = float('inf')
    parts.append(f'{which} nv {nv} rows {Rs}'
                 + (f' C {C} naxes {naxes}' if which == 'K3' else '')
                 + f' {ratio:.3g}')
    worst_ratio = max(worst_ratio, ratio)
  ok = worst_ratio <= 1.0
  log(f'Newton kernels at widths not compiled in, B {B}, 1 Newton step: '
      f'max |kernel - plain| / (1e-4 max |plain|): ' + ', '.join(parts)
      + (' ok' if ok else ' FAIL'))
  if not ok:
    raise SystemExit('a Newton kernel disagrees at a width not compiled in')


def check_kernels(torch, lk, calls):
  """Phase 2: every kernel against its plain version on recorded inputs.

  Every check is made env by env, each env against its own scale, so a
  kernel wrong in any one env fails.  Each criterion is also applied to the
  plain fp32 version against float64; its worst ratio is printed beside
  the kernel's (a criterion the plain version fails would be a wrong
  criterion, not a kernel fault)."""
  rows = {}
  rows['spd_solve_lanes'] = k1_row(torch, lk, 'cube-push',
                                   calls['spd_solve_lanes'][-2:])
  rows['contact_select_lanes'] = k2_row(torch, lk,
                                        calls['contact_select_lanes'][-1])
  args = calls['newton_lanes_pyr_t'][-1]
  rows['newton_lanes_pyr_t'] = k3_row(torch, lk, 'cube-push', args)
  e_sweep(torch, lk, 'K3 cube-push',
          lambda: lk.newton_lanes_pyr_t(*args), 'newton_pyr_kernel')
  schedule_split(torch, 'K3 cube-push',
                 lambda it, ls: lk.newton_lanes_pyr_t(it, ls, *args[2:]),
                 args[0], args[1], 'newton_pyr_kernel')
  return rows


def k3_row(torch, lk, tag, args):
  """K3 on the assembled system of a recorded substep, per env, after
  1 Newton step and after the full 6, at the E the wrapper chooses, at
  every other E that fits and on the batch cut by 3 envs.  x is held by the
  objective it reaches, since fp32 rounding (in any summation order) moves
  x along the directions where φ is flat, by more than any per-env
  tolerance on x that a wrong kernel would fail; force and qfrc must be
  those of the kernel's own x, to the fp32 rounding of the sums they come
  from:
   - φ(xk) − φ(x64) <= tol·φ(x0), φ >= 0 in float64, x64 the plain
     version's result in float64; tol is 1e-6 after 6 Newton steps and
     1e-5 after one, as for K4 and for the same reason (k4_ratios); on a
     substep of cube-push training the plain fp32 version is past 1e-6
     after one step as well; after 6 steps also 1e-5 in an env whose
     float64 solve is done after its first step (its φ then within
     1e-7·φ(x0) of the full schedule's): there the fp32 accept test stops
     every version at its first step's rounding (on T-push's first
     control step 1147 envs of 2048; the plain fp32 version 4.7e-6·φ(x0)
     above float64 in one, on the CPU);
   - force: |fk − f(xk)| <= 1024·u·D(Σ|J||xk| + |aref|) row by row, f(xk)
     the plain version run for 0 steps from xk in float64;
   - qfrc: |qk − (Jᵀfk + Uᵀw(fk))| <= 64·u·(|J|ᵀ|fk| + |U|ᵀ|w(fk)|)."""
  err, ratios = k3_ratios(torch, lk, args)
  fmt = lambda r: '/'.join(f'{v:.3g}' for v in r)
  fmt_all = lambda rs: 'phi/force/qfrc ' + ', '.join(
      f'{who} {it} step{"s" if it > 1 else ""} {fmt(r)}'
      for (who, it), r in rs.items())
  kernel_worst = lambda rs: max(
      max(r) for (who, _), r in rs.items() if who == 'kernel')
  seen, parts = {}, []
  with force_E(lk, None, seen):
    lk.newton_lanes_pyr_t(*args)
  e_ok = True
  for E in seen['fits']:
    with force_E(lk, E):
      r = kernel_worst(k3_ratios(torch, lk, args)[1])
    parts.append(f'E {E} {r:.3g}')
    e_ok = e_ok and r <= 1.0
  log(f'K3 {tag}: kernel worst error/tolerance at each E (chosen '
      f'{seen["chosen"]}): ' + ', '.join(parts) + (' ok' if e_ok else ' FAIL'))
  # the same on a batch that is no multiple of the envs per block
  ragged_ok = True
  if args[3].shape[-1] > 3:
    cut = ragged(torch, args)
    rerr, rratios = k3_ratios(torch, lk, cut)
    ragged_ok = kernel_worst(rratios) <= 1.0
    log(f'K3 {tag} on a ragged batch (B {cut[3].shape[-1]}): max |kernel - '
        f'plain| {rerr:.3e}; {fmt_all(rratios)} '
        f'{"ok" if ragged_ok else "FAIL"}')
  return dict(
      max_abs_err=err,
      ok=kernel_worst(ratios) <= 1.0 and ragged_ok and e_ok,
      ratios=fmt_all(ratios),
      work=kernel_work('newton_lanes_pyr_t', args),
      ms=time_ms(torch, lambda: lk.newton_lanes_pyr_t(*args), 20),
      plain_ms=time_ms(torch, lambda: lk.newton_pyr_plain(*args), 3, 1),
      library_ms=None,
      note=f'B {args[3].shape[-1]}; per env, after 1 and 6 Newton steps, '
           'at every E: phi(xk) within 1e-5 and 1e-6 of phi(x0) of the '
           'float64 solve (1e-5 after 6 where float64 is done after 1); '
           'force and qfrc those of xk and of the force to fp32 rounding '
           '(1024u, 64u of their sums)',
      profiler_ms=profiler_ms(torch, lambda: lk.newton_lanes_pyr_t(*args),
                              20, 'newton_pyr_kernel'),
  )


def report(rows):
  """Print each kernel's row with its bound; fail if a check failed."""
  failed = []
  for name, r in rows.items():
    short = KERNELS[name][0] + ' ' if name in KERNELS else ''
    r['bound_ms'], r['bound_by'] = least_ms(*r['work'])
    log(f'{short}{name}: max |kernel - plain| {r["max_abs_err"]:.3e}; '
        f'{r["note"]}; worst error/tolerance over envs: {r["ratios"]} '
        f'{"ok" if r["ok"] else "FAIL"}; kernel_ms {r["ms"]:.5f} '
        f'(profiler {r["profiler_ms"]:.5f}) plain_ms {r["plain_ms"]:.5f} '
        + (f'library_ms {r["library_ms"]:.5f} (profiler '
           f'{r["library_device_ms"]:.5f}) ' if r['library_ms']
           else 'library_ms None ')
        + f'bound_ms {r["bound_ms"]:.5f} ({r["bound_by"]})')
    if not r['ok']:
      failed.append(name)
  if failed:
    raise SystemExit(f'kernel check failed: {failed}')


def reference(torch, tag, make_envs, policy, pol_cpu, obs_of,
              policy_obs=None, steps=3):
  """REF_ENVS envs of a path's batch, the deterministic policy, ``steps``
  control steps from the same start: on the card, on the CPU (plain
  versions) and on the CPU in float64.  ``make_envs(device, dtype)`` gives
  (env, start state); ``policy`` and ``pol_cpu`` are the policy on the card
  and on the CPU; ``obs_of(state)`` the observation compared and
  ``policy_obs(state)`` the one the policy reads (the same by default).

  A few start states are chaotic in fp32: a change of qpos at the level of
  fp32 rounding moves the obs by more than the repo's 1e-2 tolerance within
  2 or 3 control steps, in any summation order.  So the card is held to
  the CPU elementwise on the first 4 envs after 1 step only, and after
  every step to float64 as a batch: the median over envs of its obs gap to
  float64 must be within 10x the CPU fp32 path's + 1e-6.  Both gaps to
  float64 are printed after each step (max, median, envs over 1e-3)."""
  f64 = torch.float64
  env_g, s_g = make_envs(DEV, torch.float32)
  env_c, s_c = make_envs('cpu', torch.float32)
  env_d, s_d = make_envs('cpu', f64)
  policy_obs = policy_obs or obs_of
  ok = True
  for step in range(1, steps + 1):
    s_g = env_g.step(s_g, policy(policy_obs(s_g)))
    s_c = env_c.step(s_c, pol_cpu(policy_obs(s_c)))
    s_d = env_d.step(s_d, pol_cpu(policy_obs(s_d).float()).to(f64))
    g, c, d = obs_of(s_g).cpu().to(f64), obs_of(s_c).to(f64), obs_of(s_d)
    gap_g, gap_c = (g - d).abs().amax(1), (c - d).abs().amax(1)
    med_g, med_c = gap_g.median().item(), gap_c.median().item()
    good = med_g <= 10 * med_c + 1e-6
    if step == 1:
      good = good and bool(
          ((g - c)[:4].abs() <= 1e-2 + 1e-2 * c[:4].abs()).all().item())
      good = good and bool(torch.allclose(
          s_g.reward[:4].cpu(), s_c.reward[:4], rtol=1e-2, atol=1e-2))
    stats = lambda x: (f'max {x.max().item():.4g} median '
                       f'{x.median().item():.4g} over 1e-3 '
                       f'{int((x > 1e-3).sum().item())}')
    log(f'{tag} reference step {step}, {len(d)} envs: obs gap to float64 per '
        f'env, card {stats(gap_g)}; CPU fp32 {stats(gap_c)}; card-CPU max '
        f'{(g - c).abs().max().item():.4g} '
        f'{"ok" if good else "FAIL"}')
    ok = ok and good
  if not ok:
    raise SystemExit(f'{tag}: the card disagrees with the CPU reference')


# stages of the fused step, each timed on the host by the profile phase
STAGES = (
    ('physics.lanes_kinematics', 'kinematics_lanes'),
    ('physics.lanes_smooth', 'gather_smooth'),
    ('physics.lanes_smooth', 'smooth_lanes'),
    ('physics.constraint', 'gather_leaves'),
    ('physics.constraint', 'narrowphase_leaves'),
    ('physics.lanes_assembly', 'assemble_lanes'),
    ('physics.sensors', 'sensordata'),
)


def profile_control_step(torch, tag, env, policy, state, step_ms,
                         first=None):
  """One control step under torch.profiler: wall time, device busy time,
  device kernels launched, and the host time of each stage; fails unless
  the K1-K4 kernels the trace holds, by name (DEVICE_KERNELS), are as many
  as the launch counts say (inferred where the step replays a graph:
  this is what holds them to the card).  The idle
  share divides the device busy time by ``step_ms``, the wall time of a
  control step without the profiler (the profiler slows the host, not the
  device); the share under the profiler is printed beside it.  The stage
  ``first`` is printed first.  The full table goes to
  chiprun_out/profile_<tag>.txt."""
  import importlib

  from torch.profiler import ProfilerActivity, profile, record_function

  lk = importlib.import_module('rsr_mjx_tpu_torch.physics.linalg_kernels')
  patched = []
  for mod_name, fn_name in STAGES:
    mod = importlib.import_module('rsr_mjx_tpu_torch.' + mod_name)
    real = getattr(mod, fn_name)

    def timed(*a, _real=real, _label=f'stage.{fn_name}', **k):
      with record_function(_label):
        return _real(*a, **k)

    setattr(mod, fn_name, timed)
    patched.append((mod, fn_name, real))
  try:
    torch.cuda.synchronize()
    before = dict(lk.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      t = time.perf_counter()
      env.step(state, policy(state.obs))
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t) * 1e3
  finally:
    for mod, fn_name, real in patched:
      setattr(mod, fn_name, real)
  events = prof.key_averages()
  on_host = lambda e: e.device_type == torch.autograd.DeviceType.CPU
  # device rows: the kernels, and each span on the device timeline (the
  # stages' here, the port's tracing spans): an annotation, which is no
  # device work of its own and may enclose the kernels of a whole step
  spans = {e.name for e in prof.events()
           if getattr(e, 'is_user_annotation', False)}
  kernels = [e for e in events
             if not on_host(e) and not e.key.startswith('stage.')
             and e.key not in spans]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  counted = {k: n - before[k] for k, n in lk.LAUNCHES.items()}
  ran = {w: sum(e.count for e in kernels if any(n in e.key for n in names))
         for w, names in DEVICE_KERNELS.items()}
  log(f'{tag} profile: K1-K4 in the device trace {ran}, launch counts '
      f'{counted} {"ok" if ran == counted else "FAIL"}')
  if ran != counted:
    raise SystemExit(f'{tag}: the card ran other kernels than counted')
  stages = {e.key[len('stage.'):]: e.cpu_time_total / 1e3 / e.count
            for e in events if on_host(e) and e.key.startswith('stage.')}
  if first in stages:
    stages = {first: stages.pop(first), **stages}
  log(f'{tag} profile: 1 control step, device busy {busy_ms:.3f} ms, idle share '
      f'{1 - busy_ms / step_ms:.4f} of the unprofiled step ({step_ms:.3f} '
      f'ms); under the profiler wall {wall_ms:.3f} ms, idle share '
      f'{1 - busy_ms / wall_ms:.4f}; {sum(e.count for e in kernels)} device '
      f'kernels; host ms per stage call (profiler on): '
      + ', '.join(f'{k} {v:.3f}' for k, v in stages.items()))
  os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
  with open(os.path.join(ROOT, 'chiprun_out', f'profile_{tag}.txt'),
            'w') as f:
    f.write(events.table(sort_by='self_device_time_total', row_limit=40))
    f.write(events.table(sort_by='cpu_time_total', row_limit=40))


def zero_launches(lk):
  lk.LAUNCHES.update(dict.fromkeys(lk.LAUNCHES, 0))


def check_finite(torch, tensors):
  for name, x, shape in tensors:
    if shape is not None and tuple(x.shape) != shape:
      raise SystemExit(f'{name} has shape {tuple(x.shape)}, not {shape}')
    if not bool(torch.isfinite(x).all().item()):
      raise SystemExit(f'{name} is not finite')


def rollout_cube(torch, lk, env0, env, policy, state, card, tag='slice',
                 name=ENV):
  """The cube-push path (or T-push's, which runs the same kernels): STEPS
  control steps at B = ENVS."""
  B, n_sub = ENVS, env0.n_substeps
  zero_launches(lk)
  torch.cuda.synchronize()
  t = time.perf_counter()
  rewards, nonfinite = [], torch.zeros((), device=DEV)
  for _ in range(STEPS):
    state = env.step(state, policy(state.obs))
    rewards.append(state.reward)
    nonfinite += state.metrics['nonfinite'].sum()
  torch.cuda.synchronize()
  wall = time.perf_counter() - t
  launches = dict(lk.LAUNCHES)
  substeps = STEPS * n_sub
  expect = {'spd_solve_lanes': 2 * substeps, 'contact_select_lanes': substeps,
            'newton_lanes_pyr_t': substeps, '_newton_lanes_core': 0}
  if launches != expect:
    raise SystemExit(f'launch counts {launches} != expected {expect}')
  rew = torch.stack(rewards)
  check_finite(torch, (('obs', state.obs, (B, env0.observation_size)),
                       ('reward', rew, None),
                       ('qpos', state.data.qpos, (B, env0.model.nq))))
  log(f'{tag}: {name} B={B}, {STEPS} control steps = {substeps} '
      f'substeps in {wall:.3f} s: {B * STEPS / wall:.1f} env-steps/s, '
      f'{wall / substeps * 1e3:.3f} ms/substep; mean reward per step '
      f'{rew.mean().item():.4f}; guard trips {int(nonfinite.item())}; '
      f'launches {launches}; card {card}')
  return state, launches, wall / STEPS * 1e3


def rollout_go2(torch, lk, env0, env, policy, state, card):
  """The Go2 path: GO2_STEPS control steps at B = GO2_ENVS, with the
  command-tracking errors of scripts/eval_go2.py: ‖cmd_xy − local linvel_xy‖
  and |cmd_yaw − gyro_z|, averaged over alive steps (up to and including
  an env's first done)."""
  B, n_sub = GO2_ENVS, env0.n_substeps
  zero_launches(lk)
  torch.cuda.synchronize()
  t = time.perf_counter()
  alive = torch.ones(B, dtype=torch.bool, device=DEV)
  ever_done = torch.zeros(B, dtype=torch.bool, device=DEV)
  terminated = torch.zeros(B, dtype=torch.bool, device=DEV)
  n_alive = torch.zeros((), device=DEV)
  lin_sum, ang_sum = torch.zeros((), device=DEV), torch.zeros((), device=DEV)
  rew_sum, nonfinite = torch.zeros((), device=DEV), torch.zeros((), device=DEV)
  for _ in range(GO2_STEPS):
    state = env.step(state, policy(state.obs))
    cmd = state.info['command']
    lin = torch.linalg.vector_norm(
        cmd[:, :2] - env0.get_local_linvel(state.data)[:, :2], dim=-1)
    ang = torch.abs(cmd[:, 2] - env0.get_gyro(state.data)[:, 2])
    w = alive.to(lin.dtype)
    n_alive += w.sum()
    lin_sum += (lin * w).sum()
    ang_sum += (ang * w).sum()
    rew_sum += state.reward.sum()
    nonfinite += state.metrics['nonfinite'].sum()
    done = state.done > 0
    terminated |= done & (state.info['truncation'] == 0)
    ever_done |= done
    alive &= ~done
  torch.cuda.synchronize()
  wall = time.perf_counter() - t
  launches = dict(lk.LAUNCHES)
  substeps = GO2_STEPS * n_sub
  expect = {'spd_solve_lanes': substeps, 'contact_select_lanes': 0,
            'newton_lanes_pyr_t': 0, '_newton_lanes_core': substeps}
  if launches != expect:
    raise SystemExit(f'launch counts {launches} != expected {expect}')
  check_finite(torch, (
      ('state', state.obs['state'], (B, 48)),
      ('privileged_state', state.obs['privileged_state'], (B, 123)),
      ('qpos', state.data.qpos, (B, env0.model.nq)),
      ('sensordata', state.data.sensordata, (B, env0.model.nsensordata))))
  if not bool(torch.isfinite(rew_sum).item()):
    raise SystemExit('reward is not finite')
  done_share = ever_done.float().mean().item()
  term_share = terminated.float().mean().item()
  log(f'slice: {GO2_ENV} B={B}, {GO2_STEPS} control steps = {substeps} '
      f'substeps in {wall:.3f} s: {B * GO2_STEPS / wall:.1f} env-steps/s, '
      f'{wall / substeps * 1e3:.3f} ms/substep; mean reward per step '
      f'{rew_sum.item() / (B * GO2_STEPS):.4f}; share of envs done '
      f'{done_share:.5f} (terminated {term_share:.5f}, limit '
      f'{GO2_MAX_DONE_SHARE}); tracking error over alive steps: lin '
      f'{(lin_sum / n_alive).item():.4f} m/s, ang '
      f'{(ang_sum / n_alive).item():.4f} rad/s; guard trips '
      f'{int(nonfinite.item())}; launches {launches}; card {card}')
  if done_share > GO2_MAX_DONE_SHARE:
    raise SystemExit(f'{done_share:.4f} of the Go2 envs were done within '
                     f'{GO2_STEPS} control steps')
  return state, launches, wall / GO2_STEPS * 1e3


def load_path(torch, port, name, params, n_envs, length, gen, **policy_kw):
  """A served path as its users build it: the env, its training wrappers at
  n_envs, the trained policy run deterministically, and the reset state."""
  env0 = port.envs.load(name, device=DEV)
  env = port.wrappers.wrap_for_training(env0, episode_length=length,
                                        num_envs=n_envs)
  return env0, env, load_policy(port, params, DEV, **policy_kw), env.reset(gen)


def load_policy(port, params, device, **policy_kw):
  """The trained policy of the pickle ``params``, deterministic, on
  ``device``."""
  normalizer, params = port.networks.load_ppo_params(params)
  if not hasattr(port.networks, 'networks_from_numpy'):
    # an older commit of the port (``--wrapper-times DIR``) serves the
    # policy layers alone
    params = params['policy']
    policy_kw.pop('value_obs_key', None)
  return port.networks.make_policy(normalizer, params, device=device,
                                   **policy_kw)


def recorded_sgd_step(torch, port, rec, dev, dtype):
  """(networks, run): the recorded minibatch's networks, normalizer,
  minibatch, draw and RSR penalty state on ``dev`` in ``dtype``, and run()
  taking one ``ppo.minibatch_step`` there with a fresh Adam (as the first
  minibatch has) and returning its metrics."""
  net = rec['factory']()
  net.load_state_dict(rec['params'])
  net.to(dev, dtype)
  opt = port.ppo.make_optimizer(net.parameters(), rec['lr'])
  cast = lambda x: x.to(dev, dtype if x.is_floating_point() else None)
  loss_kwargs = dict(rec['loss_kwargs'])
  if loss_kwargs.get('past_data') is not None:
    loss_kwargs['past_data'] = loss_kwargs['past_data'].to(dev, dtype)
  args = (net, opt, port.rs.to(rec['normalizer'], dev, dtype),
          port.wrappers.tree_map(cast, rec['data']), cast(rec['noise']),
          loss_kwargs, rec['max_grad_norm'])
  return net, lambda: port.ppo.minibatch_step(*args)


def sim2real_grads(torch, port, rec, dev, dtype):
  """The gradient of the RSR term alone (``rsr.compute_rsr_loss`` on the
  current policy's mode action and the raw observations, as the PPO loss
  takes it) with respect to the policy parameters, on the recorded
  minibatch, on ``dev`` in ``dtype``: {name: gradient in float64 on the
  CPU}."""
  net, _ = recorded_sgd_step(torch, port, rec, dev, dtype)
  cast = lambda x: x.to(dev, dtype)
  data = port.wrappers.tree_map(cast, rec['data'])
  past = rec['loss_kwargs']['past_data'].to(dev, dtype)
  with torch.enable_grad():
    logits = net.policy_logits(port.rs.normalize(
        port.rs.to(rec['normalizer'], dev, dtype), data.observation))
    loss, _ = port.rsr.compute_rsr_loss(
        data.observation, net.distribution.mode(logits),
        data.next_observation, past,
        loss_scale=rec['loss_kwargs']['rsr_loss_scale'])
    params = dict(net.policy.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
  return {k: g.to('cpu', torch.float64) for k, g in zip(params, grads)}


def profile_sgd(torch, run, step_ms, tag='train') -> None:
  """One SGD step (``run()``, a recorded step replayed on the card) under
  torch.profiler, after two unprofiled ones (a PPO step is captured into
  a CUDA graph at its second call): device busy time, its share of
  ``step_ms`` (the measured ms per step in training), device kernels
  launched."""
  from torch.profiler import ProfilerActivity, profile

  run()
  run()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
  kernels = [e for e in prof.key_averages()
             if e.device_type != torch.autograd.DeviceType.CPU]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  log(f'{tag} SGD profile: 1 step, device busy {busy_ms:.3f} ms, '
      f'idle share {1 - busy_ms / step_ms:.4f} of the {step_ms:.3f} ms per '
      f'step in training; under the profiler wall {wall_ms:.3f} ms; '
      f'{sum(e.count for e in kernels)} device kernels')


def sgd_check(torch, port, rec, tag='train') -> None:
  """The card against the CPU on one recorded minibatch of the first
  training step: from its parameters, normalizer, minibatch (the
  permutation applied), entropy draw and RSR penalty state, one
  ``ppo.minibatch_step`` (PPO loss, backward, clip, Adam; a fresh Adam, as
  the first minibatch has) on the card in fp32, on the CPU in fp32 and on
  the CPU in float64.  Per loss metric |m − m64| <= 1e-5·|m64| + 1e-6, per
  parameter tensor max |g − g64| <= 1e-4·max |g64| for the clipped
  gradient, for the card and for the plain CPU fp32 run alike (a criterion
  the CPU run fails is the wrong criterion).  With the RSR penalty on, the
  gradient of the penalty alone (sim2real_grads) is held to float64 the
  same way, per policy parameter tensor, and must not be zero."""
  f64 = torch.float64
  out = {}
  for who, dev, dtype in (('card', DEV, torch.float32),
                          ('cpu', 'cpu', torch.float32), ('f64', 'cpu', f64)):
    net, run = recorded_sgd_step(torch, port, rec, dev, dtype)
    metrics = run()
    out[who] = ({k: v.item() for k, v in metrics.items()},
                {k: p.grad.to('cpu', f64) for k, p in net.named_parameters()},
                {k: p.detach().to('cpu', f64)
                 for k, p in net.named_parameters()})
  m64, g64, p64 = out['f64']
  grad_ratio = lambda g, ref: max(
      ((g[k] - ref[k]).abs().max() / (1e-4 * ref[k].abs().max() + 1e-30))
      .item() for k in ref)
  rsr = rec['loss_kwargs'].get('past_data') is not None
  if rsr:
    s64 = sim2real_grads(torch, port, rec, 'cpu', f64)
    s_max = max(g.abs().max().item() for g in s64.values())
  ok = not rsr or s_max > 0
  for who, dev in (('card', DEV), ('cpu', 'cpu')):
    m, g, p = out[who]
    loss_ratio = max(abs(m[k] - m64[k]) / (1e-5 * abs(m64[k]) + 1e-6)
                     for k in m)
    step = max((p[k] - p64[k]).abs().max().item() for k in p) / rec['lr']
    ratios = [loss_ratio, grad_ratio(g, g64)]
    extra = ''
    if rsr:
      ratios.append(grad_ratio(sim2real_grads(torch, port, rec, dev,
                                              torch.float32), s64))
      extra = (f', worst sim2real_loss gradient error/tolerance '
               f'{ratios[-1]:.3g} (largest float64 entry {s_max:.6g})')
    good = max(ratios) <= 1.0
    log(f'{tag} SGD check, {who} fp32 against CPU float64 on one minibatch '
        f'({rec["data"].reward.shape[0]} sequences x '
        f'{rec["data"].reward.shape[1]} steps): worst loss error/tolerance '
        f'{ratios[0]:.3g}, worst gradient error/tolerance {ratios[1]:.3g}'
        f'{extra}; parameters after the Adam step differ by {step:.3g} x lr '
        f'{"ok" if good else "FAIL"}')
    ok = ok and good
  log(f'{tag} SGD check, card - CPU fp32: max |loss metric| '
      + f'{max(abs(out["card"][0][k] - out["cpu"][0][k]) for k in m64):.3e}')
  if not ok:
    raise SystemExit(f'{tag}: the card\'s SGD step disagrees with the CPU'
                     + (' or the penalty has no gradient' if rsr else ''))


def run_training(torch, port, lk, train, make_net):
  """Run ``train()`` (``ppo.train`` directly or through the RSR pipeline)
  with each rollout and each minibatch step timed by CUDA events recorded
  at its boundaries, with no synchronise, so training/sps is the trainer's
  own; the first minibatch step's inputs recorded (``make_net()`` makes
  networks of the trained shape), the observations the rollouts produced
  counted, the kernels' launch counts zeroed just before; after it the
  kernel wrappers' arguments of one eager control step from the state the
  last rollout ended in (``record_last_step``).  Returns a namespace: out
  (train()'s result), launches (of training alone), calls, unroll_ms, sgd_ms,
  step_metrics (per minibatch), rec, seen (observations), done and
  terminated (the rollouts' done flags, and those that were no time limit,
  summed on the card), progress (the steps progress_fn was called at),
  metrics (the trainer's last)."""
  import types

  r = types.SimpleNamespace(rec={}, unroll_ev=[], sgd_ev=[], step_metrics=[],
                            progress=[], metrics=None, seen=0, done=0,
                            terminated=0, last=None)

  def progress_fn(step, metrics):
    r.progress.append(step)
    r.metrics = metrics

  real_unroll, real_step = port.acting.generate_unroll, port.ppo.minibatch_step

  def timed(events, fn, *a, **k):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn(*a, **k)
    end.record()
    events.append((start, end))
    return out

  def unroll(*a, **k):
    out = timed(r.unroll_ev, real_unroll, *a, **k)
    r.last = last_step_args(real_unroll, a, k, out) or r.last
    data = out[1]
    r.seen += data.reward.numel()
    done = 1 - data.discount
    r.done = r.done + done.sum()
    r.terminated = r.terminated + (
        done * (1 - data.extras['state_extras']['truncation'])).sum()
    return out

  def step(networks, optimizer, normalizer, data, noise, loss_kwargs,
           max_grad_norm):
    if not r.rec:
      r.rec.update(params={k: v.detach().clone()
                           for k, v in networks.state_dict().items()},
                   normalizer=normalizer, data=data, noise=noise,
                   loss_kwargs=loss_kwargs, max_grad_norm=max_grad_norm,
                   lr=optimizer.param_groups[0]['lr'], factory=make_net)
    m = timed(r.sgd_ev, real_step, networks, optimizer, normalizer, data,
              noise, loss_kwargs, max_grad_norm)
    r.step_metrics.append(m)
    return m

  out = []
  port.acting.generate_unroll, port.ppo.minibatch_step = unroll, step
  zero_launches(lk)
  try:
    out.append(train(progress_fn))
  finally:
    port.acting.generate_unroll, port.ppo.minibatch_step = (real_unroll,
                                                            real_step)
  r.launches = dict(lk.LAUNCHES)
  r.calls = record_last_step(lk, port, r.last)
  del r.last
  r.out = out[0]
  torch.cuda.synchronize()
  r.unroll_ms = [a.elapsed_time(b) for a, b in r.unroll_ev]
  r.sgd_ms = [a.elapsed_time(b) for a, b in r.sgd_ev]
  return r


def training_checks(torch, r, tag, steps, per_step, T, n_sub, n_mb, n_envs,
                    norm, net, expect_of, card):
  """Print a training run's rates and each step's mean loss metrics, and
  fail on a non-finite metric, on env steps or a normalizer count other
  than the rollouts gave, on parameters left unchanged, on launch counts
  other than ``expect_of(substeps)``."""
  metrics = r.metrics
  substeps = len(r.unroll_ms) * T * n_sub
  log(f'{tag}: {n_envs} envs, {steps} training step(s) of {per_step} '
      f'env-steps ({len(r.unroll_ms)} unrolls of {T} control steps, '
      f'{len(r.sgd_ms)} minibatch steps); training/sps '
      f'{metrics["training/sps"]:.1f} env-steps/s, training/walltime '
      f'{metrics["training/walltime"]:.3f} s; CUDA-event spans, no '
      f'synchronise: rollout '
      f'{sum(r.unroll_ms) / (len(r.unroll_ms) * T):.3f} ms per control step '
      f'at B {n_envs} ({sum(r.unroll_ms) / substeps:.3f} ms per substep); '
      f'SGD {sum(r.sgd_ms) / len(r.sgd_ms):.3f} ms per minibatch (median '
      f'{sorted(r.sgd_ms)[len(r.sgd_ms) // 2]:.3f}); rollouts and SGD '
      f'{(sum(r.unroll_ms) + sum(r.sgd_ms)) / 1e3:.3f} s; launches in '
      f'training {r.launches}; card {card}')
  failed = []
  for i in range(steps):
    ms = r.step_metrics[i * n_mb:(i + 1) * n_mb]
    mean = {k: torch.stack([m[k] for m in ms]).mean().item() for k in ms[0]}
    log(f'{tag} step {i + 1}: ' + ', '.join(f'{k} {v:.6g}'
                                            for k, v in mean.items()))
    failed += [f'step {i + 1} {k}' for k, v in mean.items()
               if not math.isfinite(v)]
  failed += [k for k, v in metrics.items() if not math.isfinite(v)]
  if r.progress != [steps * per_step]:
    failed.append(f'env steps {r.progress} != {steps * per_step}')
  if float(norm.count) != r.seen:
    failed.append(f'normalizer count {float(norm.count)} != {r.seen} '
                  'observations')
  same = [k for k, v in net.state_dict().items()
          if torch.equal(v, r.rec['params'][k])]
  if same:
    failed.append(f'parameters unchanged by training: {same}')
  if r.launches != expect_of(substeps):
    failed.append(f'launches in training {r.launches} != '
                  f'{expect_of(substeps)}')
  if failed:
    raise SystemExit(f'{tag} phase failed: {failed}')
  return substeps


# per substep K1 twice, K2 and K3 once; the reset's forward once each
CUBE_TRAIN_LAUNCHES = lambda S: {
    'spd_solve_lanes': 2 * S + 1, 'contact_select_lanes': S + 1,
    'newton_lanes_pyr_t': S + 1, '_newton_lanes_core': 0}
# per substep K1 and K4 once; the reset's forward once each
GO2_TRAIN_LAUNCHES = lambda S: {
    'spd_solve_lanes': S + 1, 'contact_select_lanes': 0,
    'newton_lanes_pyr_t': 0, '_newton_lanes_core': S + 1}


def cube_kernel_rows(torch, lk, calls, B, tag):
  """K1, K2 and K3 on the recorded inputs of the last substep of the
  eager control step after training (``record_last_step``: the batch of
  training, and so the envs per block it makes the wrappers choose), under
  phase 2's checks; fails if one fails."""
  if calls['spd_solve_lanes'][-1][1].shape[-1] != B:
    raise SystemExit(f'{tag}: the recorded kernel inputs are not of '
                     'training')
  k3_args = calls['newton_lanes_pyr_t'][-1]
  label = f'{tag}, B {B}'
  rows = {
      f'K1 spd_solve_lanes ({label})': k1_row(torch, lk, label,
                                              calls['spd_solve_lanes'][-2:]),
      f'K2 contact_select_lanes ({label})': k2_row(
          torch, lk, calls['contact_select_lanes'][-1], tag=tag),
      f'K3 newton_lanes_pyr_t ({label})': k3_row(torch, lk, label, k3_args),
  }
  e_sweep(torch, lk, f'K3 {label}', lambda: lk.newton_lanes_pyr_t(*k3_args),
          'newton_pyr_kernel')
  report(rows)


def run_eval(torch, port, env0, make_policy, params, episode_length, tag,
             steps=None):
  """The evaluator, deterministic, on EVAL_ENVS envs for a cut episode of
  ``steps`` control steps (EVAL_STEPS by default); fails on a non-finite
  episode reward."""
  import functools

  steps = steps or EVAL_STEPS
  eval_env = port.wrappers.EvalWrapper(port.wrappers.wrap_for_training(
      env0, episode_length=steps, num_envs=EVAL_ENVS))
  evaluator = port.acting.Evaluator(
      eval_env, functools.partial(make_policy, deterministic=True),
      num_eval_envs=EVAL_ENVS, episode_length=steps, action_repeat=1,
      generator=torch.Generator(device=DEV).manual_seed(SEED))
  ev = evaluator.run_evaluation(params, {})
  log(f'{tag} eval: {EVAL_ENVS} envs, deterministic, episode cut to '
      f'{steps} control steps (reduced from {episode_length}): '
      f'eval/episode_reward {ev["eval/episode_reward"]:.4f} (std '
      f'{ev["eval/episode_reward_std"]:.4f}), avg episode length '
      f'{ev["eval/avg_episode_length"]:.2f}, nan episodes '
      f'{ev["eval/nan_episodes"]}, {ev["eval/epoch_eval_time"]:.3f} s')
  if not math.isfinite(ev['eval/episode_reward']) or ev['eval/nan_episodes']:
    raise SystemExit(f'{tag} eval: a non-finite episode reward')


def tuned_config(port, env_name, steps, num_minibatches=None):
  """(config, network factory keywords, env-steps per training step) of
  the tuned PPO config of ``env_name`` cut to ``steps`` training steps in
  one epoch with no evaluation inside (and to ``num_minibatches`` where
  given)."""
  cfg = port.configs.ppo_config(env_name)
  nf = {k: tuple(v) if isinstance(v, list) else v
        for k, v in cfg.pop('network_factory').items()}
  if num_minibatches is not None:
    cfg.num_minibatches = num_minibatches
  per_step = (cfg.batch_size * cfg.unroll_length * cfg.num_minibatches
              * cfg.action_repeat)
  cfg.update(num_timesteps=steps * per_step, num_evals=0)
  return cfg, nf, per_step


def train_phase(torch, port, lk, card, name=ENV, tag='train',
                steps=TRAIN_STEPS, eval_steps=None, num_minibatches=None):
  """PPO on cube-push (or T-push: ``name``) at the tuned width:
  ``ppo.train`` with ``configs.ppo_config`` (1024 envs, batch 256 x 32
  minibatches, unroll 10, 8 updates per batch) for ``steps`` training steps
  in one epoch, no evaluation inside (run_training).  Then K1, K2 and K3 on
  the recorded inputs of the control step after training (B 1024, E of the
  training batch) against their plain versions, as phase 2 holds them, the
  card-vs-CPU SGD check on the first minibatch, and the evaluator.
  ``num_minibatches`` cuts the table's.  Returns the kernels' launches in
  training."""
  import functools

  import_train(port)
  cfg, nf, per_step = tuned_config(port, name, steps, num_minibatches)
  factory = functools.partial(port.networks.make_ppo_networks, **nf)
  env0 = port.envs.load(name, device=DEV)
  r = run_training(
      torch, port, lk,
      lambda progress_fn: port.ppo.train(
          environment=env0, network_factory=factory, seed=SEED, device=DEV,
          progress_fn=progress_fn, **cfg),
      lambda: factory(env0.observation_size, env0.action_size))
  make_policy, (norm, net), _ = r.out
  n_mb = cfg.num_updates_per_batch * cfg.num_minibatches
  training_checks(torch, r, tag, steps, per_step,
                  cfg.unroll_length, env0.n_substeps, n_mb, cfg.num_envs,
                  norm, net, CUBE_TRAIN_LAUNCHES, card)
  cube_kernel_rows(torch, lk, r.calls, cfg.num_envs,
                   'training' if tag == 'train' else f'{tag}ing')
  del r.calls
  sgd_check(torch, port, r.rec, tag=tag)
  profile_sgd(torch, recorded_sgd_step(torch, port, r.rec, DEV,
                                       torch.float32)[1],
              sorted(r.sgd_ms)[len(r.sgd_ms) // 2], tag=tag)
  run_eval(torch, port, env0, make_policy, (norm, net), cfg.episode_length,
           tag, eval_steps)
  return r.launches


def rsr_phase(torch, port, lk, card):
  """RSR policy training on cube-push: ``rsr.pipeline.
  policy_params_training(algorithm='ppo')`` on AirbotCubePush with the demo
  data (``load_rsr_datasets``), at the RSR CLI's width (512 envs, batch 128
  x SHORT_MINIBATCHES of its 32 minibatches, unroll 10, 8 updates, policy
  and value 32 x 4), at
  bandwidth RSR_BANDWIDTH (where the penalty's gate is open; at the demo's
  default 0.1 the term is identically zero) and rsr_loss_scale 1.0, for
  one training step with no evaluation inside.  Checks as phase 4's, with
  K1, K2 and K3 at B 512, the SGD check with the penalty's gradient alone
  held to float64 and nonzero, and a nonzero penalty in training.  Returns
  the kernels' launches in training."""
  import functools

  arrays = port.rsr_datasets.load_rsr_datasets(RSR_DATA, 50, device=DEV)
  env0 = port.envs.load(RSR_ENV, device=DEV)
  factory = functools.partial(port.networks.make_ppo_networks,
                              policy_hidden_layer_sizes=(32,) * 4,
                              value_hidden_layer_sizes=(32,) * 4)
  sizes = RSR_SIZES
  per_step = sizes['batch_size'] * sizes['unroll_length'] * sizes[
      'num_minibatches']
  r = run_training(
      torch, port, lk,
      lambda progress_fn: port.rsr_pipeline.policy_params_training(
          env0, algorithm='ppo', past_states=arrays[0],
          past_actions=arrays[1], past_next_states_real=arrays[2],
          past_next_states_sim=arrays[3], current_next_states_sim=arrays[4],
          bandwidth=RSR_BANDWIDTH, rsr_loss_scale=1.0,
          num_timesteps=RSR_STEPS * per_step, num_evals=0,
          network_factory=factory, progress_fn=progress_fn, seed=SEED,
          device=DEV, **sizes),
      lambda: factory(env0.observation_size, env0.action_size))
  make_policy, (norm, net) = r.out
  past = r.rec['loss_kwargs']['past_data']
  log(f'rsr: data {RSR_DATA}: {arrays[0].shape[0]} transitions, width '
      f'{past.width}; bandwidth {RSR_BANDWIDTH}, {past.grid.shape[0]} grid '
      f'points of the port\'s grid (seed {SEED}): gate weight '
      f'KL(real || previous sim) {past.weight.item():.6g}')
  mb = [m['sim2real_loss'].item() for m in r.step_metrics]
  log(f'rsr: sim2real_loss first / last minibatch {mb[0]:.6g} / {mb[-1]:.6g}')
  n_mb = sizes['num_updates_per_batch'] * sizes['num_minibatches']
  substeps = training_checks(
      torch, r, 'rsr', RSR_STEPS, per_step, sizes['unroll_length'],
      env0.n_substeps, n_mb, sizes['num_envs'], norm, net,
      CUBE_TRAIN_LAUNCHES, card)
  if not min(mb) > 0:
    raise SystemExit('rsr: the penalty is zero in a minibatch: the gate is '
                     'closed')
  k3 = r.calls['newton_lanes_pyr_t'][-1]
  k2 = r.calls['contact_select_lanes'][-1]
  rows, C, naxes = k3[6].shape[1], k3[12].shape[0], k3[13]
  log(f'rsr: {substeps} substeps of {env0.model.nv} dofs; the kernels saw '
      f'{k2[2].shape[0]} contact slots -> {k2[1]} selected, nefc '
      f'{rows + 2 * naxes * C} ({rows} structured rows, {C} contacts x '
      f'{naxes} axes x 2)')
  del k3, k2
  cube_kernel_rows(torch, lk, r.calls, sizes['num_envs'], 'rsr training')
  del r.calls
  sgd_check(torch, port, r.rec, tag='rsr')
  return r.launches


def go2_train_phase(torch, port, lk, card, name=GO2_ENV, tag='go2 train',
                    expect=None, k4_check=None):
  """PPO on the Go2 joystick (or the Go2 task ``name``) at the tuned table:
  ``ppo.train`` with ``configs.ppo_config('Go2JoystickFlatTerrain')`` (8192
  envs, batch 256 x 32 minibatches, unroll 20, 4 updates, 512-256-128
  networks, the value network on ``privileged_state``) for GO2_TRAIN_STEPS
  training step(s) in one epoch, no evaluation inside (run_training).  Then
  K1 and K4 on the recorded inputs of the control step after training
  against
  their plain versions, the card-vs-CPU SGD check on the first minibatch
  (dict observations) and the evaluator.  ``expect(S)`` gives the launch
  counts of S substeps (GO2_TRAIN_LAUNCHES by default), ``k4_check(tag,
  args)`` K4's row (k4_row at the inputs' schedule by default).  Returns
  (the kernels' launches in training, K4's row)."""
  import functools

  cfg, nf, per_step = tuned_config(port, name, GO2_TRAIN_STEPS)
  factory = functools.partial(port.networks.make_ppo_networks, **nf)
  env0 = port.envs.load(name, device=DEV)
  r = run_training(
      torch, port, lk,
      lambda progress_fn: port.ppo.train(
          environment=env0, network_factory=factory, seed=SEED, device=DEV,
          progress_fn=progress_fn, **cfg),
      lambda: factory(env0.observation_size, env0.action_size))
  make_policy, (norm, net), _ = r.out
  n_mb = cfg.num_updates_per_batch * cfg.num_minibatches
  training_checks(torch, r, tag, GO2_TRAIN_STEPS, per_step,
                  cfg.unroll_length, env0.n_substeps, n_mb, cfg.num_envs,
                  norm, net, expect or GO2_TRAIN_LAUNCHES, card)
  B = cfg.num_envs
  label = f'{"Go2" if name == GO2_ENV else name} training, B {B}'
  k4_args = r.calls['_newton_lanes_core'][-1]
  if k4_args[6].shape[-1] != B:
    raise SystemExit(f'{tag}: the recorded kernel inputs are not of '
                     'training')
  k4 = (k4_check or (lambda t, a: k4_row(torch, lk, t, a, [(a[1], a[2])])))(
      label, k4_args)
  report({f'K1 spd_solve_lanes ({label})': k1_row(
              torch, lk, label, r.calls['spd_solve_lanes'][-2:]),
          f'K4 _newton_lanes_core ({label})': k4})
  del r.calls, k4_args
  sgd_check(torch, port, r.rec, tag=tag)
  profile_sgd(torch, recorded_sgd_step(torch, port, r.rec, DEV,
                                       torch.float32)[1],
              sorted(r.sgd_ms)[len(r.sgd_ms) // 2], tag=tag)
  run_eval(torch, port, env0, make_policy, (norm, net), cfg.episode_length,
           tag)
  return r.launches, k4


# env-parameter tuning on the demo data (logs/rsr_demo_r4/README.md): the
# demo's command and the slip run of tuned_params_slip_k8pd.json, each cut to
# a few Adam steps (the demo's from 6 to 4 once phase 10 came and to 2 once
# phase 11 came, to keep the script within 12 minutes): (tag, first
# transition, transitions, rollout horizon k, per_dim_error, Adam steps)
TUNE_RUNS = (('demo', 15, 30, 1, False, 2),
             ('slip k8pd', 15, 30, 8, True, 1))
TUNE_INIT, TUNE_LR = 0.4, 0.005
TUNE_FD_STEP = 1e-4  # the differences of the float64 loss printed beside
# per substep of a gradient step: the forward K1 twice, K2, K3; the
# recomputation K1 twice, K2, K4; the backward K1 three times (the implicit
# solve's, the IFT solve, the smooth solve's), except in the first substep:
# its state carries no gradient and the smooth stage reads no tuned leaf, so
# its smooth solve has no backward (what XLA's dead-code elimination leaves
# of JAX's backward too)
TUNE_LAUNCHES = lambda S: {
    'spd_solve_lanes': 7 * S - 1, 'contact_select_lanes': 2 * S,
    'newton_lanes_pyr_t': S, '_newton_lanes_core': S}
# the template: the reset's forward, then one control step (4 substeps)
TUNE_TEMPLATE_LAUNCHES = {'spd_solve_lanes': 9, 'contact_select_lanes': 5,
                          'newton_lanes_pyr_t': 5, '_newton_lanes_core': 0}


def state_to(torch, state, device, dtype):
  """A copy of a ``core.State`` on ``device``, its floating tensors in
  ``dtype``."""
  def mv(x):
    if not torch.is_tensor(x):
      return x
    return x.to(device, dtype) if x.is_floating_point() else x.to(device)
  return state.replace(
      data=state.data.map(mv), obs=mv(state.obs), reward=mv(state.reward),
      done=mv(state.done), metrics={k: mv(v) for k, v in state.metrics.items()},
      info={k: mv(v) for k, v in state.info.items()})


def tuning_loss_fn(port, env, run, template, device):
  """The tuning objective of ``run`` on ``env``, the loss that
  ``env_params_tuning`` descends."""
  _, s, n, k, per_dim, _ = run
  obs, act = port.tune_obs, port.tune_act
  return port.rsr_pipeline.make_env_tuning_loss(
      env, obs[s:s + n], act[s:s + n], obs[s + 1:s + n + 1],
      rollout_horizon=k, per_dim_error=per_dim, template=template,
      device=device)


def loss_and_grad(torch, fn, p, device, dtype):
  """The tuning loss and its gradient at the float32 parameter ``p``."""
  x = torch.tensor(p, dtype=torch.float32).to(device, dtype)
  x.requires_grad_(True)
  with torch.enable_grad():
    loss = fn(x)
    (g,) = torch.autograd.grad(loss, x)
  return loss.item(), g.item()


def tuning_reference(torch, port, env_g, run, card):
  """Check 1 of phase 7: at the initial parameter (which ties with the
  table's friction 0.4, so torch.maximum gives half the gradient to each
  side) and at 0.6, the card's loss and gradient against the CPU's float64
  as closely as the CPU's fp32 path is (the reference() criterion:
  |card − f64| <= 10·|cpu − f64| + 1e-6).

  Beside it, not held: the float64 gradient against a central difference
  of the float64 loss (step TUNE_FD_STEP) and the one-sided differences.
  The gradient is JAX's: the implicit function theorem at the iterate of
  the fixed 6 x 6 solve, which is the loss's derivative only where that
  solve has converged; from the tuning template's violent states it often
  has not, and the two part by up to 10 times (ROADMAP §3).  On the JAX
  package's own template (PRNGKey(0)) both packages give that same
  gradient, a tenth of the central difference, at 0.4 and 0.6
  (tests/torch_tuning_gradient.py); the card's template comes from the
  port's reset, so its gradient differs from the JAX record's.  The CPU
  tests hold the gradient to JAX's and to central differences where the
  solve converges (tests/test_torch_tuning.py)."""
  template = port.rsr_pipeline.tuning_template(env_g, DEV)
  f64 = torch.float64
  fns = {}
  for tag, dev, dtype in (('card', DEV, torch.float32),
                          ('cpu', 'cpu', torch.float32), ('f64', 'cpu', f64)):
    env = env_g if tag == 'card' else port.envs.load(RSR_ENV, device=dev,
                                                      dtype=dtype)
    tmpl = tuple(state_to(torch, st, dev, dtype) for st in template)
    fns[tag] = (tuning_loss_fn(port, env, run, tmpl, dev), dev, dtype)
  ok = True
  for p in (TUNE_INIT, 0.6):
    v = {t: loss_and_grad(torch, fn, p, dev, dtype)
         for t, (fn, dev, dtype) in fns.items()}
    good = True
    for i in range(2):  # loss, gradient
      d_card = abs(v['card'][i] - v['f64'][i])
      d_cpu = abs(v['cpu'][i] - v['f64'][i])
      good = good and d_card <= 10 * d_cpu + 1e-6
    fn64 = fns['f64'][0]
    e = TUNE_FD_STEP
    with torch.no_grad():
      x = torch.tensor(p, dtype=torch.float32).to(f64)
      lo, mid, hi = (fn64(x + d).item() for d in (-e, 0.0, e))
    fd, right, left = (hi - lo) / (2 * e), (hi - mid) / e, (mid - lo) / e
    g64 = v['f64'][1]
    log(f'tuning reference at {p}: loss card {v["card"][0]!r} CPU fp32 '
        f'{v["cpu"][0]!r} float64 {v["f64"][0]!r}; gradient card '
        f'{v["card"][1]!r} CPU fp32 {v["cpu"][1]!r} float64 {g64!r} '
        f'{"ok" if good else "FAIL"}; not held: differences of the float64 '
        f'loss (step {e}) central {fd!r}, right {right!r}, left {left!r}, '
        f'gradient/central {g64 / fd if fd else math.inf:.4g}')
    ok = ok and good
  if not ok:
    raise SystemExit('tuning: the card\'s loss or gradient disagrees with '
                     'the float64 reference')


def tuning_run(torch, port, lk, run, card, record=False):
  """One ``env_params_tuning`` run on the card from a fresh env, as the
  tuning CLI makes it: each Adam step timed by CUDA events, split into the
  forward (the loss) and the backward (the gradient, the containment and
  the update), with its launches.  ``record`` keeps the inputs of the last
  step's K4 call, its K2 call and the IFT systems K1 solved in it.
  Returns (per-step records, recorded calls, total launches)."""
  pipe = port.rsr_pipeline
  tag, s, n, k, per_dim, steps = run
  obs, act = port.tune_obs, port.tune_act
  env = port.envs.load(RSR_ENV, device=DEV)
  real_update, real_ift = pipe.tuning_update, port.solver._ift_cotangents
  rec, calls, in_ift = [], {'ift': []}, [False]

  def timed_update(loss_fn, params, optimizer, lo, hi):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    before = dict(lk.LAUNCHES)

    def timed_loss(x):
      out = loss_fn(x)
      ev[1].record()
      return out

    ev[0].record()
    loss = real_update(timed_loss, params, optimizer, lo, hi)
    ev[2].record()
    rec.append((ev, {kk: lk.LAUNCHES[kk] - before[kk] for kk in before},
                loss))
    return loss

  def ift(*a):
    in_ift[0] = True
    try:
      return real_ift(*a)
    finally:
      in_ift[0] = False

  pipe.tuning_update = timed_update
  if record:
    port.solver._ift_cotangents = ift
    k1 = lk.spd_solve_lanes

    def k1_rec(*a):
      if in_ift[0]:
        calls['ift'] = (calls['ift'] + [a])[-4:]
      return k1(*a)

  result = []

  def go():
    result.append(pipe.env_params_tuning(
        env, steps, TUNE_INIT, TUNE_INIT * 0.2, TUNE_INIT * 10.0,
        obs[s:s + n], act[s:s + n], obs[s + 1:s + n + 1],
        learning_rate=TUNE_LR, rollout_horizon=k, per_dim_error=per_dim,
        device=DEV))

  zero_launches(lk)
  try:
    if record:
      lk.spd_solve_lanes = k1_rec
      calls.update(record_calls(lk, go, keep=1))
    else:
      go()
  finally:
    pipe.tuning_update = real_update
    port.solver._ift_cotangents = real_ift
    if record:
      lk.spd_solve_lanes = k1
  return rec, calls, dict(lk.LAUNCHES), result[0]


def tuning_checks(torch, run, rec, launches, result, card):
  """Checks 2 and 3 of phase 7 on one run: finite losses, the parameter
  moved and within its bounds; the launches of every Adam step equal
  TUNE_LAUNCHES of its substeps, and the run's total adds the template's.
  Prints the trajectory and the times per Adam step after the first."""
  tag, s, n, k, per_dim, steps = run
  params, train_log = result
  torch.cuda.synchronize()
  fwd = [r[0][0].elapsed_time(r[0][1]) for r in rec]
  bwd = [r[0][1].elapsed_time(r[0][2]) for r in rec]
  S = 4 * k  # substeps of one rollout step of every window
  windows = n - k + 1 if k > 1 else n
  per_step = TUNE_LAUNCHES(S)
  failed = []
  for i, r in enumerate(rec):
    if r[1] != per_step:
      failed.append(f'step {i} launches {r[1]} != {per_step}')
  total = {kk: TUNE_TEMPLATE_LAUNCHES[kk] + steps * per_step[kk]
           for kk in per_step}
  if launches != total:
    failed.append(f'run launches {launches} != {total}')
  losses = train_log['loss']
  traj = [float(p) for p in train_log['params']]
  if not all(math.isfinite(x) for x in losses):
    failed.append('a loss is not finite')
  lo, hi = TUNE_INIT * 0.2, TUNE_INIT * 10.0
  if not (traj[-1] != TUNE_INIT and all(lo - 1e-7 <= p <= hi + 1e-7
                                        for p in traj)):
    failed.append(f'parameter trajectory {traj} did not move or left '
                  f'[{lo}, {hi}]')
  after = slice(1, None) if steps > 1 else slice(None)
  mean = lambda xs: sum(xs) / len(xs)
  log(f'tuning {tag}: {n} transitions from {s}, k {k}, per_dim_error '
      f'{per_dim}, {windows} windows of {S} substeps, lr {TUNE_LR}; loss '
      f'{losses}; friction {traj}; s per Adam step after the first (CUDA '
      f'events): {mean(fwd[after]) / 1e3 + mean(bwd[after]) / 1e3:.4f} '
      f'(forward {mean(fwd[after]) / 1e3:.4f}, backward and update '
      f'{mean(bwd[after]) / 1e3:.4f}); first step {(fwd[0] + bwd[0]) / 1e3:.4f}'
      f' s; launches per Adam step {per_step}; card {card}')
  if failed:
    raise SystemExit(f'tuning {tag} failed: {failed}')
  return (mean(fwd[after]) + mean(bwd[after])) / 1e3


def k2_grad_check(torch, lk, args):
  """Check 5 of phase 7: on the recorded selection, K2's picks equal the
  plain version's exactly, and K2's backward (``contact_select_backward``
  on the kernel's picks) equals the autograd backward of the plain gather
  on the same seeded cotangent: the slot cotangents exactly (one pick per
  slot and env), the pair rows within 1e-5 of their scale (the pair rows
  sum over envs in two atomic orders)."""
  pair_struct, nsel, dist_l, feat_dyn, ptab = args
  sel_k, picks_k = lk.contact_select_lanes(*args)
  sel_p, picks_p = lk.contact_select_plain(*args)
  g = torch.randn(sel_k.shape, generator=torch.Generator(
      device=DEV).manual_seed(SEED), device=DEV)
  gf_k, gt_k = lk.contact_select_backward(pair_struct, picks_k, g,
                                          feat_dyn.shape[0],
                                          feat_dyn.shape[1], ptab.shape[0])
  f = feat_dyn.clone().requires_grad_(True)
  t = ptab.clone().requires_grad_(True)
  with torch.enable_grad():
    sel, _ = lk.contact_select_plain(pair_struct, nsel, dist_l, f, t)
    gf_p, gt_p = torch.autograd.grad(sel, (f, t), g)
  same_picks = torch.equal(picks_k, picks_p) and torch.equal(sel_k, sel_p)
  err_t = (gt_k - gt_p).abs().max().item()
  ok = (same_picks and torch.equal(gf_k, gf_p)
        and err_t <= 1e-5 * gt_p.abs().max().item() + 1e-12)
  log(f'K2 under the gradient (tuning recomputation, {dist_l.shape[0]} -> '
      f'{nsel} slots, B {dist_l.shape[1]}): picks {"equal" if same_picks else "DIFFER"}; '
      f'backward: slot cotangents {"exact" if torch.equal(gf_k, gf_p) else "DIFFER"}, '
      f'pair rows max |kernel - plain| {err_t:.3e} {"ok" if ok else "FAIL"}')
  if not ok:
    raise SystemExit('K2 backward disagrees with the plain gather\'s')


def k4_every_E(torch, lk, tag, args, first_order=None):
  """K4 on recorded inputs at every E that fits, under k4_ratios'
  criteria at the inputs' schedule (``first_order``: as k4_ratios)."""
  seen, parts, ok = {}, [], True
  with force_E(lk, None, seen):
    lk._newton_lanes_core(*args)
  for E in seen['fits']:
    with force_E(lk, E):
      _, r = k4_ratios(torch, lk, args, [(args[1], args[2])],
                       first_order=first_order)
    parts.append(f'E {E} {max(max(v) for (w, _), v in r.items() if w == "kernel"):.3g}')
    ok = ok and kernel_ok(r)
  log(f'K4 {tag} at every E that fits (chosen {seen["chosen"]}), worst '
      f'error/tolerance: ' + ', '.join(parts) + (' ok' if ok else ' FAIL'))
  return ok


def profile_tuning_step(torch, port, lk, run, step_s):
  """One Adam step of ``run`` under torch.profiler: device busy time, the
  idle share against the unprofiled step (``step_s``), device kernels."""
  from torch.profiler import ProfilerActivity, profile

  pipe = port.rsr_pipeline
  _, s, n, k, per_dim, _ = run
  env = port.envs.load(RSR_ENV, device=DEV)
  fn = tuning_loss_fn(port, env, run, None, DEV)
  x = torch.tensor(TUNE_INIT, device=DEV, requires_grad=True)
  opt = port.ppo.make_optimizer([x], TUNE_LR)
  pipe.tuning_update(fn, x, opt, TUNE_INIT * 0.2, TUNE_INIT * 10.0)  # warm
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    t = time.perf_counter()
    pipe.tuning_update(fn, x, opt, TUNE_INIT * 0.2, TUNE_INIT * 10.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
  events = prof.key_averages()
  kernels = [e for e in events
             if e.device_type != torch.autograd.DeviceType.CPU]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  log(f'tuning profile: 1 Adam step (k {k}), device busy {busy_ms:.3f} ms, '
      f'idle share {1 - busy_ms / (step_s * 1e3):.4f} of the unprofiled '
      f'step ({step_s * 1e3:.3f} ms); under the profiler wall '
      f'{wall * 1e3:.3f} ms; {sum(e.count for e in kernels)} device kernels')
  os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
  with open(os.path.join(ROOT, 'chiprun_out', 'profile_tuning.txt'),
            'w') as f:
    f.write(events.table(sort_by='self_device_time_total', row_limit=40))


def tuning_phase(torch, port, lk, card):
  """Phase 7: ``rsr.pipeline.env_params_tuning`` on the card, on the demo
  data, in the two runs of TUNE_RUNS, each from a fresh env as the tuning
  CLI makes it; then the checks (see tuning_reference, tuning_checks,
  k2_grad_check, k4_every_E) and K4 and K1 on the last recomputation's own
  inputs.  Returns (the kernels' launches over both runs, rows for K4 and
  K1 on the tuning path)."""
  import_train(port)
  port.solver = _port_module('physics.solver')
  txt = port.rsr_datasets.txt_to_2d_array
  port.tune_obs = txt(os.path.join(RSR_DATA, 'real_obs.txt'))
  port.tune_act = txt(os.path.join(RSR_DATA, 'real_action.txt'))
  launches = dict.fromkeys(KERNELS, 0)
  demo_step_s, rows = None, {}
  for run in TUNE_RUNS:
    rec, calls, run_launches, result = tuning_run(
        torch, port, lk, run, card, record=run is TUNE_RUNS[0])
    step_s = tuning_checks(torch, run, rec, run_launches, result, card)
    for kk in launches:
      launches[kk] += run_launches[kk]
    if run is TUNE_RUNS[0]:
      demo_step_s = step_s
      k4 = calls['_newton_lanes_core'][-1]
      nv, R0, B = k4[6].shape
      tag = f'tuning recomputation, nv {nv}, R0 {R0}, B {B}'
      rows[f'K4 _newton_lanes_core ({tag})'] = k4_row(
          torch, lk, tag, k4, [(k4[1], k4[2])])
      if not k4_every_E(torch, lk, tag, k4):
        raise SystemExit('K4 disagrees at an E on the tuning path')
      ift = calls['ift']
      tag = f'tuning IFT systems, n {ift[-1][1].shape[0]}, B {B}'
      rows[f'K1 spd_solve_lanes ({tag})'] = k1_row(torch, lk, tag, ift)
      k2_grad_check(torch, lk, calls['contact_select_lanes'][-1])
      # K2 (forward and recomputation) and K3 (forward) at the tuning batch
      rows[f'K2 contact_select_lanes (tuning, B {B})'] = k2_row(
          torch, lk, calls['contact_select_lanes'][-1], tag='tuning')
      k3 = calls['newton_lanes_pyr_t'][-1]
      tag = f'tuning forward, B {B}'
      rows[f'K3 newton_lanes_pyr_t ({tag})'] = k3_row(torch, lk, tag, k3)
      e_sweep(torch, lk, f'K3 {tag}', lambda: lk.newton_lanes_pyr_t(*k3),
              'newton_pyr_kernel')
      del calls, k4, ift, k3
  env_g = port.envs.load(RSR_ENV, device=DEV)
  tuning_reference(torch, port, env_g, TUNE_RUNS[0], card)
  profile_tuning_step(torch, port, lk, TUNE_RUNS[0], demo_step_s)
  report(rows)
  return launches


# -- phase 8: SAC ------------------------------------------------------------

# SAC training steps of each run (one epoch); cut from 16 to 8 once phase 9
# came and to 4 once phase 11 came, to keep the script within 12 minutes
SAC_TRAIN_STEPS = 4
# actor steps of the replay prefill of the cube-push and Go2 SAC runs: the
# tables' min_replay_size over num_envs (98 and 49) cut to this once phase 10
# came, to keep the script within 12 minutes (the ring's capacity, the
# batch and the widths stay the tables')
SAC_PREFILL_STEPS = 12
SAC_PARAMS = os.path.join(ROOT, 'logs', 'cube_sac_500k_r5', 'final_params.pkl')
# the RSR CLI's SAC table (scripts/rsr_policy_training.py): 512 envs, batch
# 128, replay 10 000 / 200 000, networks 32 x 4
RSR_SAC_SIZES = dict(num_envs=512, batch_size=128, min_replay_size=10_000,
                     max_replay_size=200_000)


def sac_transition_floats(obs_size, action_size):
  """Floats of one stored transition: obs, action, reward, discount, next
  obs, truncation."""
  return 2 * obs_size + action_size + 3


def run_sac(torch, port, lk, train):
  """Run ``train(progress_fn)`` (``sac.train`` directly or through the RSR
  pipeline) instrumented: each actor step and each SGD step timed by CUDA
  events recorded at its boundaries, with no synchronise; the first SGD
  step's inputs recorded (a copy of the networks, target critics and log α,
  the normalizer, the batch, the three draws, ``make_losses``' arguments);
  the target critics copied before every SGD step; the replay ring's
  bytes (``torch.cuda.memory_allocated`` around its allocation) and last
  state; the kernels' launches zeroed just before; after it the kernel
  wrappers' arguments of one eager control step from the last training
  actor step's state (``record_last_step``).  Returns a namespace."""
  import copy
  import types

  r = types.SimpleNamespace(actor_ev=[], sgd_ev=[], progress=[], metrics=None,
                            rec=None, last=None, start=torch.cuda.Event(
                                enable_timing=True))
  sac, rb, losses_mod = port.sac, port.replay_buffer, port.sac_losses
  real = dict(actor=port.acting.actor_step, sgd=sac.sgd_step, init=rb.init,
              insert=rb.insert, losses=losses_mod.make_losses)

  def progress_fn(step, metrics):
    r.progress.append(step)
    r.metrics = metrics

  def timed(events, fn, *a, **k):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn(*a, **k)
    end.record()
    events.append((start, end))
    return out

  def make_losses(*a, **k):
    r.loss_args = (a, k)
    return real['losses'](*a, **k)

  def sgd_step(ts, losses, tr, noise, tau, max_grad_norm=None):
    if r.rec is None:
      r.rec = dict(net=copy.deepcopy(ts.networks),
                   target=copy.deepcopy(ts.target_q),
                   log_alpha=ts.log_alpha.detach().clone(),
                   normalizer=ts.normalizer_params, data=tr, noise=noise,
                   tau=tau, max_grad_norm=max_grad_norm,
                   lr=ts.policy_optimizer.param_groups[0]['lr'])
    r.ts = ts
    r.target_before = [p.detach().clone() for p in ts.target_q.parameters()]
    return timed(r.sgd_ev, real['sgd'], ts, losses, tr, noise, tau,
                 max_grad_norm)

  def init(capacity, dummy):
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = real['init'](capacity, dummy)
    torch.cuda.synchronize()
    r.buffer_bytes = torch.cuda.memory_allocated() - before
    return state

  def insert(state, batch):
    r.buffer = real['insert'](state, batch)
    return r.buffer

  def actor(*a, **k):
    out = timed(r.actor_ev, real['actor'], *a, **k)
    r.last = last_step_args(real['actor'], a, k, out) or r.last
    return out

  port.acting.actor_step = actor
  sac.sgd_step, rb.init, rb.insert = sgd_step, init, insert
  losses_mod.make_losses = make_losses
  out = []
  zero_launches(lk)
  try:
    r.start.record()
    out.append(train(progress_fn))
  finally:
    port.acting.actor_step, sac.sgd_step = real['actor'], real['sgd']
    rb.init, rb.insert = real['init'], real['insert']
    losses_mod.make_losses = real['losses']
  r.launches = dict(lk.LAUNCHES)
  r.calls = record_last_step(lk, port, r.last)
  del r.last
  r.out = out[0]
  torch.cuda.synchronize()
  r.actor_ms = [a.elapsed_time(b) for a, b in r.actor_ev]
  r.sgd_ms = [a.elapsed_time(b) for a, b in r.sgd_ev]
  return r


def sac_replay(torch, port, rec, loss_args, dev, dtype):
  """The recorded first SGD step replayed on ``dev`` in ``dtype``: a copy
  of the recorded networks, target critics and log α, fresh Adams (as the
  first step has), ``make_losses`` with the recorded arguments, one
  ``sac.sgd_step``.  Returns (metrics as floats, {name: gradient in
  float64 on the CPU}, the networks)."""
  import copy

  cast = lambda x: x.to(dev, dtype if x.is_floating_point() else None)
  net = copy.deepcopy(rec['net']).to(dev, dtype)
  target = copy.deepcopy(rec['target']).to(dev, dtype)
  log_alpha = rec['log_alpha'].to(dev, dtype).clone().requires_grad_(True)
  opt = port.ppo.make_optimizer
  ts = port.sac.TrainingState(
      networks=net, target_q=target, log_alpha=log_alpha,
      policy_optimizer=opt(net.policy.parameters(), rec['lr']),
      q_optimizer=opt(net.q.parameters(), rec['lr']),
      alpha_optimizer=opt([log_alpha], 3e-4),
      normalizer_params=port.rs.to(rec['normalizer'], dev, dtype))
  a, k = loss_args
  k = dict(k)
  if k.get('past_data') is not None:
    k['past_data'] = k['past_data'].to(dev, dtype)
  losses = port.sac_losses.make_losses(net, *a[1:], **k)
  metrics = port.sac.sgd_step(
      ts, losses, port.wrappers.tree_map(cast, rec['data']),
      [cast(n) for n in rec['noise']], rec['tau'], rec['max_grad_norm'])
  grads = {'log_alpha': log_alpha.grad.to('cpu', torch.float64)}
  grads.update({k: p.grad.to('cpu', torch.float64)
                for k, p in net.named_parameters()})
  return {k: v.item() for k, v in metrics.items()}, grads, net


def sac_rsr_grads(torch, port, rec, loss_args, dev, dtype):
  """The gradient of the actor loss's RSR term alone (``rsr.
  compute_rsr_loss`` on the raw observations and the sampled, postprocessed
  action of the recorded actor draw) with respect to the policy parameters,
  on ``dev`` in ``dtype``: {name: gradient in float64 on the CPU}."""
  import copy

  k = loss_args[1]
  cast = lambda x: x.to(dev, dtype)
  net = copy.deepcopy(rec['net']).to(dev, dtype)
  data = port.wrappers.tree_map(cast, rec['data'])
  obs = data.observation
  if k.get('normalize_fn') is not None:
    obs = k['normalize_fn'](port.rs.to(rec['normalizer'], dev, dtype), obs)
  dist = net.distribution
  with torch.enable_grad():
    raw = dist.sample_no_postprocess(net.policy_logits(obs),
                                     cast(rec['noise'][2]))
    loss, _ = port.rsr.compute_rsr_loss(
        data.observation, dist.postprocess(raw), data.next_observation,
        k['past_data'].to(dev, dtype), loss_scale=k['rsr_loss_scale'])
    params = dict(net.policy.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
  return {n: g.to('cpu', torch.float64) for n, g in zip(params, grads)}


def sac_sgd_check(torch, port, r, tag) -> None:
  """The card against the CPU on the recorded first SGD step: replayed
  (sac_replay) on the card in fp32, on the CPU in fp32 and on the CPU in
  float64.  Per metric (the three losses and the new α) |m − m64| <=
  1e-5·|m64| + 1e-6, per gradient tensor (log α, policy, critics) max |g −
  g64| <= 1e-4·max |g64|, for the card and the CPU fp32 run alike (a
  criterion the CPU run fails is the wrong criterion).  With the RSR
  penalty on, the gradient of the penalty alone (sac_rsr_grads) is held
  to float64 the same way and must not be zero."""
  f64 = torch.float64
  out = {who: sac_replay(torch, port, r.rec, r.loss_args, dev, dtype)[:2]
         for who, dev, dtype in (('card', DEV, torch.float32),
                                 ('cpu', 'cpu', torch.float32),
                                 ('f64', 'cpu', f64))}
  m64, g64 = out['f64']
  grad_ratio = lambda g, ref: max(
      ((g[k] - ref[k]).abs().max() / (1e-4 * ref[k].abs().max() + 1e-30))
      .item() for k in ref)
  rsr = r.loss_args[1].get('past_data') is not None
  if rsr:
    s64 = sac_rsr_grads(torch, port, r.rec, r.loss_args, 'cpu', f64)
    s_max = max(g.abs().max().item() for g in s64.values())
  ok = not rsr or s_max > 0
  for who, dev in (('card', DEV), ('cpu', 'cpu')):
    m, g = out[who]
    ratios = [max(abs(m[k] - m64[k]) / (1e-5 * abs(m64[k]) + 1e-6)
                  for k in m), grad_ratio(g, g64)]
    extra = ''
    if rsr:
      ratios.append(grad_ratio(sac_rsr_grads(torch, port, r.rec, r.loss_args,
                                             dev, torch.float32), s64))
      extra = (f', worst RSR-term gradient error/tolerance {ratios[-1]:.3g} '
               f'(largest float64 entry {s_max:.6g})')
    good = max(ratios) <= 1.0
    log(f'{tag} SGD check, {who} fp32 against CPU float64 on the first SGD '
        f'step ({r.rec["data"].reward.shape[0]} transitions): worst '
        f'loss/alpha error/tolerance {ratios[0]:.3g}, worst gradient '
        f'error/tolerance {ratios[1]:.3g} (log alpha, policy, critics)'
        f'{extra} {"ok" if good else "FAIL"}')
    ok = ok and good
  log(f'{tag} SGD check, float64 metrics: '
      + ', '.join(f'{k} {v:.6g}' for k, v in m64.items()))
  if not ok:
    raise SystemExit(f'{tag}: the card\'s SGD step disagrees with the CPU'
                     + (' or the penalty has no gradient' if rsr else ''))


def sac_checks(torch, r, tag, n_envs, prefill, capacity, obs_size,
               action_size, n_sub, expect_of, card):
  """Print a SAC run's rates, losses, buffer and memory, and fail on a
  non-finite metric, on env steps, a normalizer count or a buffer size
  other than the actor steps gave, on the policy, critics or log α left
  unchanged, on target critics other than (1 − τ)·old + τ·new of the last
  step (to fp32 rounding), on launch counts other than
  ``expect_of(substeps)``."""
  make_policy, (norm, net), metrics = r.out
  steps = len(r.actor_ms)
  substeps = steps * n_sub
  total = steps * n_envs
  train_ms = r.actor_ms[prefill:]
  prefill_s = r.start.elapsed_time(r.actor_ev[prefill - 1][1]) / 1e3
  mean = lambda xs: sum(xs) / len(xs)
  med = lambda xs: sorted(xs)[len(xs) // 2]
  expect_bytes = capacity * sac_transition_floats(obs_size, action_size) * 4
  log(f'{tag}: {n_envs} envs, prefill {prefill} actor steps ({prefill * n_envs}'
      f' env-steps) in {prefill_s:.3f} s, {steps - prefill} training steps '
      f'of 1 actor step and {len(r.sgd_ms) // max(steps - prefill, 1)} SGD '
      f'step(s); training/sps {metrics["training/sps"]:.1f} env-steps/s, '
      f'training/walltime {metrics["training/walltime"]:.3f} s; CUDA-event '
      f'spans, no synchronise: actor step {mean(r.actor_ms):.3f} ms (prefill '
      f'{mean(r.actor_ms[:prefill]):.3f}, training {mean(train_ms):.3f}; '
      f'{mean(r.actor_ms) / n_sub:.3f} per substep), SGD '
      f'{mean(r.sgd_ms):.3f} ms per gradient step (median '
      f'{med(r.sgd_ms):.3f}); losses: '
      + ', '.join(f'{k} {metrics[f"training/{k}"]:.6g}'
                  for k in ('critic_loss', 'actor_loss', 'alpha_loss',
                            'alpha'))
      + f'; buffer size {r.buffer.size} of {capacity}, insert position '
      f'{r.buffer.insert_position}, {r.buffer_bytes} bytes allocated on the '
      f'card ({expect_bytes} for {sac_transition_floats(obs_size, action_size)}'
      f' floats a transition); launches in training {r.launches}; card {card}')
  failed = [k for k, v in metrics.items() if not math.isfinite(v)]
  if r.progress != [total]:
    failed.append(f'env steps {r.progress} != {total}')
  if float(norm.count) != total:
    failed.append(f'normalizer count {float(norm.count)} != {total}')
  if (r.buffer.size, r.buffer.insert_position) != (min(total, capacity),
                                                   total % capacity):
    failed.append(f'buffer size / position {r.buffer.size} / '
                  f'{r.buffer.insert_position} after {total} inserts into '
                  f'{capacity}')
  if r.buffer_bytes < expect_bytes:
    failed.append(f'the buffer took {r.buffer_bytes} bytes on the card, '
                  f'less than its {expect_bytes}')
  first = r.rec
  same = [k for k, v in net.state_dict().items()
          if torch.equal(v, first['net'].state_dict()[k])]
  if torch.equal(r.ts.log_alpha.detach(), first['log_alpha']):
    same.append('log_alpha')
  if same:
    failed.append(f'parameters unchanged by training: {same}')
  tau = first['tau']
  t_err = 0.0
  for old, new, t in zip(r.target_before, net.q.parameters(),
                         r.ts.target_q.parameters()):
    old, new, t = old.double(), new.detach().double(), t.double()
    want = old * (1 - tau) + new * tau
    tol = 4 * U32 * (old.abs() * (1 - tau) + new.abs() * tau) + 1e-30
    t_err = max(t_err, ((t - want).abs() / tol).max().item())
  log(f'{tag}: target critics after the last step against (1 - tau)·old + '
      f'tau·new (tau {tau}): worst error/(4u of the terms) {t_err:.3g}')
  if t_err > 1.0:
    failed.append('target critics are not the tau update of the last step')
  if r.launches != expect_of(substeps):
    failed.append(f'launches in training {r.launches} != '
                  f'{expect_of(substeps)}')
  if failed:
    raise SystemExit(f'{tag} failed: {failed}')
  return med(r.sgd_ms)


def sac_config_run(port, env_name, steps):
  """(config, hidden sizes, prefill actor steps) of the tuned SAC config of
  ``env_name`` cut to ``steps`` training steps in one epoch with no
  evaluation inside (``num_evals`` 0: one epoch, as 2 gives, without its
  two evaluations of a whole episode)."""
  cfg = port.configs.sac_config(env_name)
  hidden = tuple(cfg.pop('network_factory')['hidden_layer_sizes'])
  cfg.pop('policy_obs_key', None)
  prefill = min(math.ceil(cfg.min_replay_size / cfg.num_envs),
                SAC_PREFILL_STEPS)
  cfg.min_replay_size = prefill * cfg.num_envs
  cfg.update(num_timesteps=(prefill + steps) * cfg.num_envs, num_evals=0)
  return cfg, hidden, prefill


def sac_phase(torch, port, lk, card):
  """Phase 8: SAC with its replay ring on the card, three runs at full
  width, each cut to SAC_TRAIN_STEPS training steps after its prefill: (a)
  ``sac.train`` with ``configs.sac_config`` on cube-push, (b) ``rsr.
  pipeline.policy_params_training(algorithm='sac')`` at the RSR CLI's SAC
  table, (c) ``sac.train`` on the Go2 joystick's 'state' entry
  (``SelectObservationWrapper``) at its SAC table.  Each: sac_checks, the
  kernels of the control step after training under phase 2's criteria at
  every
  E, the SGD check, one SGD step under the profiler; (a) and (c) the
  evaluator.  Then the trained JAX SAC policy of logs/cube_sac_500k_r5
  served on cube-push.  Returns the kernels' launches over the phase."""
  import functools

  import_train(port)
  mod = _port_module
  port.sac, port.sac_networks = mod('train.sac'), mod('train.sac_networks')
  port.sac_losses = mod('train.sac_losses')
  port.replay_buffer = mod('train.replay_buffer')
  launches = dict.fromkeys(KERNELS, 0)

  def add(r):
    for k in launches:
      launches[k] += r[k]

  # (a) cube-push
  cfg, hidden, prefill = sac_config_run(port, ENV, SAC_TRAIN_STEPS)
  factory = functools.partial(port.sac_networks.make_sac_networks,
                              hidden_layer_sizes=hidden)
  env0 = port.envs.load(ENV, device=DEV)
  r = run_sac(torch, port, lk, lambda progress_fn: port.sac.train(
      environment=env0, network_factory=factory, seed=SEED, device=DEV,
      progress_fn=progress_fn, **cfg))
  step_ms = sac_checks(torch, r, 'sac', cfg.num_envs, prefill,
                       cfg.max_replay_size, 23, 5, env0.n_substeps,
                       CUBE_TRAIN_LAUNCHES, card)
  add(r.launches)
  cube_kernel_rows(torch, lk, r.calls, cfg.num_envs, 'sac training')
  del r.calls
  sac_sgd_check(torch, port, r, 'sac')
  profile_sgd(torch, lambda: sac_replay(torch, port, r.rec, r.loss_args, DEV,
                                        torch.float32), step_ms, tag='sac')
  make_policy, params, _ = r.out
  run_eval(torch, port, env0, make_policy, params, cfg.episode_length, 'sac')
  del r, make_policy, params

  # (b) RSR SAC
  arrays = port.rsr_datasets.load_rsr_datasets(RSR_DATA, 50, device=DEV)
  env0 = port.envs.load(RSR_ENV, device=DEV)
  sizes = RSR_SAC_SIZES
  B = sizes['num_envs']
  prefill = math.ceil(sizes['min_replay_size'] / B)
  factory = functools.partial(port.sac_networks.make_sac_networks,
                              hidden_layer_sizes=(32,) * 4)
  r = run_sac(torch, port, lk,
              lambda progress_fn: port.rsr_pipeline.policy_params_training(
                  env0, algorithm='sac', past_states=arrays[0],
                  past_actions=arrays[1], past_next_states_real=arrays[2],
                  past_next_states_sim=arrays[3],
                  current_next_states_sim=arrays[4], bandwidth=RSR_BANDWIDTH,
                  rsr_loss_scale=1.0,
                  num_timesteps=(prefill + SAC_TRAIN_STEPS) * B, num_evals=0,
                  network_factory=factory, progress_fn=progress_fn, seed=SEED,
                  device=DEV, **sizes))
  r.out = r.out + (r.metrics,)
  past = r.loss_args[1]['past_data']
  log(f'rsr sac: bandwidth {RSR_BANDWIDTH}, gate weight KL(real || previous '
      f'sim) {past.weight.item():.6g}, rsr_loss_scale '
      f'{r.loss_args[1]["rsr_loss_scale"]}')
  sac_checks(torch, r, 'rsr sac', B, prefill, sizes['max_replay_size'], 23, 5,
             env0.n_substeps, CUBE_TRAIN_LAUNCHES, card)
  add(r.launches)
  cube_kernel_rows(torch, lk, r.calls, B, 'rsr sac training')
  del r.calls
  sac_sgd_check(torch, port, r, 'rsr sac')
  del r

  # (c) the Go2 joystick
  cfg, hidden, prefill = sac_config_run(port, GO2_ENV, SAC_TRAIN_STEPS)
  factory = functools.partial(port.sac_networks.make_sac_networks,
                              hidden_layer_sizes=hidden)
  env0 = port.wrappers.SelectObservationWrapper(
      port.envs.load(GO2_ENV, device=DEV), 'state')
  r = run_sac(torch, port, lk, lambda progress_fn: port.sac.train(
      environment=env0, network_factory=factory, seed=SEED, device=DEV,
      progress_fn=progress_fn, **cfg))
  step_ms = sac_checks(torch, r, 'go2 sac', cfg.num_envs, prefill,
                       cfg.max_replay_size, 48, 12, env0.n_substeps,
                       GO2_TRAIN_LAUNCHES, card)
  add(r.launches)
  B, tag = cfg.num_envs, f'Go2 SAC training, B {cfg.num_envs}'
  k4_args = r.calls['_newton_lanes_core'][-1]
  if k4_args[6].shape[-1] != B:
    raise SystemExit('go2 sac: the recorded kernel inputs are not of '
                     'training')
  report({f'K1 spd_solve_lanes ({tag})': k1_row(
              torch, lk, tag, r.calls['spd_solve_lanes'][-2:]),
          f'K4 _newton_lanes_core ({tag})': k4_row(
              torch, lk, tag, k4_args, [(k4_args[1], k4_args[2])])})
  if not k4_every_E(torch, lk, tag, k4_args):
    raise SystemExit('K4 disagrees at an E on the Go2 SAC path')
  del r.calls, k4_args
  sac_sgd_check(torch, port, r, 'go2 sac')
  profile_sgd(torch, lambda: sac_replay(torch, port, r.rec, r.loss_args, DEV,
                                        torch.float32), step_ms,
              tag='go2 sac')
  make_policy, params, _ = r.out
  run_eval(torch, port, env0, make_policy, params, cfg.episode_length,
           'go2 sac')
  del r, make_policy, params

  # serving a trained SAC policy of the JAX package
  normalizer, policy_params = port.sac.load_params(SAC_PARAMS)
  policy = port.sac_networks.make_policy(normalizer, policy_params,
                                         device=DEV)
  env0 = port.envs.load(ENV, device=DEV)
  env = port.wrappers.wrap_for_training(env0, episode_length=1200,
                                        num_envs=ENVS)
  state = env.reset(torch.Generator(device=DEV).manual_seed(SEED))
  _, served, _ = rollout_cube(torch, lk, env0, env, policy, state, card,
                              tag=f'sac serve ({os.path.relpath(SAC_PARAMS, ROOT)})')
  add(served)
  return launches


TPUSH_ENV = 'AirbotTPush'
# T-push PPO training steps (20480 env-steps each: SHORT_MINIBATCHES)
TPUSH_TRAIN_STEPS = 1
# control steps of the evaluator's episode after it; cut from 25 to 10 once
# phase 10 came and to 5 once phase 11 came
TPUSH_EVAL_STEPS = 5
DR_TRAIN_STEPS = 1  # PPO training steps with domain randomisation
# what each randomiser may do to each field it batches, per entry against
# the nominal model (envs/airbot/randomize.py, envs/go2/randomize.py):
# ('scale', lo, hi) multiplies by a draw in [lo, hi]; ('add', lo, hi) adds
# one; ('floor', lo, hi) sets the floor geom's sliding friction to one and
# leaves every other entry; ('torso', lo, hi) scales every body mass and
# adds ±3 kg to the torso's
DR_FIELDS = {
    ENV: {'geom_friction': ('scale', 0.68, 1.32),
          'body_mass': ('scale', 0.84, 1.16),
          'dof_damping': ('scale', 0.92, 1.08),
          'dof_frictionloss': ('scale', 0.92, 1.08)},
    GO2_ENV: {'geom_friction': ('floor', 0.4, 1.0),
              'dof_frictionloss': ('scale', 0.9, 1.1),
              'dof_armature': ('scale', 1.0, 1.05),
              'actuator_gainprm': ('scale', 0.95, 1.05),
              'actuator_biasprm': ('scale', 0.95, 1.05),
              'dof_damping': ('scale', 0.95, 1.05),
              'body_ipos': ('add', -0.2, 0.2),
              'body_mass': ('torso', 0.9, 1.1),
              'qpos0': ('add', -0.05, 0.05)},
}


def tpush_params(torch, port):
  """(normalizer, PPONetworks) of the T-push phase's policy: PPO networks
  at the Airbot widths (16 -> 32 x 4 -> 10, value 256 x 5) initialised on
  the CPU from SEED, with a fresh normalizer.  The repo holds no trained
  T-push policy: the path is what is checked."""
  rs = _port_module('train.running_statistics')
  net = port.networks.make_ppo_networks(
      16, 5, policy_hidden_layer_sizes=(32,) * 4,
      value_hidden_layer_sizes=(256,) * 5).init(
          torch.Generator().manual_seed(SEED))
  return rs.init_state(16, 'cpu'), net


def tpush_policy(torch, port, device):
  """The deterministic policy of tpush_params, carried as a
  ``final_params.pkl`` is (``ppo_params_to_numpy``) and served through
  ``networks.make_policy``."""
  normalizer, params = port.networks.ppo_params_to_numpy(
      *tpush_params(torch, port))
  return port.networks.make_policy(normalizer, params, device=device)


def tpush_phase(torch, port, lk, card):
  """9a: the T-push path, ``envs.load('AirbotTPush')`` ->
  ``wrap_for_training`` at B = ENVS, the seeded policy (tpush_policy).  K1,
  K2 and K3 on the inputs of one control step under phase 2's checks
  (K2 on 720 slots -> 32, its keys in shared memory; K3 at nv 14, a width
  not compiled in; K1 at n 14); the shared memory of K2 and K3 at the E
  their wrappers choose; 256 envs against the CPU in fp32 and float64;
  STEPS control steps; one more under the profiler.  Returns the
  rollout's launches."""
  gen = torch.Generator(device=DEV).manual_seed(SEED)
  env0 = port.envs.load(TPUSH_ENV, device=DEV)
  env = port.wrappers.wrap_for_training(env0, episode_length=1200,
                                        num_envs=ENVS)
  policy = tpush_policy(torch, port, DEV)
  state = env.reset(gen)
  d0 = state.data
  calls = record_calls(lk, lambda: env.step(state, policy(state.obs)))
  k2, k3 = calls['contact_select_lanes'][-1], calls['newton_lanes_pyr_t'][-1]
  m = env0.model
  (ncon, Fd, B), (Ptot, nst) = k2[3].shape, k2[4].shape
  nv, Rs, C, naxes = k3[6].shape[0], k3[6].shape[1], k3[12].shape[0], k3[13]
  e2, e3 = {}, {}
  with force_E(lk, None, e2):
    lk.contact_select_lanes(*k2)
  with force_E(lk, None, e3):
    lk.newton_lanes_pyr_t(*k3)
  smem2 = lk.contact_select_smem_bytes(ncon, k2[1], Ptot, nst, e2['chosen'])
  smem3 = lk.newton_pyr_smem_bytes(nv, Rs, C, naxes, e3['chosen'])
  log(f'tpush: {TPUSH_ENV} nq {m.nq}, nv {m.nv}, nu {m.nu}; K2 {ncon} slots '
      f'-> {k2[1]} (Fd {Fd}, pair table {Ptot} x {nst}), E {e2["chosen"]} '
      f'of {e2["fits"]}: {smem2} bytes of shared memory a block; K3 nv {nv}, '
      f'{Rs} structured rows + {C} contacts x {naxes} axes x 2 = '
      f'{Rs + 2 * naxes * C} rows, E {e3["chosen"]} of {e3["fits"]}: '
      f'{smem3} bytes; limit {lk._SMEM_LIMIT}')
  if (ncon, k2[1], nv) != (720, 32, 14) or max(smem2, smem3) > lk._SMEM_LIMIT:
    raise SystemExit('tpush: unexpected kernel shapes or shared memory')
  tag = f'T-push, B {B}'
  rows = {
      f'K1 spd_solve_lanes ({tag})': k1_row(torch, lk, tag,
                                            calls['spd_solve_lanes'][-2:]),
      f'K2 contact_select_lanes ({tag})': k2_row(torch, lk, k2, tag='T-push'),
      f'K3 newton_lanes_pyr_t ({tag})': k3_row(torch, lk, tag, k3),
  }
  e_sweep(torch, lk, f'K3 {tag}', lambda: lk.newton_lanes_pyr_t(*k3),
          'newton_pyr_kernel')
  schedule_split(torch, f'K3 {tag}',
                 lambda it, ls: lk.newton_lanes_pyr_t(it, ls, *k3[2:]),
                 k3[0], k3[1], 'newton_pyr_kernel')
  report(rows)
  del calls, k2, k3
  n = REF_ENVS

  def tpush_envs(device, dtype):
    e = env0 if device == DEV else port.envs.load(TPUSH_ENV, device=device,
                                                  dtype=dtype)
    return e, e.reset_to(*(x[:n].to(device, dtype)
                           for x in (d0.qpos, d0.qvel, d0.ctrl)))

  reference(torch, 'T-push', tpush_envs, policy,
            tpush_policy(torch, port, 'cpu'), lambda s: s.obs)
  state, launches, step_ms = rollout_cube(
      torch, lk, env0, env, policy, state, card, tag='tpush slice',
      name=TPUSH_ENV)
  profile_control_step(torch, 'tpush', env, policy, state, step_ms)
  return launches


def dr_model_checks(torch, name, m0, mb, B):
  """The model the randomiser bound to the training envs: the fields of
  DR_FIELDS[name] and no other per env, each entry as its rule allows
  against the nominal ``m0``, every other leaf the nominal one; each
  field's values differ across envs (in at least 99 % of them: one float32
  draw per env, the floor's friction, repeats by chance in a few of 8192)
  and no two envs share a model.  Fails otherwise."""
  spec, bad = DR_FIELDS[name], []
  if mb.batched != frozenset(spec) or mb.batch_size != B:
    raise SystemExit(f'dr: batched {sorted(mb.batched)} of {mb.batch_size} '
                     f'envs, expected {sorted(spec)} of {B}')
  for f, x0 in m0.numeric.items():
    if f not in spec and x0 is not None and not torch.equal(
        mb.numeric[f], x0):
      bad.append(f'{f} differs from the nominal model')
  parts = []
  for f, (rule, lo, hi) in spec.items():
    x, x0 = mb.numeric[f], m0.numeric[f].expand(mb.numeric[f].shape)
    within = lambda v: bool(((v >= lo - 1e-6) & (v <= hi + 1e-6)).all())
    keep = torch.ones_like(x, dtype=torch.bool)
    if rule == 'floor':
      floor = m0.names['geom']['floor']
      keep[:, floor, 0] = False
      ok = within(x[:, floor, 0])
    elif rule == 'add':
      keep[:] = False
      ok = within(x - x0)
    else:
      nz, keep, ok = x0 != 0, x0 == 0, True
      if rule == 'torso':
        torso = m0.names['body']['trunk']
        extra = x[:, torso] - x0[:, torso]
        m = x0[0, torso].item()
        ok = bool(((extra >= -0.1 * m - 3 - 1e-4)
                   & (extra <= 0.1 * m + 3 + 1e-4)).all())
        nz[:, torso] = False
      ok = ok and within(x[nz] / x0[nz])
    ok = ok and torch.equal(x[keep], x0[keep])
    distinct = len(torch.unique(x.reshape(B, -1), dim=0))
    ok = ok and distinct >= 0.99 * B
    parts.append(f'{f} {rule} [{lo}, {hi}] {distinct} distinct '
                 f'{"ok" if ok else "FAIL"}')
    if not ok:
      bad.append(f'{f} outside its rule or not distinct ({distinct} of {B})')
  models = len(torch.unique(torch.cat(
      [mb.numeric[f].reshape(B, -1) for f in spec], dim=1), dim=0))
  if models != B:
    bad.append(f'{models} distinct models of {B}')
  log(f'dr {name}: {B} envs, one model each: ' + ', '.join(parts)
      + f'; {models} distinct models; every other leaf the nominal one'
      + (' ok' if not bad else f' FAIL {bad}'))
  if bad:
    raise SystemExit(f'dr {name}: the randomised model is wrong: {bad}')


def dr_train_phase(torch, port, lk, card, name):
  """9c (cube-push) and 9d (Go2): ``ppo.train`` at the tuned table of
  ``name`` with ``randomization_fn=envs.get_domain_randomizer(name)`` for
  DR_TRAIN_STEPS training step(s), no evaluation inside (run_training).
  The training envs' model on the card (dr_model_checks); the evaluator's
  env built without randomisation and the env handed in left nominal;
  training_checks; the terminated share of the rollouts (printed, not
  bounded: the Go2 masses move by up to 3 kg); K1, K2 (Fd 26: the per-env
  contact parameters ride with the dynamic features) and K3 (cube-push)
  or K1 and K4 (Go2) on the inputs of the control step after training at
  every E;
  then half the training envs driven to their time limit, one step: those
  restart from their first state, and every env keeps its own model.
  Returns the kernels' launches in training."""
  import functools

  cfg, nf, per_step = tuned_config(
      port, name, DR_TRAIN_STEPS, SHORT_MINIBATCHES if name == ENV else None)
  factory = functools.partial(port.networks.make_ppo_networks, **nf)
  env0 = port.envs.load(name, device=DEV)
  wrapped, real_wrap = [], port.wrappers.wrap_for_training

  def wrap(env, **kw):
    out = real_wrap(env, **kw)
    wrapped.append((kw.get('randomization_fn') is not None, out))
    return out

  port.wrappers.wrap_for_training = wrap
  try:
    r = run_training(
        torch, port, lk,
        lambda progress_fn: port.ppo.train(
            environment=env0, network_factory=factory, seed=SEED, device=DEV,
            progress_fn=progress_fn,
            randomization_fn=port.envs.get_domain_randomizer(name), **cfg),
        lambda: factory(env0.observation_size, env0.action_size))
  finally:
    port.wrappers.wrap_for_training = real_wrap
  _, (norm, net), _ = r.out
  tag, B = f'{name} DR train', cfg.num_envs
  [(dr, train_env), (eval_dr, eval_env)] = wrapped
  if not dr or eval_dr or eval_env.unwrapped.model.batched or (
      env0.model.batched):
    raise SystemExit(f'{tag}: randomisation reached the evaluator or the '
                     'env handed in, or missed the training envs')
  mb = train_env.unwrapped.model
  dr_model_checks(torch, name, env0.model, mb, B)
  n_mb = cfg.num_updates_per_batch * cfg.num_minibatches
  go2 = name == GO2_ENV
  training_checks(torch, r, tag, DR_TRAIN_STEPS, per_step, cfg.unroll_length,
                  env0.n_substeps, n_mb, B, norm, net,
                  GO2_TRAIN_LAUNCHES if go2 else CUBE_TRAIN_LAUNCHES, card)
  n_steps = r.seen
  log(f'{tag}: done flags in the rollouts {int(r.done.item())} of '
      f'{n_steps} env-steps, terminated (not by the time limit) '
      f'{int(r.terminated.item())}, share {r.terminated.item() / n_steps:.5f}')
  label = f'{name} DR training, B {B}'
  if go2:
    k4_args = r.calls['_newton_lanes_core'][-1]
    report({f'K1 spd_solve_lanes ({label})': k1_row(
                torch, lk, label, r.calls['spd_solve_lanes'][-2:]),
            f'K4 _newton_lanes_core ({label})': k4_row(
                torch, lk, label, k4_args, [(k4_args[1], k4_args[2])])})
    if not k4_every_E(torch, lk, label, k4_args):
      raise SystemExit(f'K4 disagrees at an E on {label}')
    del k4_args
  else:
    k2 = r.calls['contact_select_lanes'][-1]
    log(f'{tag}: K2 features Fd {k2[3].shape[1]}, pair table '
        f'{tuple(k2[4].shape)}')
    if (k2[3].shape[1], k2[4].shape[1]) != (26, env0.model.nv):
      raise SystemExit(f'{tag}: K2 did not take the per-env parameters as '
                       'dynamic features')
    del k2
    cube_kernel_rows(torch, lk, r.calls, B, f'{name} DR training')
  del r.calls
  # auto-reset: env i keeps model i
  before = {f: mb.numeric[f].clone() for f in mb.batched}
  state = train_env.reset(torch.Generator(device=DEV).manual_seed(SEED))
  info = dict(state.info)
  half = torch.arange(B, device=DEV) < B // 2
  info['steps'] = torch.where(half, torch.full_like(info['steps'],
                                                    cfg.episode_length - 1),
                              info['steps'])
  nstate = train_env.step(state.replace(info=info),
                          torch.zeros((B, env0.action_size), device=DEV))
  restored = torch.equal(nstate.data.qpos[half],
                         state.info['first_data'].qpos[half])
  same = train_env.unwrapped.model is mb and all(
      torch.equal(mb.numeric[f], v) for f, v in before.items())
  log(f'{tag}: {int(half.sum().item())} envs at their time limit: done '
      f'{int((nstate.done > 0).sum().item())}, restarted from their first '
      f'state {restored}; every env kept its own model {same}')
  if not (restored and same and bool((nstate.done[half] > 0).all())):
    raise SystemExit(f'{tag}: auto-reset lost an env\'s model or state')
  return r.launches


# -- phase 10: the remaining Go2 tasks ----------------------------------------

GETUP_ENV, HANDSTAND_ENV = 'Go2Getup', 'Go2Handstand'
FOOTSTAND_ENV, ROUGH_ENV = 'Go2Footstand', 'Go2JoystickRoughTerrain'
# each task served: (env, trained policy or None for a seeded one, episode
# length of its config)
GO2_TASKS = (
    (GETUP_ENV, os.path.join(ROOT, 'logs', 'go2_getup_5M_r5',
                             'final_params.pkl'), 300),
    (HANDSTAND_ENV, os.path.join(ROOT, 'logs', 'go2_handstand_5M_r5',
                                 'final_params.pkl'), 500),
    (FOOTSTAND_ENV, None, 500),
    (ROUGH_ENV, GO2_PARAMS, 1000),
)
FULL_SCENE = (GETUP_ENV, HANDSTAND_ENV, FOOTSTAND_ENV)
# control steps of each task's rollout, 5 substeps each; cut from 25 to 15
# once phase 11 came and to 10 once phase 12 came, to keep the script
# within 12 minutes
TASK_STEPS = 10
GETUP_SETTLE = 125  # substeps of a getup reset: settle_time / sim_dt
# per substep K1 and K4 once; the reset's forward and its settle
GETUP_TRAIN_LAUNCHES = lambda S: {
    'spd_solve_lanes': S + 1 + GETUP_SETTLE, 'contact_select_lanes': 0,
    'newton_lanes_pyr_t': 0, '_newton_lanes_core': S + 1 + GETUP_SETTLE}


def task_policy(torch, port, name, params, device):
  """The deterministic policy serving task ``name``: the trained pickle
  ``params``, or (None) PPO networks at the Go2 widths (512-256-128, value
  on ``privileged_state``) initialised on the CPU from SEED with a fresh
  normalizer, carried as a ``final_params.pkl`` is: the repo holds no
  trained footstand policy, so the path is what is checked."""
  if params is not None:
    return load_policy(port, params, device, **GO2_KEYS)
  rs = _port_module('train.running_statistics')
  nf = port.configs.ppo_config(name).network_factory
  obs_size = {'state': (45,), 'privileged_state': (94,)}
  net = port.networks.make_ppo_networks(
      obs_size, 12,
      policy_hidden_layer_sizes=tuple(nf.policy_hidden_layer_sizes),
      value_hidden_layer_sizes=tuple(nf.value_hidden_layer_sizes),
      policy_obs_key='state', value_obs_key='privileged_state').init(
          torch.Generator().manual_seed(SEED))
  normalizer, params = port.networks.ppo_params_to_numpy(
      rs.init_state(obs_size, 'cpu'), net)
  return port.networks.make_policy(normalizer, params, device=device,
                                   **GO2_KEYS)


def handover(torch, port, env, data, device, dtype):
  """A getup State on ``device`` in ``dtype`` from a settled batch ``data``
  of the card: the reset's info and observation around the same data, no
  second settle (its float64 and CPU references start where the card's
  settle ended)."""
  d = data.map(lambda x: x.to(device, dtype) if x.is_floating_point()
               else x.to(device))
  B, nu = d.qpos.shape[0], env.model.nu
  z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=device)
  info = {'rng': torch.Generator(device=device).manual_seed(SEED),
          'last_act': z(nu), 'last_last_act': z(nu)}
  metrics = {f'reward/{k}': z() for k in env._config.reward_config.scales}
  return port.envs.State(d, env._get_obs(d, info), z(), z(), metrics, info)


def task_rollout(torch, lk, name, env0, env, policy, state, card):
  """TASK_STEPS control steps of a served Go2 task at B = GO2_ENVS: rates,
  launches (K1 and K4 once a substep), finite observations of the task's
  sizes; the share of envs upright at the end (getup: gravity within 0.01
  of straight down, the env's ``_is_upright``), the share terminated
  (every task), the guard's trips.  Returns (state, launches, ms per
  control step)."""
  B, n_sub = GO2_ENVS, env0.n_substeps
  zero_launches(lk)
  torch.cuda.synchronize()
  t = time.perf_counter()
  terminated = torch.zeros(B, dtype=torch.bool, device=DEV)
  rew_sum, nonfinite = torch.zeros((), device=DEV), torch.zeros((), device=DEV)
  for _ in range(TASK_STEPS):
    state = env.step(state, policy(state.obs))
    rew_sum += state.reward.sum()
    nonfinite += state.metrics['nonfinite'].sum()
    terminated |= (state.done > 0) & (state.info['truncation'] == 0)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t
  launches = dict(lk.LAUNCHES)
  substeps = TASK_STEPS * n_sub
  expect = {'spd_solve_lanes': substeps, 'contact_select_lanes': 0,
            'newton_lanes_pyr_t': 0, '_newton_lanes_core': substeps}
  if launches != expect:
    raise SystemExit(f'{name}: launch counts {launches} != {expect}')
  sizes = env0.observation_size
  check_finite(torch, (
      ('state', state.obs['state'], (B,) + sizes['state']),
      ('privileged_state', state.obs['privileged_state'],
       (B,) + sizes['privileged_state']),
      ('qpos', state.data.qpos, (B, env0.model.nq)),
      ('sensordata', state.data.sensordata, (B, env0.model.nsensordata)),
      ('reward', rew_sum, None)))
  extra = ''
  if name == GETUP_ENV:
    up = env0._is_upright(env0.get_gravity(state.data)).float().mean()
    extra = f'share upright at the end {up.item():.5f}; '
  log(f'go2 tasks: {name} B={B}, {TASK_STEPS} control steps = {substeps} '
      f'substeps in {wall:.3f} s: {B * TASK_STEPS / wall:.1f} env-steps/s, '
      f'{wall / substeps * 1e3:.3f} ms/substep; mean reward per step '
      f'{rew_sum.item() / (B * TASK_STEPS):.4f}; {extra}share terminated '
      f'{terminated.float().mean().item():.5f}; guard trips '
      f'{int(nonfinite.item())}; launches {launches}; card {card}')
  return state, launches, wall / TASK_STEPS * 1e3


def check_k4_full(torch, lk, tag, args):
  """K4 at nv 18, R0 366 (the full-collision scene) on its recorded inputs
  under k4_ratios' criteria: at 6 x 6 the full-schedule criterion
  (1e-6·φ(x0)), an env whose float64 solve is done after one Newton step
  held to 1e-5 (``one_step_done``); at the path's 1 x 5 the one-step tolerance with the
  first-order allowance (``first_order``); the number of envs each rule
  took printed.  Also at every E that fits, on the batch cut by 3 envs and
  on its first 5 envs (1 x 5); the shared memory of the E chosen; times
  by E and by schedule.  Returns K4's row."""
  nv, R0, B = args[6].shape
  scheds = [(args[1], args[2]), (6, 6)]
  done1, first = {}, {}
  err, ratios = k4_ratios(torch, lk, args, scheds, done1, first)
  seen = {}
  with force_E(lk, None, seen):
    lk._newton_lanes_core(*args)
  log(f'K4 {tag}: nv {nv}, R0 {R0}, B {B}; E {seen["chosen"]} of '
      f'{seen["fits"]}, {lk.newton_generic_smem_bytes(nv, R0, seen["chosen"])}'
      f' bytes of shared memory a block (limit {lk._SMEM_LIMIT}); envs whose '
      f'float64 solve is done after one Newton step (held to 1e-5 at 6 x 6): '
      f'{done1[6, 6]} of {B}; envs in which the kernel needed the '
      f'first-order allowance at {scheds[0][0]} x {scheds[0][1]}: '
      f'{first[scheds[0]]} of {B}')
  ok = kernel_ok(ratios)
  for what, envs in (('ragged', slice(None, -3)), ('first 5', slice(None, 5))):
    cut = cut_batch(torch, args, envs)
    cerr, cratios = k4_ratios(torch, lk, cut, scheds[:1], first_order={})
    log(f'K4 {tag} {what} (B {cut[6].shape[-1]}): max |kernel - plain| '
        f'{cerr:.3e}; {fmt_ratios(cratios)} '
        f'{"ok" if kernel_ok(cratios) else "FAIL"}')
    ok = ok and kernel_ok(cratios)
  ok = k4_every_E(torch, lk, tag, args, first_order={}) and ok
  run = lambda: lk._newton_lanes_core(*args)
  name = 'newton_generic_kernel'
  e_sweep(torch, lk, f'K4 {tag}', run, name)
  schedule_split(torch, f'K4 {tag}',
                 lambda it, ls: lk._newton_lanes_core(args[0], it, ls,
                                                      *args[3:]),
                 args[1], args[2], name)
  return dict(
      max_abs_err=err, profiler_ms=profiler_ms(torch, run, 50, name), ok=ok,
      ratios=fmt_ratios(ratios),
      work=kernel_work('_newton_lanes_core', args),
      ms=time_ms(torch, run, 50),
      plain_ms=time_ms(torch, lambda: lk.newton_generic_plain(*args), 5, 1),
      library_ms=None,
      note=f'nv {nv}, R0 {R0}, B {B}, schedule {scheds[0][0]} x '
           f'{scheds[0][1]}; per env: phi(xk) within 1e-5 phi(x0) plus '
           '1024u of the first-order change (1 Newton step), within 1e-6 '
           '(6 x 6; 1e-5 where float64 is done after one step) of the '
           'float64 solve; force and qfrc as k4_row',
  )


def go2_tasks_phase(torch, port, lk, card):
  """10: the remaining Go2 tasks.  Each of getup (``logs/go2_getup_5M_r5``),
  handstand (``logs/go2_handstand_5M_r5``), footstand (a seeded policy,
  task_policy) and the rough-terrain joystick (``logs/go2_joystick_50M_r5``)
  served through ``envs.load`` -> ``wrap_for_training`` at B = GO2_ENVS,
  deterministically: the reset timed (getup: a forward and 125 settle
  substeps, launches counted), the kernels of one control step against
  their plain versions (K4 at R0 366 on getup's inputs by check_k4_full,
  at every E on handstand's and footstand's; K1 on getup's and rough
  terrain's; K4 at R0 58 on rough terrain's), 256 envs against the CPU in
  fp32 and float64 for 3 control steps (getup from the first 256 envs of
  the served batch, settled on the card and handed over), TASK_STEPS
  control steps (task_rollout) and, for getup and rough terrain (handstand
  and footstand run getup's scene and stages), one more under the
  profiler.  Then one PPO step of getup at its table (8192
  envs) and the evaluator (go2_train_phase).  Returns (launches of all
  paths, launches of the full-scene paths, K1's row, K4's row at R0
  366)."""
  total, full = {}, {}
  add = lambda acc, l: acc.update({k: acc.get(k, 0) + v for k, v in l.items()})
  quiet = {'noise_config.level': 0.0}
  n = REF_ENVS
  rows, k1, k4 = {}, None, None
  for name, params, length in GO2_TASKS:
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    env0 = port.envs.load(name, device=DEV)
    env = port.wrappers.wrap_for_training(env0, episode_length=length,
                                          num_envs=GO2_ENVS)
    policy = task_policy(torch, port, name, params, DEV)
    zero_launches(lk)
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = env.reset(gen)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t
    settle = GETUP_SETTLE if name == GETUP_ENV else 0
    launches = dict(lk.LAUNCHES)
    expect = {'spd_solve_lanes': 1 + settle, 'contact_select_lanes': 0,
              'newton_lanes_pyr_t': 0, '_newton_lanes_core': 1 + settle}
    m = env0.model
    log(f'go2 tasks: {name} nq {m.nq}, nv {m.nv}, {m.ncon} contact slots, '
        f'nefc {_port_module("physics.constraint").layout_cached(m).nefc}; '
        f'reset of '
        f'{GO2_ENVS} envs {reset_s:.3f} s (a forward'
        + (f' and {settle} settle substeps' if settle else '')
        + f'); launches {launches}')
    if launches != expect:
      raise SystemExit(f'{name} reset: launch counts {launches} != {expect}')
    add(total, launches)
    if name in FULL_SCENE:
      add(full, launches)

    calls = record_calls(lk, lambda: env.step(state, policy(state.obs)),
                         keep=2)
    k4_args = calls['_newton_lanes_core'][-1]
    tag = f'{name}, B {GO2_ENVS}'
    if name == GETUP_ENV:
      k4 = check_k4_full(torch, lk, tag, k4_args)
      k1 = k1_row(torch, lk, tag, calls['spd_solve_lanes'][-2:])
      rows[f'K4 _newton_lanes_core ({tag})'] = k4
      rows[f'K1 spd_solve_lanes ({tag})'] = k1
    elif name == ROUGH_ENV:
      rows[f'K4 _newton_lanes_core ({tag})'] = k4_row(
          torch, lk, tag, k4_args, [(k4_args[1], k4_args[2])])
      rows[f'K1 spd_solve_lanes ({tag})'] = k1_row(
          torch, lk, tag, calls['spd_solve_lanes'][-2:])
      if not k4_every_E(torch, lk, tag, k4_args):
        raise SystemExit(f'{name}: K4 fails at some E')
    elif not k4_every_E(torch, lk, tag, k4_args, first_order={}):
      raise SystemExit(f'{name}: K4 fails at some E')
    del calls, k4_args
    report({k: v for k, v in rows.items() if 'bound_ms' not in v})

    pol_cpu = task_policy(torch, port, name, params, 'cpu')
    if name == GETUP_ENV:
      # the first n envs of the served batch, settled by its reset
      settled = state.data.map(lambda x: x[:n])

      def make_envs(device, dtype, name=name, settled=settled):
        e = port.envs.load(name, device=device, dtype=dtype,
                           config_overrides=quiet)
        return e, handover(torch, port, e, settled, device, dtype)
    else:
      init = env0.sample_init(gen, n)

      def make_envs(device, dtype, name=name, init=init):
        e = port.envs.load(name, device=device, dtype=dtype,
                           config_overrides=quiet)
        g = torch.Generator(device=device).manual_seed(SEED)
        return e, e.reset_to({k: v.to(device) for k, v in init.items()}, g)

    reference(torch, name, make_envs, policy, pol_cpu,
              lambda s: s.obs['privileged_state'], lambda s: s.obs['state'])
    state, launches, step_ms = task_rollout(torch, lk, name, env0, env,
                                            policy, state, card)
    add(total, launches)
    if name in FULL_SCENE:
      add(full, launches)
    if name in (GETUP_ENV, ROUGH_ENV):  # handstand, footstand: getup's scene
      profile_control_step(torch, f'go2_{name[3:].lower()}', env, policy,
                           state, step_ms, first='narrowphase_leaves')
    del env0, env, policy, state

  launches, _ = go2_train_phase(
      torch, port, lk, card, name=GETUP_ENV, tag='getup train',
      expect=GETUP_TRAIN_LAUNCHES,
      k4_check=lambda t, a: check_k4_full(torch, lk, t, a))
  add(total, launches)
  add(full, launches)
  return total, full, k1, k4



# -- phase 11: the evaluation CLIs, a group of one
# control steps of each evaluation (full: 1200, 500); cut from 25 to 10
# once phase 12 came, to keep the script within 12 minutes
EVAL_CLI_STEPS = 10
GETUP_PARAMS = os.path.join(ROOT, 'logs', 'go2_getup_5M_r5',
                            'final_params.pkl')
CUBE_PATH = ('spd_solve_lanes', 'contact_select_lanes', 'newton_lanes_pyr_t')
GO2_PATH = ('spd_solve_lanes', '_newton_lanes_core')
# the training runs of the group of one: PPO's 2 unrolls of 2 control steps
# and one minibatch update, SAC's prefill of one actor step and one
# training step, both at 256 envs with the normalizer on
WORLD1_ENVS = 256
WORLD1_PPO = dict(num_timesteps=WORLD1_ENVS * 2 * 2, num_envs=WORLD1_ENVS,
                  batch_size=WORLD1_ENVS, num_minibatches=2, unroll_length=2,
                  num_updates_per_batch=1, num_evals=0)
WORLD1_SAC = dict(num_timesteps=2 * WORLD1_ENVS, num_envs=WORLD1_ENVS,
                  batch_size=WORLD1_ENVS, min_replay_size=WORLD1_ENVS,
                  max_replay_size=16 * WORLD1_ENVS, grad_updates_per_step=1,
                  num_evals=0)


def import_cli(port):
  """Add the evaluation CLIs and the trainers' process-group helpers to
  ``port`` (phase 11)."""
  mod = _port_module
  port.distributed = mod('train.distributed')
  port.eval_policy, port.eval_go2 = (mod('train.eval_policy'),
                                     mod('train.eval_go2'))
  port.sac, port.sac_networks = mod('train.sac'), mod('train.sac_networks')


def path_launches(lk, tag, kernels):
  """The launch counts since zero_launches; fail unless exactly the path's
  ``kernels`` were launched."""
  launches = dict(lk.LAUNCHES)
  if any((n > 0) != (name in kernels) for name, n in launches.items()):
    raise SystemExit(f'{tag}: launches {launches}, expected {kernels} only')
  return launches


def cli_phase(torch, lk, port, card):
  """Phase 11 (a): ``eval_policy.main`` on the cube-push checkpoint and
  ``eval_go2.main`` on getup, 128 episodes x EVAL_CLI_STEPS control steps
  each, their summaries finite.  Each run's launches counted from zero.
  Returns (eval_policy's launches, getup's: K1 and K4 at the full scene's
  R0 366)."""

  def add(tag, kernels, t):
    launches = path_launches(lk, tag, kernels)
    log(f'{tag}: {time.perf_counter() - t:.1f} s; launches {launches}; '
        f'card {card}')
    return launches

  zero_launches(lk)
  t = time.perf_counter()
  s = port.eval_policy.main([PARAMS, '--episodes', str(EVAL_ENVS),
                             '--episode_length', str(EVAL_CLI_STEPS),
                             '--device', DEV])
  main = add(f'eval_policy {ENV} {EVAL_ENVS} x {EVAL_CLI_STEPS}', CUBE_PATH,
             t)
  check_finite(torch, [(k, torch.as_tensor(s[k]), (EVAL_ENVS,))
                       for k in ('ep_rew', 'min_dist')])
  zero_launches(lk)
  t = time.perf_counter()
  s = port.eval_go2.main([GETUP_PARAMS, '--env', GETUP_ENV, '--episodes',
                          str(EVAL_ENVS), '--episode_length',
                          str(EVAL_CLI_STEPS), '--device', DEV])
  getup = add(f'eval_go2 {GETUP_ENV} {EVAL_ENVS} x {EVAL_CLI_STEPS}',
              GO2_PATH, t)
  check_finite(torch, [('ep_rew', torch.as_tensor(s['ep_rew']),
                        (EVAL_ENVS,)),
                       ('uprightness', torch.as_tensor(s['m_lin']), ())])
  if not s['finite']:
    raise SystemExit('eval_go2: rewards not finite')
  return main, getup


def world1_train(torch, port, algo, group):
  """One PPO or SAC run of WORLD1_* on cube-push at SEED, in an NCCL group
  of one (``group``) or with none; returns every tensor of the trained
  networks and normalizer, on the CPU."""
  import functools
  import socket

  cfg = port.configs.ppo_config(ENV) if algo == 'ppo' else (
      port.configs.sac_config(ENV))
  nf = {k: tuple(v) if isinstance(v, list) else v
        for k, v in cfg.pop('network_factory').items()}
  cfg.pop('policy_obs_key', None)
  cfg.update(WORLD1_PPO if algo == 'ppo' else WORLD1_SAC)
  make = port.networks.make_ppo_networks if algo == 'ppo' else (
      port.sac_networks.make_sac_networks)
  train = port.ppo.train if algo == 'ppo' else port.sac.train
  if group:
    with socket.socket() as sock:
      sock.bind(('localhost', 0))
      addr = f'tcp://localhost:{sock.getsockname()[1]}'
    device = port.distributed.init(DEV, init_method=addr, rank=0,
                                   world_size=1)
    expect = 'cuda:0' if DEV == 'cuda' else DEV
    if port.distributed.world() != (0, 1) or device != expect:
      raise SystemExit(f'group of one: {port.distributed.world()}, {device}')
  try:
    _, (norm, net), metrics = train(
        environment=port.envs.load(ENV, device=DEV),
        network_factory=functools.partial(make, **nf), seed=SEED,
        device=DEV, **cfg)
  finally:
    if group:
      port.distributed.finish()
  out = {k: v.detach().cpu() for k, v in net.state_dict().items()}
  out.update({f'normalizer.{k}': getattr(norm, k).cpu()
              for k in ('count', 'mean', 'summed_variance', 'std')})
  return out, metrics


def world1_phase(torch, lk, port, card):
  """Phase 11 (b): one PPO and one SAC run (WORLD1_*) with no process
  group, then the same in an NCCL group of one started here (TCPStore on
  localhost), which sends every gradient, the normalizer's sums and the
  metrics through all-reduces and each env's draws through a
  ``RowStream``: the parameters and the normalizer must be the same bits.
  Groups of more than one run only in the gloo tests on the CPU
  (tests/test_torch_distributed.py).  Returns the group runs' launches."""
  total = {}
  for algo in ('ppo', 'sac'):
    t = time.perf_counter()
    plain, _ = world1_train(torch, port, algo, group=False)
    zero_launches(lk)
    grouped, metrics = world1_train(torch, port, algo, group=True)
    launches = path_launches(lk, f'group of one, {algo}', CUBE_PATH)
    for k, v in launches.items():
      total[k] = total.get(k, 0) + v
    differ = [k for k in plain if not torch.equal(plain[k], grouped[k])]
    log(f'group of one, {algo} on {ENV} at {WORLD1_ENVS} envs: '
        f'{len(plain)} tensors, {len(differ)} differ from no group '
        f'{differ[:4]}; loss metrics '
        + ', '.join(f'{k.split("/")[-1]} {v:.6g}' for k, v in metrics.items()
                    if k.endswith('loss'))
        + f'; {time.perf_counter() - t:.1f} s; launches {launches}; '
        f'card {card}')
    if differ:
      raise SystemExit(f'group of one, {algo}: not the bits of no group')
  return total


# -- phase 12: deployment, the render rollouts, the scaling sweep -----------
# the observations served through PolicyInference: DEPLOY_ROWS rows of the
# demo's four observation files (real_obs.txt alone holds 51)
DEPLOY_OBS = ('real_obs.txt', 'obs.txt', 'current_sim_obs.txt',
              'past_sim_obs.txt')
DEPLOY_ROWS = 200
DEPLOY_TOL = 1e-5  # card against CPU, raw actions, TF32 off
CUBE_LOOP_STEPS, TPUSH_LOOP_STEPS = 50, 20  # control-loop steps
# control steps of each B 1 render rollout; cut from 25 to 15 to keep
# phase 12 under a minute on an H100
RENDER_STEPS = 15
# the scaling sweep at one device, envs_per_device 1024: a warm-up
# rollout of 5 control steps and 2 timed (full length 50 x 3)
SCALING_CUT = ['--device_counts', '1', '--steps', '5', '--reps', '2']


def import_deploy(port):
  """Add deployment, rendering, the scaling sweep and the checkpoint
  writer to ``port`` (phase 12)."""
  mod = _port_module
  port.deploy, port.rendering = mod('deploy'), mod('utils.rendering')
  port.interface, port.t_push = mod('deploy.interface'), mod('deploy.t_push')
  port.control_loop = mod('deploy.control_loop')
  port.bench_scaling = mod('bench_scaling')
  port.checkpoint = mod('train.checkpoint')


def deploy_obs():
  import numpy as np

  rows = np.concatenate([
      np.loadtxt(os.path.join(RSR_DATA, f), delimiter=',', ndmin=2)
      for f in DEPLOY_OBS])
  return rows[:DEPLOY_ROWS]


def stub_arms(port):
  """Stub robots for the control loops (after tests/test_deploy.py): joints
  reach each command at once, ``sleep`` does nothing; the cube marker moves
  30 % of the way to the target per command, the T turns 30 % of the way
  to the target's bearing per command."""
  import numpy as np

  class CubeArm(port.interface.RobotInterface):

    def __init__(self, marker, target):
      self.joints, self.commands = np.zeros(6), []
      self.marker = np.asarray(marker, dtype=float)
      self.target = np.asarray(target[:2])
      self.steps_completed = []

    def get_joint_positions(self):
      return self.joints.copy()

    def get_end_pose(self):
      return np.array([0.3, 0.0, 0.05])

    def get_marker_position(self):
      return self.marker.copy()

    def send_joint_position_cmd(self, joint_positions):
      self.commands.append(np.asarray(joint_positions).copy())
      self.joints = np.asarray(joint_positions).copy()
      self.marker += 0.3 * (self.target - self.marker)

    def publish_step_complete(self, step):
      self.steps_completed.append(step)

    def sleep(self, seconds):
      pass

  class TArm(port.t_push.TRobotInterface, CubeArm):

    def __init__(self, angle):
      CubeArm.__init__(self, [0.0, 0.0], [0.0, 0.0])
      self.angle = angle
      self.point1 = np.array([0.30, 0.10])
      d = (port.t_push.T_TARGET_VERT - port.t_push.T_TARGET_BASE)[:2]
      self.length, self.bearing = np.linalg.norm(d), np.arctan2(d[1], d[0])

    def get_t_points(self):
      a = self.bearing + self.angle
      p0 = self.point1 + self.length * np.array([np.cos(a), np.sin(a)])
      u = (p0 - self.point1) / np.linalg.norm(p0 - self.point1)
      return p0, self.point1.copy(), p0 + 0.025 * u

    def send_joint_position_cmd(self, joint_positions):
      self.commands.append(np.asarray(joint_positions).copy())
      self.joints = np.asarray(joint_positions).copy()
      self.angle *= 0.7

  return CubeArm, TArm


def loop_checks(port, tag, robot, steps, max_steps) -> None:
  """The loop ran its steps and sent commands; each command holds joint 4
  at 1.57, couples joint 5 as -(1.57 + q2 + q3) (clipped) and lies within
  the joint limits."""
  import numpy as np

  lo, hi = port.control_loop.JOINT_LOWER, port.control_loop.JOINT_UPPER
  bad = [i for i, c in enumerate(robot.commands)
         if c[3] != 1.57 or abs(c[4] - np.clip(-(1.57 + c[1] + c[2]), lo[4],
                                               hi[4])) > 1e-9
         or np.any(c < lo) or np.any(c > hi)]
  log(f'{tag}: {steps} of {max_steps} steps, {len(robot.commands)} '
      f'commands; first {np.round(robot.commands[0], 4).tolist() if robot.commands else None}'
      f'; {len(bad)} break the couplings or limits')
  if steps != max_steps or not robot.commands or bad:
    raise SystemExit(f'{tag}: control loop failed')


def deploy_phase(torch, port, card):
  """Phase 12 (a): PolicyInference on the card against the CPU, the
  control loops.  (a) The PPO and the SAC ``final_params.pkl`` served on
  the card and on the CPU at action_scale 1 (get_action then returns the
  raw action), DEPLOY_ROWS observations each: the raw actions within
  DEPLOY_TOL, the card's action log one row per call, a stochastic action
  finite; the warm latency of one get_action call on the card, median and
  p99 over the rows.  (b) ``run_cube_push_control_loop`` for
  CUBE_LOOP_STEPS steps with the PPO policy on the card and
  ``run_t_push_control_loop`` for TPUSH_LOOP_STEPS with the T-push phase's
  seeded policy, written with ``checkpoint.save_params`` and read back
  through PolicyInference, each against a stub arm (loop_checks)."""
  import tempfile

  import numpy as np

  PolicyInference = port.deploy.PolicyInference
  obs = deploy_obs()
  cube_env = port.envs.load(ENV, device='cpu')
  with tempfile.TemporaryDirectory() as tmp:
    for algo, params in (('ppo', PARAMS), ('sac', SAC_PARAMS)):
      log_path = os.path.join(tmp, f'{algo}_actions.txt')
      served = {dev: PolicyInference(
          params, cube_env, algorithm=algo, action_scale=1.0, device=dev,
          action_log_path=log_path if dev == DEV else None)
                for dev in (DEV, 'cpu')}
      acts = {dev: np.stack([p.get_action(o) for o in obs])
              for dev, p in served.items()}
      err = float(np.abs(acts[DEV] - acts['cpu']).max())
      logged = np.loadtxt(log_path, delimiter=',', ndmin=2)
      sample = served[DEV].get_action(obs[0], deterministic=False)
      times = []
      for o in obs:
        t = time.perf_counter()
        served[DEV].get_action(o)
        times.append((time.perf_counter() - t) * 1e3)
      med, p99 = np.percentile(times, [50, 99])
      ok = (err <= DEPLOY_TOL and len(logged) == len(obs)
            and np.isfinite(acts[DEV]).all() and np.isfinite(sample).all())
      log(f'deploy {algo}: PolicyInference on {len(obs)} observations, raw '
          f'actions {acts[DEV].shape}, max |card - CPU| {err:.3g} (tol '
          f'{DEPLOY_TOL}); action log {len(logged)} rows; get_action on '
          f'the card, warm: median {med:.4f} ms, p99 {p99:.4f} ms; '
          f'{"ok" if ok else "FAIL"}; card {card}')
      if not ok:
        raise SystemExit(f'deploy {algo}: PolicyInference check failed')

    CubeArm, TArm = stub_arms(port)
    quiet = lambda *_: None
    robot = CubeArm([0.30, 0.0], port.interface.DEFAULT_TARGET_POS)
    policy = PolicyInference(PARAMS, cube_env, device=DEV,
                             action_log_path=os.path.join(tmp, 'a.txt'))
    t = time.perf_counter()
    steps = port.control_loop.run_cube_push_control_loop(
        robot, policy, max_steps=CUBE_LOOP_STEPS, joint_timeout=0.1,
        obs_log_path=os.path.join(tmp, 'o.txt'), logger=quiet)
    loop_checks(port, f'cube-push control loop ({time.perf_counter() - t:.2f}'
                ' s)', robot, steps, CUBE_LOOP_STEPS)
    path = os.path.join(tmp, 'final_params.pkl')
    port.checkpoint.save_params(path, tpush_params(torch, port))
    robot = TArm(0.5)
    policy = PolicyInference(path, port.envs.load(TPUSH_ENV, device='cpu'),
                             device=DEV, action_log_path=None)
    t = time.perf_counter()
    steps = port.t_push.run_t_push_control_loop(
        robot, policy, max_steps=TPUSH_LOOP_STEPS, joint_timeout=0.1,
        obs_log_path=None, logger=quiet)
    loop_checks(port, f'T-push control loop ({time.perf_counter() - t:.2f} '
                's)', robot, steps, TPUSH_LOOP_STEPS)


def same_bits(eager_q, q, tag) -> None:
  """Fail unless a rollout's qpos on the main path (physics replayed from
  CUDA graphs) equals its eager rollout's bit for bit."""
  import numpy as np

  same = eager_q.shape == q.shape and np.array_equal(eager_q, q)
  log(f'{tag}: qpos equal to the eager rollout bit for bit: {same}')
  if not same:
    raise SystemExit(f'{tag}: the replayed rollout differs from the eager')


def expect_launches(launches, expect) -> None:
  got = {k: v for k, v in launches.items() if v}
  if got != expect:
    raise SystemExit(f'launch counts {got} != expected {expect}')


# a B 1 rollout has parted from float64 once the CPU's fp32 qpos is this
# far from it: phase 3 counts such envs ("over 1e-3")
PARTED = 1e-3


def render_rollout_checks(torch, tag, q_g, q_c, q_d) -> None:
  """Phase 3's elementwise criterion on a B 1 rollout's qpos, at every
  control step before the rollout parts from float64 (the CPU fp32 path's
  gap to it still under PARTED), at least phase 3's 3 steps: the card
  within 1e-2 (+1e-2 relative) of the CPU; finite throughout.  Phase 3's
  other criterion, the median over 256 envs of the card's gap to float64
  within 10x the CPU fp32 path's, needs a batch: one env in a sensitive
  contact state sits on either side of it by chance (the cube-push start
  here, on an H100: after one control step 1.8e-5 on the card, 9e-7 on
  the CPU, where the kernels at B 1 reach the plain versions' objective;
  x differs along the solve's flat directions), and some starts are
  chaotic in fp32
  in any summation order (ROADMAP section 3).  Both gaps to float64 are
  printed at every step."""
  import numpy as np

  gap_g = np.abs(q_g - q_d).max(axis=1)[1:]
  gap_c = np.abs(q_c - q_d).max(axis=1)[1:]
  parted = np.nonzero(gap_c > PARTED)[0]
  n = int(parted[0]) if len(parted) else len(gap_c)
  close = np.abs(q_g - q_c) <= 1e-2 + 1e-2 * np.abs(q_c)
  ok = n >= 3 and bool(close[1:n + 1].all()) and bool(
      np.isfinite(q_g).all())
  fmt = lambda x: ' '.join(f'{v:.3g}' for v in x)
  log(f'{tag}: qpos gap to float64 by control step, card [{fmt(gap_g)}]; '
      f'CPU fp32 [{fmt(gap_c)}]; card-CPU over the {n} steps before the '
      f'CPU parts (> {PARTED}) max {np.abs(q_g - q_c)[1:n + 1].max():.3g} '
      f'{"ok" if ok else "FAIL"}')
  if not ok:
    raise SystemExit(f'{tag}: the card disagrees with the CPU reference')


def render_phase(torch, port, lk, card):
  """Phase 12 (b): the rollouts behind ``--render`` and ``--video``, one
  env (B 1), RENDER_STEPS control steps, on the card: cube-push
  (``rendering.rollout_qpos``, the PPO policy; K1, K2, K3) and the Go2
  joystick (``eval_go2.video_rollout``: qpos, command and heading each
  step; K1, K4).  Each against the same rollout on the CPU in fp32 and in
  float64 (render_rollout_checks; the draws come from one CPU generator on
  every device, so the rollouts start and draw alike) over the steps
  before the CPU's own fp32 rollout parts from float64; the joystick's
  commands equal.  Each rollout on the card runs twice: eagerly, with
  the kernels' inputs recorded (those of its last substep at B 1, under
  phase 2's criteria), then timed on the main path, its physics replayed
  from CUDA graphs, with its qpos equal to the eager one bit for bit.
  Rasterisation is not run: the card machine has no mujoco.  Returns
  (rows, launches by row name)."""
  import numpy as np

  f32 = lambda obs: ({k: v.float() for k, v in obs.items()}
                     if isinstance(obs, dict) else obs.float())
  as_policy = lambda act: (lambda obs, g: (act(f32(obs)), {}))
  rows, launches = {}, {}
  pol = {d: load_policy(port, PARAMS, d) for d in (DEV, 'cpu')}
  q = {}
  for dev, dtype in ((DEV, torch.float32), ('cpu', torch.float32),
                     ('cpu', torch.float64)):
    env0 = port.envs.load(ENV, device=dev, dtype=dtype)
    run = lambda: q.__setitem__((dev, dtype), port.rendering.rollout_qpos(
        env0, as_policy(pol[dev]), RENDER_STEPS, SEED, dev))
    if dev != DEV:
      run()
      continue
    calls = record_calls(lk, run, keep=2)
    eager_q = q[dev, dtype]
    zero_launches(lk)
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    wall = time.perf_counter() - t
    same_bits(eager_q, q[dev, dtype], 'render cube-push')
    cube = path_launches(lk, 'render cube-push', CUBE_PATH)
    # each substep launches K1 twice, K2 and K3 once; the reset's forward
    # each once
    S = RENDER_STEPS * env0.n_substeps
    expect_launches(cube, {'spd_solve_lanes': 2 * S + 1,
                           'contact_select_lanes': S + 1,
                           'newton_lanes_pyr_t': S + 1})
    log(f'render cube-push: {ENV} B 1, {RENDER_STEPS} control steps on the '
        f'main path (its captures included) in '
        f'{wall:.3f} s: {wall / RENDER_STEPS * 1e3:.3f} ms a control step; '
        f'launches {cube}; card {card}')
  render_rollout_checks(torch, 'render cube-push', q[DEV, torch.float32],
                        q['cpu', torch.float32], q['cpu', torch.float64])
  name = 'spd_solve_lanes [B 1, cube-push n 20]'
  rows[name] = k1_row(torch, lk, 'cube-push B 1',
                      calls['spd_solve_lanes'][-2:])
  launches[name] = cube['spd_solve_lanes']
  name = 'contact_select_lanes [B 1]'
  rows[name] = k2_row(torch, lk, calls['contact_select_lanes'][-1],
                      tag='cube-push B 1')
  launches[name] = cube['contact_select_lanes']
  name = 'newton_lanes_pyr_t [B 1]'
  rows[name] = k3_row(torch, lk, 'cube-push B 1',
                      calls['newton_lanes_pyr_t'][-1])
  launches[name] = cube['newton_lanes_pyr_t']
  del calls

  pol = {d: load_policy(port, GO2_PARAMS, d, **GO2_KEYS)
         for d in (DEV, 'cpu')}
  rec = {}
  for dev, dtype in ((DEV, torch.float32), ('cpu', torch.float32),
                     ('cpu', torch.float64)):
    env0 = port.envs.load(GO2_ENV, device=dev, dtype=dtype)
    act = pol[dev]
    run = lambda: rec.__setitem__((dev, dtype), port.eval_go2.video_rollout(
        env0, lambda obs: act(f32(obs)), RENDER_STEPS, SEED, dev, True))
    if dev != DEV:
      run()
      continue
    calls = record_calls(lk, run, keep=1)
    eager_q = rec[dev, dtype][0]
    zero_launches(lk)
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    wall = time.perf_counter() - t
    same_bits(eager_q, rec[dev, dtype][0], 'render Go2')
    go2 = path_launches(lk, 'render Go2', GO2_PATH)
    S = RENDER_STEPS * env0.n_substeps
    expect_launches(go2, {'spd_solve_lanes': S + 1,
                          '_newton_lanes_core': S + 1})
    log(f'render Go2: {GO2_ENV} B 1, {RENDER_STEPS} control steps on the '
        f'main path (its captures included) in '
        f'{wall:.3f} s: {wall / RENDER_STEPS * 1e3:.3f} ms a control step; '
        f'launches {go2}; card {card}')
  (q_g, c_g, y_g), (q_c, c_c, y_c), (q_d, c_d, _) = (
      rec[DEV, torch.float32], rec['cpu', torch.float32],
      rec['cpu', torch.float64])
  render_rollout_checks(torch, 'render Go2', q_g, q_c, q_d)
  same_cmds = c_g.shape == (RENDER_STEPS, 3) and np.allclose(
      c_g, c_c, rtol=0, atol=1e-6) and np.allclose(c_g, c_d, atol=1e-6)
  log(f'render Go2: commands {c_g.shape}, card = CPU: {same_cmds}; heading '
      f'first {y_g[0]:.4f} last {y_g[-1]:.4f} (CPU {y_c[-1]:.4f})')
  if not same_cmds:
    raise SystemExit('render Go2: the commands differ between devices')
  name = 'spd_solve_lanes [B 1, Go2 n 18]'
  rows[name] = k1_row(torch, lk, 'Go2 B 1', calls['spd_solve_lanes'][-1:])
  launches[name] = go2['spd_solve_lanes']
  args = calls['_newton_lanes_core'][-1]
  name = '_newton_lanes_core [B 1, Go2 R0 58]'
  rows[name] = k4_row(torch, lk, 'Go2 B 1', args,
                      [(args[1], args[2]), (6, 6)])
  launches[name] = go2['_newton_lanes_core']
  report(rows)
  return rows, launches


def scaling_phase(torch, lk, port, card):
  """Phase 12 (c): ``bench_scaling.main`` at one device, 1024 envs
  (SCALING_CUT): its JSON line, a finite rate above 0.  Returns its
  launches."""
  zero_launches(lk)
  t = time.perf_counter()
  lines = port.bench_scaling.main(SCALING_CUT + ['--device', DEV])
  launches = path_launches(lk, 'bench_scaling', CUBE_PATH)
  ok = len(lines) == 1 and math.isfinite(lines[0]['value']) and (
      lines[0]['value'] > 0)
  log(f'bench_scaling: {lines}; {time.perf_counter() - t:.1f} s; launches '
      f'{launches}; card {card} {"ok" if ok else "FAIL"}')
  if not ok:
    raise SystemExit('bench_scaling: no finite rate')
  return launches


def wrapper_times(torch, port, card) -> None:
  """The mode ``--wrapper-times [DIR]``: K1 at both paths' shapes and K2,
  through ``spd_solve_lanes`` and ``contact_select_lanes`` of the port
  found under DIR, on the inputs of one control step of each path: CUDA-event
  time, device time by kernel name, bound.  It uses only what every version
  of the port has (the entry points and the two public wrappers), so that
  the parent commit's kernels and this tree's can be timed in one call on
  one card:

      mkdir -p parent_tree && git archive HEAD | tar -x -C parent_tree
      python3 chip_smoke.py --wrapper-times parent_tree   # parent
      python3 chip_smoke.py --wrapper-times               # change
      python3 chip_smoke.py --wrapper-times               # change
      python3 chip_smoke.py --wrapper-times parent_tree   # parent
  """
  lk = port.lk
  where = os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(lk.__file__))))
  log(f'wrapper times of the port under {where}; card {card}')
  port.cuda_build.build_all()
  gen = torch.Generator(device=DEV).manual_seed(SEED)

  def line(tag, fn, kernel_name, work):
    bound = least_ms(*work)[0]
    events = time_ms(torch, fn, 50)
    device = profiler_ms(torch, fn, 50, kernel_name)
    log(f'{tag}: kernel_ms {events:.5f} (profiler {device:.5f}) bound_ms '
        f'{bound:.5f}, {device / bound:.1f} x bound')

  for tag, path in (
      ('cube-push', (ENV, PARAMS, ENVS, 1200)),
      ('Go2', (GO2_ENV, GO2_PARAMS, GO2_ENVS, 1000))):
    kw = GO2_KEYS if tag == 'Go2' else {}
    _, env, policy, state = load_path(torch, port, *path, gen, **kw)
    calls = record_calls(lk, lambda: env.step(state, policy(state.obs)))
    At, bt = calls['spd_solve_lanes'][-1][:2]
    line(f'K1 {tag}, n {bt.shape[0]}, B {bt.shape[1]}',
         lambda: lk.spd_solve_lanes(At, bt), 'spd_solve_',
         kernel_work('spd_solve_lanes', (At, bt)))
    for a in calls['contact_select_lanes'][-1:]:
      line(f'K2 {tag}, {a[2].shape[0]} -> {a[1]} slots, B {a[2].shape[1]}',
           lambda: lk.contact_select_lanes(*a), 'contact_select_kernel',
           kernel_work('contact_select_lanes', a))
    del calls, env, policy, state


def _port_module(name):
  import importlib

  return importlib.import_module('rsr_mjx_tpu_torch.' + name)


def import_port(root=None):
  """The port's modules that every version of it has (``--wrapper-times``
  imports another commit's), from the checkout at ``root``: this file's
  own directory (the default) or a directory below it."""
  import types

  if root is not None:
    root, here = os.path.realpath(root), os.path.realpath(ROOT)
    if os.path.commonpath([root, here]) != here:
      raise SystemExit(f'chip_smoke: {root} lies outside {here}')
    sys.path.insert(0, root)
  mod = _port_module
  return types.SimpleNamespace(
      envs=mod('envs'), wrappers=mod('envs.wrappers'),
      cuda_build=mod('physics.cuda_build'), fwd_fused=mod('physics.fwd_fused'),
      lk=mod('physics.linalg_kernels'), networks=mod('train.networks'))


def import_train(port):
  """Add the trainer's and RSR's modules to ``port`` (phases 4 to 6)."""
  mod = _port_module
  port.ppo, port.acting = mod('train.ppo'), mod('train.acting')
  port.configs, port.rs = mod('train.configs'), mod('train.running_statistics')
  port.rsr, port.rsr_pipeline = mod('rsr'), mod('rsr.pipeline')
  port.rsr_datasets = mod('rsr.datasets')


def main() -> int:

  import torch

  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; the port has no CPU path here',
          file=sys.stderr)
    return 1
  argv = sys.argv[1:]
  other = None  # --wrapper-times DIR: the port of another checkout
  if '--wrapper-times' in argv:
    rest = argv[argv.index('--wrapper-times') + 1:]
    other = rest[0] if rest and not rest[0].startswith('--') else None
  try:
    port = import_port(other)
  except ImportError as e:
    print(f'chip_smoke: run from the repository root ({e})', file=sys.stderr)
    return 1
  envs, cuda_build, fwd_fused, lk = (port.envs, port.cuda_build,
                                     port.fwd_fused, port.lk)
  if '--wrapper-times' in argv:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    wrapper_times(torch, port, card_line())
    return 0

  # -- 1. device
  card = card_line()
  log('card:', card, '| torch', torch.__version__, 'cuda', torch.version.cuda)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  t = time.perf_counter()
  build_log = cuda_build.build_all(verbose=True)
  log(f'build: {len(build_log)} kernels in {time.perf_counter() - t:.1f} s')
  for name, out in build_log.items():
    for line in out.splitlines():
      if 'registers' in line or 'error' in line.lower():
        log(f'  {name}: {line.strip()}')
  torch.set_grad_enabled(False)

  t_phase = [time.perf_counter()]

  def phase_done(n):
    now = time.perf_counter()
    log(f'phase {n}: {now - t_phase[0]:.1f} s')
    t_phase[0] = now

  # -- 2. kernels, on the inputs of one control step of each path
  gen = torch.Generator(device=DEV).manual_seed(SEED)
  env0, env, policy, state = load_path(torch, port, ENV, PARAMS, ENVS, 1200,
                                       gen)
  calls = record_calls(lk, lambda: env.step(state, policy(state.obs)))
  rows = check_kernels(torch, lk, calls)
  check_runtime_widths(torch, lk)
  check_k1_widths(torch, lk)
  check_k2_sizes(torch, lk)
  # one cube-push state through both assemblies: the basis (K3) and the
  # same selected contacts as generic rows (K4)
  m, d0 = env0.model, state.data
  cube_k3 = record_calls(lk, lambda: fwd_fused.forward_lanes(
      m, d0, implicit=True))['newton_lanes_pyr_t'][-1]
  cube_k4 = record_calls(lk, lambda: fwd_fused.forward_lanes(
      m, d0, implicit=True, basis=False))['_newton_lanes_core'][-1]
  # from a cold start: d0.qacc is already this state's solution, from which
  # no step is accepted
  cold = torch.zeros_like(cube_k4[5])
  cube_k4 = (cube_k4[0], 6, 6) + tuple(cube_k4[3:5]) + (cold,) + tuple(
      cube_k4[6:])
  cube_k3 = tuple(cube_k3[:5]) + (cold,) + tuple(cube_k3[6:])
  del calls

  g_env0, g_env, g_policy, g_state = load_path(
      torch, port, GO2_ENV, GO2_PARAMS, GO2_ENVS, 1000, gen, **GO2_KEYS)
  calls = record_calls(lk, lambda: g_env.step(g_state, g_policy(g_state.obs)))
  n_sub = g_env0.n_substeps
  if (len(calls['_newton_lanes_core']), len(calls['spd_solve_lanes'])) != (
      n_sub, n_sub):
    raise SystemExit('a Go2 control step must call K4 and K1 once a substep')
  rows['_newton_lanes_core'] = check_k4(
      torch, lk, calls['_newton_lanes_core'][-1], cube_k4, cube_k3)
  rows['K1 at nv 18 (Go2)'] = k1_row(torch, lk, 'Go2',
                                     calls['spd_solve_lanes'][-2:])
  del calls, cube_k3, cube_k4
  report(rows)
  if '--kernels-only' in argv:
    log('kernels-only: stopped after phase 2 (no result line)')
    return 0

  phase_done(2)

  # -- 3. the two paths: reference, rollout, profile
  n = REF_ENVS

  def cube_envs(device, dtype):
    e = env0 if device == DEV else envs.load(ENV, device=device,
                                                dtype=dtype)
    return e, e.reset_to(*(x[:n].to(device, dtype)
                           for x in (d0.qpos, d0.qvel, d0.ctrl)))

  reference(torch, 'cube-push', cube_envs, policy,
            load_policy(port, PARAMS, 'cpu'), lambda s: s.obs)
  state, launches, step_ms = rollout_cube(torch, lk, env0, env, policy,
                                          state, card)
  profile_control_step(torch, 'cube', env, policy, state, step_ms)

  quiet = {'noise_config.level': 0.0}
  g_init = g_env0.sample_init(gen, n)

  def go2_envs(device, dtype):
    e = envs.load(GO2_ENV, device=device, dtype=dtype, config_overrides=quiet)
    g = torch.Generator(device=device).manual_seed(SEED)
    return e, e.reset_to({k: v.to(device) for k, v in g_init.items()}, g)

  reference(torch, 'Go2', go2_envs, g_policy,
            load_policy(port, GO2_PARAMS, 'cpu', **GO2_KEYS),
            lambda s: s.obs['privileged_state'], lambda s: s.obs['state'])
  g_state, g_launches, g_step_ms = rollout_go2(torch, lk, g_env0, g_env,
                                               g_policy, g_state, card)
  profile_control_step(torch, 'go2', g_env, g_policy, g_state, g_step_ms)
  del g_env0, g_env, g_policy, g_state

  phase_done(3)

  # -- 4. training
  t_launches = train_phase(torch, port, lk, card)
  phase_done(4)

  # -- 5. RSR policy training on cube-push
  r_launches = rsr_phase(torch, port, lk, card)
  phase_done(5)

  # -- 6. PPO on the Go2 joystick
  g_t_launches = go2_train_phase(torch, port, lk, card)[0]
  phase_done(6)

  # -- 7. env-parameter tuning on cube-push
  tune_launches = tuning_phase(torch, port, lk, card)
  phase_done(7)

  # -- 8. SAC: cube-push, RSR, the Go2 joystick; serving a SAC policy
  sac_launches = sac_phase(torch, port, lk, card)
  phase_done(8)

  # -- 9. T-push served and trained; PPO with domain randomisation
  dr_launches = [tpush_phase(torch, port, lk, card)]
  dr_launches.append(train_phase(torch, port, lk, card, name=TPUSH_ENV,
                                 tag='tpush train', steps=TPUSH_TRAIN_STEPS,
                                 eval_steps=TPUSH_EVAL_STEPS,
                                 num_minibatches=SHORT_MINIBATCHES))
  dr_launches.append(dr_train_phase(torch, port, lk, card, ENV))
  dr_launches.append(dr_train_phase(torch, port, lk, card, GO2_ENV))
  phase_done(9)

  # -- 10. the remaining Go2 tasks: getup, handstand, footstand, rough
  # terrain served; getup trained
  task_launches, full_launches, k1_tasks, k4_full = go2_tasks_phase(
      torch, port, lk, card)
  phase_done(10)

  # -- 11. the evaluation CLIs, a group of one
  import_cli(port)
  cli_launches, getup_eval = cli_phase(torch, lk, port, card)
  w1_launches = world1_phase(torch, lk, port, card)
  phase_done(11)

  # -- 12. deployment, the render rollouts at B 1, the scaling sweep
  import_deploy(port)
  deploy_phase(torch, port, card)
  b1_rows, b1_launches = render_phase(torch, port, lk, card)
  scale_launches = scaling_phase(torch, lk, port, card)
  phase_done(12)

  # -- 13. result
  log('kernels: ' + ', '.join(f'{v[0]} {k}' for k, v in KERNELS.items()))
  # phase 10's K4 launches at the full scene's R0 366 have an entry of their
  # own; its rough-terrain launches are at the Go2 rows' R0 58; its K1
  # launches (n 18 on both scenes) have an entry of their own; so have the
  # launches of phase 12's render rollouts at B 1
  rough_k4 = {'_newton_lanes_core': task_launches['_newton_lanes_core']
              - full_launches['_newton_lanes_core']}
  entries = [(name, rows[name], sum(phase.get(name, 0) for phase in (
      launches, g_launches, t_launches, r_launches, g_t_launches,
      tune_launches, sac_launches, *dr_launches, rough_k4, cli_launches,
      w1_launches, scale_launches)))
             for name in KERNELS]
  entries += [
      ('spd_solve_lanes [Go2 tasks, n 18]', k1_tasks,
       task_launches['spd_solve_lanes'] + getup_eval['spd_solve_lanes']),
      ('_newton_lanes_core [Go2 full collision, nv 18, R0 366]', k4_full,
       full_launches['_newton_lanes_core']
       + getup_eval['_newton_lanes_core']),
  ] + [(name, r, b1_launches[name]) for name, r in b1_rows.items()]
  out = []
  for name, r, count in entries:
    short, src, tpu = KERNELS[name.split(' ')[0]]
    if count <= 0:
      raise SystemExit(f'{name} was launched by no path')
    # ms and library_ms are device times from torch.profiler (the kernel by
    # name; the library call as the sum of its kernels): CUDA events over
    # back-to-back launches, printed beside them above, time the Python
    # wrapper's enqueue rate once a kernel takes under ~30 µs
    out.append({
        'name': name, 'route': 'cuda', 'source': src, 'replaces': tpu,
        'launches': count, 'max_abs_err': r['max_abs_err'],
        'ms': r['profiler_ms'], 'plain_ms': r['plain_ms'],
        'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
        'library_ms': r.get('library_device_ms'),
    })
  log(json.dumps({'kernels': out}))
  log(card)
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
