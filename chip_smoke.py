"""Run the PyTorch/H100 port on one card and check it.

    python3 chip_smoke.py

Run from the root of the repository.  It imports the port
(``rsr_mjx_tpu_torch``) and nothing of the JAX package.  Phases; any failure
exits non-zero before the result line is printed:

  1. device   a CUDA card is required (no CPU path); print the card's name and
              power limit; TF32 off; build the CUDA kernels from ``csrc/``.
  2. kernels  K1 spd_solve_lanes, K2 contact_select_lanes and
              K3 newton_lanes_pyr_t, each on the inputs the main path gives
              it (recorded from one control step of the batch), held against
              its plain PyTorch version on the same inputs, env by env (see
              check_kernels); K2 also on dist rounded to create exact ties.
              Times of the kernel, the plain version and, for K1 and K2,
              one PyTorch library call.
  3. slice    256 envs of the batch run 3 control steps on the card, on
              the CPU (plain versions) and on the CPU in float64; the card
              must be as close to float64 as the CPU's fp32 path is, and
              agree with the CPU on 4 envs after the first step (see
              reference()).
              Then the main path: the trained PPO cube-push policy
              (logs/cube_ppo_15M_r4/final_params.pkl) run deterministically
              on 2048 AirbotCubePushTrain envs through the training
              wrapper stack for 50 control steps (4 physics substeps
              each).  The kernels' launch counts, zeroed just before, must
              show K1 twice and K2, K3 once per substep.
              Then one more control step runs under torch.profiler: wall
              and device busy time, the device's idle share, the number of
              device kernels, and the host time of each stage.
  4. result   one JSON line of the kernels, the card's name and power limit,
              and last the line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PARAMS = os.path.join(ROOT, 'logs', 'cube_ppo_15M_r4', 'final_params.pkl')
ENV = 'AirbotCubePushTrain'
ENVS = 2048  # bench.py's per-chip batch
STEPS = 50  # control steps of the slice, 4 physics substeps each
SEED = 0
REF_ENVS = 256  # envs of the batch run also on the CPU, fp32 and float64

# Published peaks of one H100 SXM (NVIDIA data sheet, at the full 700 W
# limit): device-memory bytes/s and float32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12

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


# -- the least work of each kernel, from its inputs ------------------------


def k1_work(At, bt):
  n, B = bt.shape
  nbytes = 4 * (n * n * B + 2 * n * B)
  # Cholesky n³/3 multiply-adds, two triangular solves n² each, n roots
  flops = B * (2 * n**3 / 3 + 2 * n * n + n)
  return nbytes, flops


def k2_work(pair_struct, nsel, dist_l, feat_dyn, ptab):
  ncon, Fd, B = feat_dyn.shape
  Ptot, nst = ptab.shape
  # every dist read once; only the selected slots' features are needed
  nbytes = 4 * (ncon * B + nsel * Fd * B + Ptot * nst + ncon
                + nsel * (Fd + nst) * B)
  flops = ncon * B  # each dist compared at least once
  return nbytes, flops


def k3_work(iters, ls_iters, kind_s, Mt, a0t, x0t, Js, arefs, Ds, fls, U,
            arefU, Dc, naxes):
  nv, Rs, B = Js.shape
  NU, C = U.shape[1], Dc.shape[0]
  nc = 2 * naxes * C  # contact pyramid rows
  ins = (nv * nv + 2 * nv + nv * Rs + 3 * Rs + nv * NU + NU + C) * B + 2 * Rs
  outs = (nv + Rs + nc + nv) * B
  mv = 2 * nv * (nv + Rs + NU)  # one product with M, J and U
  per_iter = (
      2 * (nv * (nv + 1) // 2) * (Rs + NU)  # Hessian lower triangle
      + nv * Rs + 2 * nv * C * (1 + 2 * naxes)  # J·diag(c) and W = U·S
      + mv  # gradient
      + 2 * nv**3 / 3 + 2 * nv * nv  # Cholesky and solves
      + mv  # M dx, J dx, U dx
      + ls_iters * 8 * (Rs + nc)  # line search
      + 12 * (Rs + nc)  # accept test
  )
  flops = B * (mv + iters * per_iter + mv)
  return 4 * (ins + outs), flops


def bound_ms(nbytes, flops):
  t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
  return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else 'operations')


# -- phases ------------------------------------------------------------------


def record_calls(lk, fn):
  """Run fn() with the three kernel wrappers recording their arguments."""
  calls = {name: [] for name in KERNELS}
  real = {name: getattr(lk, name) for name in KERNELS}

  def recorder(name):
    def rec(*args):
      calls[name].append(args)
      return real[name](*args)
    return rec

  for name in KERNELS:
    setattr(lk, name, recorder(name))
  try:
    fn()
  finally:
    for name, f in real.items():
      setattr(lk, name, f)
  return calls


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


def check_kernels(torch, lk, calls):
  """Phase 2: every kernel against its plain version on recorded inputs.

  Every check is made env by env, each env against its own scale, so a
  kernel wrong in any one env fails.  Each criterion is also applied to the
  plain fp32 version against float64; its worst ratio is printed beside
  the kernel's (a criterion the plain version fails would be a wrong
  criterion, not a kernel fault)."""
  rows = {}
  f64 = lambda a: a.double() if torch.is_tensor(a) else a

  def worst(err, tol):
    return (err / tol).max().item()

  # K1, both calls of a substep (smooth qacc, implicit solve): per env
  # max|k − p| <= 1e-5·max|p| + 1e-6, and the normwise backward error
  # ‖Ax − b‖ / (‖A‖‖x‖ + ‖b‖), in float64, <= 1e-6 (a Cholesky solve is
  # backward stable: fp32 gives ~n·eps whatever A's condition number).
  err, ratios = 0.0, []
  for At, bt in calls['spd_solve_lanes'][-2:]:
    xk, xp = lk.spd_solve_lanes(At, bt), lk.spd_solve_plain(At, bt)
    x64 = lk.spd_solve_plain(At.double(), bt.double())
    err = max(err, (xk - xp).abs().max().item())
    tol = 1e-5 * per_env_max(xp) + 1e-6
    ratios.append(worst(per_env_max(xk - xp), tol))
    for x in (xk, xp):
      res = torch.einsum('ijb,jb->ib', At.double(), x.double()) - bt.double()
      eta = per_env_max(res) / (
          At.double().abs().sum(1).amax(0) * per_env_max(x.double())
          + per_env_max(bt.double()))
      ratios.append(worst(eta, torch.full_like(eta, 1e-6)))
    ratios.append(worst(per_env_max(xp.double() - x64),
                        1e-5 * per_env_max(x64) + 1e-6))
  At, bt = calls['spd_solve_lanes'][-1]
  A_bm = At.permute(2, 0, 1).contiguous()
  b_bm = bt.t().contiguous()[..., None]
  rows['spd_solve_lanes'] = dict(
      max_abs_err=err, ok=max(ratios) <= 1.0,
      ratios=f'kernel {max(ratios[0::4]):.3g}, kernel backward '
             f'{max(ratios[1::4]):.3g}, plain backward '
             f'{max(ratios[2::4]):.3g}, plain vs f64 {max(ratios[3::4]):.3g}',
      work=k1_work(At, bt),
      ms=time_ms(torch, lambda: lk.spd_solve_lanes(At, bt), 50),
      plain_ms=time_ms(torch, lambda: lk.spd_solve_plain(At, bt), 10),
      library_ms=time_ms(torch, lambda: torch.cholesky_solve(
          b_bm, torch.linalg.cholesky(A_bm)), 50),
      note='per env: |k-p| <= 1e-5*max|p| + 1e-6; backward error <= 1e-6',
  )

  # K2: exact equality, on the recorded dist and on dist with exact ties
  args = calls['contact_select_lanes'][-1]
  pair_struct, nsel, dist_l, feat_dyn, ptab = args
  tied = (torch.round(dist_l * 20) / 20).contiguous()
  err = 0.0
  for d in (dist_l, tied):
    a = (pair_struct, nsel, d, feat_dyn, ptab)
    err = max(err, (lk.contact_select_lanes(*a)
                    - lk.contact_select_plain(*a)).abs().max().item())
  ncon, Fd, B = feat_dyn.shape
  slot_pair = lk._slot_pair(pair_struct, dist_l.device).long()

  def topk_gather():
    idx = torch.topk(dist_l, nsel, dim=0, largest=False, sorted=True).indices
    dyn = torch.gather(feat_dyn, 0, idx[:, None, :].expand(nsel, Fd, B))
    return dyn, ptab[slot_pair[idx]]

  n_tied = int((tied[:-1] == tied[1:]).sum().item())
  rows['contact_select_lanes'] = dict(
      max_abs_err=err, ok=err == 0.0, ratios='exact',
      work=k2_work(*args),
      ms=time_ms(torch, lambda: lk.contact_select_lanes(*args), 50),
      plain_ms=time_ms(torch, lambda: lk.contact_select_plain(*args), 10),
      library_ms=time_ms(torch, topk_gather, 50),
      note=f'exact; tie case has {n_tied} equal neighbouring slots',
  )

  # K3 on the assembled system of the recorded substep, per env, after
  # 1 Newton step and after the full 6.  x is held by the objective it
  # reaches, since fp32 rounding (in any summation order) moves x along
  # the directions where φ is flat, by more than any per-env tolerance on x
  # that a wrong kernel would fail; force and qfrc must be those of the
  # kernel's own x, to the fp32 rounding of the sums they come from:
  #  - φ(xk) − φ(x64) <= 1e-6·(φ(x0) − φ(x64) + φ(x64)), φ >= 0 in float64,
  #    x64 the plain version's result in float64;
  #  - force: |fk − f(xk)| <= 1024·u·D(Σ|J||xk| + |aref|) row by row, f(xk)
  #    the plain version run for 0 steps from xk in float64;
  #  - qfrc: |qk − (Jᵀfk + Uᵀw(fk))| <= 64·u·(|J|ᵀ|fk| + |U|ᵀ|w(fk)|).
  args = calls['newton_lanes_pyr_t'][-1]
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
    tol_phi = 1e-6 * (phi0 - phi64 + phi64) + 1e-30
    for who, outs in (('kernel', lk.newton_lanes_pyr_t(*a_it)),
                      ('plain', lk.newton_pyr_plain(*a_it))):
      x, force, qfrc = (o.double() for o in outs)
      f_x = lk.newton_pyr_plain(0, args[1], args[2], a64[3], a64[4], x,
                                *a64[6:])[1]
      tol_f = 1024 * U32 * k3_force_scale(torch, args, x) + 1e-30
      fs, w = k3_split(torch, args, force)
      Js, U = a64[6], a64[10]
      proj = (Js * fs[None]).sum(1) + (U * w[None]).sum(1)
      tol_q = 64 * U32 * ((Js.abs() * fs.abs()[None]).sum(1)
                          + (U.abs() * w.abs()[None]).sum(1)) + 1e-30
      ratios[who, iters] = (
          worst(k3_cost(torch, lk, args, x) - phi64, tol_phi),
          worst((force - f_x).abs(), tol_f),
          worst((qfrc - proj).abs(), tol_q))
  fmt = lambda r: '/'.join(f'{v:.3g}' for v in r)
  rows['newton_lanes_pyr_t'] = dict(
      max_abs_err=err, ok=max(max(r) for r in ratios.values()) <= 1.0,
      ratios='phi/force/qfrc ' + ', '.join(
          f'{who} {it} step{"s" if it > 1 else ""} {fmt(r)}'
          for (who, it), r in ratios.items()),
      work=k3_work(*args),
      ms=time_ms(torch, lambda: lk.newton_lanes_pyr_t(*args), 20),
      plain_ms=time_ms(torch, lambda: lk.newton_pyr_plain(*args), 3, 1),
      library_ms=None,
      note='per env, after 1 and 6 Newton steps: phi(xk) within 1e-6 of '
           'the float64 solve; force and qfrc those of xk and of the force '
           'to fp32 rounding (1024u, 64u of their sums)',
  )

  failed = []
  for name, r in rows.items():
    short = KERNELS[name][0]
    r['bound_ms'], r['bound_by'] = bound_ms(*r['work'])
    log(f'{short} {name}: max |kernel - plain| {r["max_abs_err"]:.3e}; '
        f'{r["note"]}; worst error/tolerance over envs: {r["ratios"]} '
        f'{"ok" if r["ok"] else "FAIL"}; kernel_ms {r["ms"]:.5f} '
        f'plain_ms {r["plain_ms"]:.5f} library_ms {r["library_ms"]} '
        f'bound_ms {r["bound_ms"]:.5f} ({r["bound_by"]})')
    if not r['ok']:
      failed.append(name)
  if failed:
    raise SystemExit(f'kernel check failed: {failed}')
  return rows


def reference(torch, envs, env_gpu, policy, qpos, qvel, ctrl, steps=3):
  """The first REF_ENVS envs of the batch, the deterministic policy,
  ``steps`` control steps (4 substeps each) from the same start: on the
  card, on the CPU (plain versions) and on the CPU in float64.

  A few start states are chaotic in fp32: a change of qpos at the level of
  fp32 rounding moves the obs by more than the repo's 1e-2 tolerance within
  2 or 3 control steps, in any summation order.  So the card is held to
  the CPU elementwise on the first 4 envs after 1 step only, and after
  every step to float64 as a batch: the median over envs of its obs gap to
  float64 must be within 10x the CPU fp32 path's + 1e-6.  Both gaps to
  float64 are printed after each step (max, median, envs over 1e-3)."""
  from rsr_mjx_tpu_torch.train import networks

  f64 = torch.float64
  env_cpu = envs.load(ENV, device='cpu')
  env_64 = envs.load(ENV, device='cpu', dtype=f64)
  pol_cpu = networks.PPOPolicy(env_cpu.observation_size, env_cpu.action_size)
  pol_cpu.load_state_dict({k: v.cpu() for k, v in policy.state_dict().items()})
  s_g = env_gpu.reset_to(qpos, qvel, ctrl)
  s_c = env_cpu.reset_to(qpos.cpu(), qvel.cpu(), ctrl.cpu())
  s_d = env_64.reset_to(*(x.cpu().to(f64) for x in (qpos, qvel, ctrl)))
  ok = True
  for step in range(1, steps + 1):
    s_g = env_gpu.step(s_g, policy(s_g.obs))
    s_c = env_cpu.step(s_c, pol_cpu(s_c.obs))
    s_d = env_64.step(s_d, pol_cpu(s_d.obs.float()).to(f64))
    g, c, d = s_g.obs.cpu().to(f64), s_c.obs.to(f64), s_d.obs
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
    log(f'reference step {step}, {len(d)} envs: obs gap to float64 per env, '
        f'card {stats(gap_g)}; CPU fp32 {stats(gap_c)}; card-CPU max '
        f'{(g - c).abs().max().item():.4g} '
        f'{"ok" if good else "FAIL"}')
    ok = ok and good
  if not ok:
    raise SystemExit('the card disagrees with the CPU reference')


# stages of the fused step, each timed on the host by the profile phase
STAGES = (
    ('physics.lanes_kinematics', 'kinematics_lanes'),
    ('physics.lanes_smooth', 'gather_smooth'),
    ('physics.lanes_smooth', 'smooth_lanes'),
    ('physics.constraint', 'gather_leaves'),
    ('physics.constraint', 'narrowphase_leaves'),
    ('physics.lanes_assembly', 'assemble_lanes'),
)


def profile_control_step(torch, env, policy, state, step_ms):
  """One control step under torch.profiler: wall time, device busy time,
  device kernels launched, and the host time of each stage.  The idle
  share divides the device busy time by ``step_ms``, the wall time of a
  control step without the profiler (the profiler slows the host, not the
  device); the share under the profiler is printed beside it.  The full
  table goes to chiprun_out/profile.txt."""
  import importlib

  from torch.profiler import ProfilerActivity, profile, record_function

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
  # device rows: the kernels, and each stage's span on the device timeline
  # (an annotation, which is no device work of its own)
  kernels = [e for e in events
             if not on_host(e) and not e.key.startswith('stage.')]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  stages = {e.key[len('stage.'):]: e.cpu_time_total / 1e3 / e.count
            for e in events if on_host(e) and e.key.startswith('stage.')}
  log(f'profile: 1 control step, device busy {busy_ms:.3f} ms, idle share '
      f'{1 - busy_ms / step_ms:.4f} of the unprofiled step ({step_ms:.3f} '
      f'ms); under the profiler wall {wall_ms:.3f} ms, idle share '
      f'{1 - busy_ms / wall_ms:.4f}; {sum(e.count for e in kernels)} device '
      f'kernels; host ms per stage call (profiler on): '
      + ', '.join(f'{k} {v:.3f}' for k, v in stages.items()))
  os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
  with open(os.path.join(ROOT, 'chiprun_out', 'profile.txt'), 'w') as f:
    f.write(events.table(sort_by='self_device_time_total', row_limit=40))
    f.write(events.table(sort_by='cpu_time_total', row_limit=40))


def main() -> int:

  import torch

  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; the port has no CPU path here',
          file=sys.stderr)
    return 1
  try:
    from rsr_mjx_tpu_torch import envs
    from rsr_mjx_tpu_torch.envs import wrappers
    from rsr_mjx_tpu_torch.physics import cuda_build
    from rsr_mjx_tpu_torch.physics import linalg_kernels as lk
    from rsr_mjx_tpu_torch.train import networks
  except ImportError as e:
    print(f'chip_smoke: run from the repository root ({e})', file=sys.stderr)
    return 1

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

  # -- 2. kernels, on the inputs of one control step of the main path
  B = ENVS
  env0 = envs.load(ENV, device='cuda')
  env = wrappers.wrap_for_training(env0, episode_length=1200, num_envs=B)
  normalizer, params = networks.load_ppo_params(PARAMS)
  policy = networks.make_policy(normalizer, params['policy'], device='cuda')
  gen = torch.Generator(device='cuda').manual_seed(SEED)
  state = env.reset(gen)
  calls = record_calls(lk, lambda: env.step(state, policy(state.obs)))
  rows = check_kernels(torch, lk, calls)
  del calls

  # -- 3. the slice
  d0 = state.data
  n = REF_ENVS
  reference(torch, envs, env0, policy, d0.qpos[:n], d0.qvel[:n], d0.ctrl[:n])
  n_sub = env0.n_substeps
  lk.LAUNCHES.update(dict.fromkeys(lk.LAUNCHES, 0))
  torch.cuda.synchronize()
  t = time.perf_counter()
  rewards, nonfinite = [], torch.zeros((), device='cuda')
  for _ in range(STEPS):
    state = env.step(state, policy(state.obs))
    rewards.append(state.reward)
    nonfinite += state.metrics['nonfinite'].sum()
  torch.cuda.synchronize()
  wall = time.perf_counter() - t
  launches = dict(lk.LAUNCHES)
  substeps = STEPS * n_sub
  expect = {'spd_solve_lanes': 2 * substeps, 'contact_select_lanes': substeps,
            'newton_lanes_pyr_t': substeps}
  if launches != expect:
    raise SystemExit(f'launch counts {launches} != expected {expect}')
  rew = torch.stack(rewards)
  for name, x, shape in (('obs', state.obs, (B, 23)), ('reward', rew, None),
                         ('qpos', state.data.qpos, (B, env0.model.nq))):
    if shape is not None and tuple(x.shape) != shape:
      raise SystemExit(f'{name} has shape {tuple(x.shape)}, not {shape}')
    if not bool(torch.isfinite(x).all().item()):
      raise SystemExit(f'{name} is not finite')
  log(f'slice: {ENV} B={B}, {STEPS} control steps = {substeps} '
      f'substeps in {wall:.3f} s: {B * STEPS / wall:.1f} env-steps/s, '
      f'{wall / substeps * 1e3:.3f} ms/substep; mean reward per step '
      f'{rew.mean().item():.4f}; guard trips {int(nonfinite.item())}; '
      f'launches {launches}; card {card}')

  profile_control_step(torch, env, policy, state, wall / STEPS * 1e3)

  # -- 4. result
  log('kernels: ' + ', '.join(f'{v[0]} {k}' for k, v in KERNELS.items()))
  out = []
  for name, (short, src, tpu) in KERNELS.items():
    r = rows[name]
    out.append({
        'name': name, 'route': 'cuda', 'source': src, 'replaces': tpu,
        'launches': launches[name], 'max_abs_err': r['max_abs_err'],
        'ms': r['ms'], 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
        'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
    })
  log(json.dumps({'kernels': out}))
  log(card)
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
