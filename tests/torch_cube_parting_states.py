"""The cube-push envs that part from float64 in ``chip_smoke.py``'s reference,
handed to both packages.

    python3 tests/torch_cube_parting_states.py --capture [OUT]   # on the card
    JAX_PLATFORMS=cpu python tests/torch_cube_parting_states.py [NPZ]

``--capture`` (the card, no JAX) repeats the cube-push reference of
``chip_smoke.py`` phase 3: the port's reset of ``chip_smoke.ENVS`` envs from
its generator on the card seeded ``chip_smoke.SEED``, the first
``REF_ENVS`` (256) of them for 3 control steps of the trained policy
(``logs/cube_ppo_15M_r4``, deterministic) on the card, on the CPU in fp32
and on the CPU in float64.  Each env whose observation moves more than
1e-3 from float64's after any step, on the card or on the CPU in fp32, is
flagged; their reset states (qpos, qvel, act, ctrl), the actions each run
took and the gaps are saved to OUT (default
``chiprun_out/cube_parting_states.npz``; the committed copy is
``rsr_mjx_tpu_torch/assets/cube_parting_states.npz``).

Without ``--capture`` it hands those reset states to four runs, each in a
process of its own, as ``tests/torch_fp32_parting.py`` does: the JAX
package in fp32 through its lanes route with the Pallas kernels in
interpret mode (``jax32``), the JAX package under ``jax_enable_x64``
(``jax64``: the per-env chain with the adaptive solver, another
algorithm), the port on the CPU in fp32 (``port32``) and in float64
(``port64``, the lanes route's float64 reference), each driven by the
policy on its own observations for 3 control steps.  It prints the gaps
env by env beside the card's recorded gap.  About 3 minutes on 8 CPU
cores, most of it the jit of the JAX step.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, 'rsr_mjx_tpu_torch', 'assets',
                   'cube_parting_states.npz')
PARAMS = os.path.join(ROOT, 'logs', 'cube_ppo_15M_r4', 'final_params.pkl')
ENV = 'AirbotCubePushTrain'
STEPS = 3
FLAG = 1e-3
MODES = ('jax32', 'jax64', 'port32', 'port64')


def capture(out: str) -> None:
  """The card's side: chip_smoke's reference, recorded."""
  import torch

  sys.path.insert(0, ROOT)
  import chip_smoke as cs

  if not torch.cuda.is_available():
    raise SystemExit('--capture needs the card')
  port = cs.import_port()
  port.cuda_build.build_all()
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_grad_enabled(False)
  f32, f64 = torch.float32, torch.float64
  gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
  env0, _, policy, state = cs.load_path(torch, port, cs.ENV, cs.PARAMS,
                                        cs.ENVS, 1200, gen)
  d0, n = state.data, cs.REF_ENVS
  init = [x[:n] for x in (d0.qpos, d0.qvel, d0.ctrl)]
  pol_cpu = cs.load_policy(port, cs.PARAMS, 'cpu')
  obs, acts = {}, {}
  for tag, device, dtype in (('card', cs.DEV, f32), ('cpu32', 'cpu', f32),
                             ('cpu64', 'cpu', f64)):
    env = env0 if device == cs.DEV else port.envs.load(cs.ENV, device=device,
                                                        dtype=dtype)
    s = env.reset_to(*(x.to(device, dtype) for x in init))
    pol = policy if device == cs.DEV else pol_cpu
    obs[tag], acts[tag] = [s.obs.cpu().double()], []
    for _ in range(STEPS):
      a = pol(s.obs.float()).to(dtype)
      s = env.step(s, a)
      acts[tag].append(a.cpu().double())
      obs[tag].append(s.obs.cpu().double())
  stack = lambda xs: torch.stack(xs).numpy()
  gap = {t: np.abs(stack(obs[t]) - stack(obs['cpu64'])).max(-1)[1:]
         for t in ('card', 'cpu32')}  # (STEPS, n)
  flagged = np.flatnonzero((gap['card'] > FLAG).any(0)
                           | (gap['cpu32'] > FLAG).any(0))
  pick = lambda x: x[:n][flagged].cpu().numpy()
  np.savez(out, idx=flagged, qpos=pick(d0.qpos), qvel=pick(d0.qvel),
           act=pick(d0.act), ctrl=pick(d0.ctrl),
           **{f'actions_{t}': stack(acts[t])[:, flagged] for t in acts},
           **{f'gap_{t}': g[:, flagged] for t, g in gap.items()})
  print(f'{ENV}: {len(flagged)} of {n} envs part from float64 by more '
        f'than {FLAG} within {STEPS} control steps: {flagged.tolist()}')
  for t, g in gap.items():
    print(f'  {t} gap to float64 after each step, flagged envs: '
          + '; '.join(' '.join(f'{x:.3g}' for x in row)
                      for row in g[:, flagged]))
  print(f'saved to {out}')


def rollout(mode: str, npz: str, out: str) -> None:
  """One of MODES from the saved states; saves the observations
  (STEPS + 1, k, 23) as float64 to ``out``."""
  os.environ['JAX_PLATFORMS'] = 'cpu'
  sys.path.insert(0, ROOT)
  import jax
  import jax.numpy as jnp

  if mode == 'jax64':
    jax.config.update('jax_enable_x64', True)
  from rsr_mjx_tpu.envs import core as jcore
  from rsr_mjx_tpu import envs as jenvs
  from rsr_mjx_tpu.envs import wrappers as jwrappers
  from rsr_mjx_tpu.physics import fwd_fused as jFF
  from rsr_mjx_tpu.physics import linalg_kernels as jlk
  from rsr_mjx_tpu.train import networks as jnets
  from rsr_mjx_tpu.train import ppo, running_statistics, sac

  states = np.load(npz)
  k = len(states['idx'])
  net = jnets.make_ppo_networks(23, 5, policy_hidden_layer_sizes=(32,) * 4,
                                value_hidden_layer_sizes=(256,) * 5)
  policy = jax.jit(ppo._make_policy_factory(net, running_statistics.normalize)(
      sac.load_params(PARAMS), deterministic=True))
  act = lambda o: policy(jnp.asarray(o, jnp.float32), jax.random.PRNGKey(0))[0]
  obs = []

  if mode.startswith('jax'):
    base = jenvs.load(ENV)
    init = {f: jnp.asarray(states[f], jnp.float32)
            for f in ('qpos', 'qvel', 'ctrl')}
    reset = base.reset

    def reset_to(rng):
      """The JAX reset (cube_push.py:182-201) from saved state rng[1]."""
      state = reset(rng)
      i = rng[1]
      data = jcore.init(base._model, qpos=init['qpos'][i],
                        qvel=init['qvel'][i])
      data = data.replace(ctrl=init['ctrl'][i])
      info = dict(state.info, target_pos=data.xpos[base._target_body],
                  site_pos=data.site_xpos[base._site_id],
                  cube_pos=data.xpos[base._cube_body])
      return state.replace(data=data, obs=base._get_obs(data, info),
                           info=info)

    base.reset = reset_to
    env = jwrappers.wrap_for_training(base, episode_length=1200)
    keys = jnp.stack([jnp.zeros(k, jnp.uint32),
                      jnp.arange(k, dtype=jnp.uint32)], axis=1)
    state = jax.jit(env.reset)(keys)
    if mode == 'jax64':  # as tests/torch_fp32_parting.py: reset in fp32
      cast = lambda tree: jax.tree.map(
          lambda x: x.astype(jnp.float64)
          if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)
      base._model = cast(base._model)
      state = cast(state)
    obs.append(np.asarray(state.obs, np.float64))
    step = jax.jit(jwrappers.wrap_for_training(base, episode_length=1200).step)
    jlk._INTERPRET = True
    jFF._CACHE.clear()
    for _ in range(STEPS):
      state = step(state, act(state.obs).astype(state.obs.dtype))
      obs.append(np.asarray(state.obs, np.float64))
  else:
    import torch

    from rsr_mjx_tpu_torch import envs as penvs
    from rsr_mjx_tpu_torch.envs import wrappers as pwrappers

    dtype = torch.float64 if mode == 'port64' else torch.float32
    pbase = penvs.load(ENV, device='cpu', dtype=dtype)
    init = tuple(torch.from_numpy(states[f]).to(dtype)
                 for f in ('qpos', 'qvel', 'ctrl'))
    pbase.sample_init = lambda generator, batch: init
    penv = pwrappers.wrap_for_training(pbase, episode_length=1200,
                                       num_envs=k)
    ps = penv.reset(torch.Generator().manual_seed(0))
    obs.append(ps.obs.double().numpy())
    with torch.no_grad():
      for _ in range(STEPS):
        a = torch.from_numpy(np.array(act(ps.obs.float().numpy())))
        ps = penv.step(ps, a.to(dtype))
        obs.append(ps.obs.double().numpy())
  np.save(out, np.stack(obs))


def main(npz: str) -> None:
  states = np.load(npz)
  with tempfile.TemporaryDirectory() as tmp:
    runs = {m: os.path.join(tmp, f'{m}.npy') for m in MODES}
    procs = [subprocess.Popen([sys.executable, __file__, '--run', m, npz,
                               path]) for m, path in runs.items()]
    if any(p.wait() for p in procs):
      raise SystemExit('a rollout failed')
    obs = {m: np.load(path) for m, path in runs.items()}
  print(f'{len(states["idx"])} cube-push reset states flagged on the card '
        f'(envs {states["idx"].tolist()} of chip_smoke\'s reference): max '
        '|obs gap| after control step 1, 2, 3 (rows), env by env (columns)')
  print('  reset: jax32 - port32 '
        f'{np.abs(obs["jax32"][0] - obs["port32"][0]).max():.3g}')
  fmt = lambda g: '; '.join(' '.join(f'{x:.3g}' for x in row) for row in g)
  for t in ('card', 'cpu32'):
    print(f'  recorded {t} - float64: {fmt(states[f"gap_{t}"])}')
  gaps = {}
  for a, b in (('port32', 'port64'), ('jax32', 'port64'),
               ('jax32', 'port32'), ('jax32', 'jax64'), ('jax64', 'port64')):
    gaps[a, b] = np.abs(obs[a] - obs[b]).max(-1)[1:]
    print(f'  {a} - {b}: {fmt(gaps[a, b])}')
  parts = {t: (states[f'gap_{t}'] > FLAG).any(0) for t in ('card', 'cpu32')}
  parts.update({a: (gaps[a, 'port64'] > FLAG).any(0)
                for a in ('port32', 'jax32')})
  jax, port = parts['jax32'], parts['port32']
  print(f'  envs apart from float64 by more than {FLAG} within {STEPS} '
        'steps: ' + ', '.join(f'{t} {int(p.sum())}' for t, p in parts.items())
        + f'; jax32 and port32 both {int((jax & port).sum())}, jax32 alone '
        f'{int((jax & ~port).sum())}, port32 alone {int((port & ~jax).sum())}')


if __name__ == '__main__':
  argv = sys.argv[1:]
  if argv[:1] == ['--run']:
    rollout(*argv[1:4])
  elif argv[:1] == ['--capture']:
    capture(argv[1] if len(argv) > 1 else os.path.join(
        ROOT, 'chiprun_out', 'cube_parting_states.npz'))
  else:
    main(argv[0] if argv else NPZ)
