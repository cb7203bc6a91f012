"""K3 at the cold start of tests/test_fwd_fused.py's gradient recipe.

    JAX_PLATFORMS=cpu python tests/torch_cold_start_k3.py

AirbotCubePush at max_contacts=8, friction column 0 at 0.8, B 2: qpos0 +
0.01·N, qvel 0.1·N, ctrl 0.2·N (numpy seed 0), qacc 0, so the pyramid
Newton kernel K3 starts cold.  Two sets of fp32 inputs of K3 come from the
JAX package's lanes stages (Pallas in interpret mode): the stages jitted
one by one, and what ``physics.step`` hands K3 (caught by a debug
callback).  They differ only by rounding (a0 by about 2e-6 of its scale).
The script runs K3 on each set in JAX, in the port in fp32 and in the
port in float64, and prints the gaps of x relative to its scale: where a
rounding-level change of the inputs flips a line-search decision of the
fp32 solve, the two packages' fp32 kernels still agree on the same
inputs.  Takes about a minute on 8 CPU cores.
"""

import importlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
  os.environ['JAX_PLATFORMS'] = 'cpu'
  sys.path.insert(0, ROOT)
  import jax
  import jax.numpy as jnp
  import torch

  from rsr_mjx_tpu import envs as jenvs
  from rsr_mjx_tpu import physics as jphysics
  from rsr_mjx_tpu.physics import constraint as jC
  from rsr_mjx_tpu.physics import fwd_fused as jFF
  from rsr_mjx_tpu.physics import lanes_assembly as jA
  from rsr_mjx_tpu.physics import lanes_kinematics as jK
  from rsr_mjx_tpu.physics import lanes_smooth as jS
  from rsr_mjx_tpu.physics import linalg_kernels as jlk
  from rsr_mjx_tpu_torch.physics import linalg_kernels as plk

  jm = jenvs.load('AirbotCubePush', max_contacts=8).model
  jm = jm.replace(geom_friction=jm.geom_friction.at[:, 0].set(0.8))
  # physics.forward the module (the package exports a function of that name)
  d0 = importlib.import_module('rsr_mjx_tpu.physics.forward').make_data(jm)
  B = 2
  rng = np.random.default_rng(0)
  f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))
  qpos = f32(np.asarray(d0.qpos)[None] + 0.01 * rng.normal(size=(B, jm.nq)))
  qvel = f32(0.1 * rng.normal(size=(B, jm.nv)))
  ctrl = f32(0.2 * rng.normal(size=(B, jm.nu)))
  d = jax.vmap(lambda q, v, c: d0.replace(qpos=q, qvel=v, ctrl=c))(
      qpos, qvel, ctrl)
  jlk._INTERPRET = True
  jFF._CACHE.clear()

  # the stages one by one (tests/test_torch_stages.py's recipe)
  lanes = lambda x: jnp.moveaxis(x, 0, -1)
  expand = lambda x: x[..., None]
  kl = jK.gather_kin(jm, d)
  kl = jK.KinLeaves(lanes(kl.qpos), *(expand(x) for x in kl[1:]))
  kout = jax.jit(lambda kl: jK.kinematics_lanes(jm, kl))(kl)
  batched = ('qpos', 'qvel', 'ctrl', 'qfrc_applied', 'xfrc_applied')
  sl = jS.SmoothLeaves(*(
      lanes(x) if f in batched else expand(x)
      for f, x in zip(jS.SmoothLeaves._fields, jS.gather_smooth(jm, d))
  ))._replace(cdof=kout.cdof, cdof_anchor=kout.cdof_anchor,
              ximat=kout.ximat, xipos=kout.xipos,
              subtree_com=kout.subtree_com)
  sout = jax.jit(lambda sl: jS.smooth_lanes(jm, sl))(sl)
  dyn = dict(qpos=sl.qpos, qvel=sl.qvel, cdof=kout.cdof,
             cdof_anchor=kout.cdof_anchor, geom_xpos=kout.geom_xpos,
             geom_xmat=kout.geom_xmat)
  keep = ('hfield_data', 'geom_size', 'con_friction', 'con_solref',
          'con_solimp', 'con_invweight')
  lv = jC.AssembleLeaves(*(
      dyn[f] if f in dyn
      else x if f in keep else jnp.broadcast_to(x, (B,) + x.shape)
      for f, x in zip(jC.AssembleLeaves._fields, jC.gather_leaves(jm, d))))
  J_s, aref_s, D_s, fl_s, _, U, arefU, D_c, naxes = jax.jit(
      lambda lv: jA.assemble_lanes(jm, lv, basis=True, dyn_lanes=True))(lv)
  lay = jC.layout_cached(jm)
  kind_s = lay.kind[:lay.n_eq + lay.n_fri + lay.n_lim]
  staged = [np.asarray(a) for a in (
      sout[0], sout[7], jnp.zeros((jm.nv, B), jnp.float32), J_s, aref_s,
      D_s, fl_s, U, arefU, D_c)]

  # what the step hands K3
  seen, real = [], jlk.newton_lanes_pyr_t

  def spy(iters, ls, kind, *a):
    jax.debug.callback(lambda *v: seen.append([np.array(x) for x in v]),
                       *a[:-1])
    return real(iters, ls, kind, *a)

  jlk.newton_lanes_pyr_t = spy
  try:
    jax.block_until_ready(
        jax.jit(jax.vmap(lambda d: jphysics.step(jm, d)))(d).qpos)
  finally:
    jlk.newton_lanes_pyr_t = real
  stepped = seen[0]

  naxes = int(naxes)
  x = {}
  for tag, inp in (('staged', staged), ('step', stepped)):
    a0 = inp[1]
    print(f'{tag}: a0 {np.abs(a0 - staged[1]).max() / np.abs(a0).max():.3g} '
          f'of its scale from the staged a0')
    x[tag, 'jax'] = np.asarray(real(6, 6, kind_s, *map(jnp.asarray, inp),
                                    naxes)[0], np.float64)
    for dt, name in ((torch.float32, 'port32'), (torch.float64, 'port64')):
      x[tag, name] = plk.newton_lanes_pyr_t(
          6, 6, kind_s, *(torch.from_numpy(a).to(dt) for a in inp),
          naxes)[0].double().numpy()
  scale = np.abs(x['staged', 'port64']).max()
  gap = lambda a, b: np.abs(x[a] - x[b]).max() / scale
  for tag in ('staged', 'step'):
    print(f'K3 on the {tag} inputs: JAX − port fp32 '
          f'{gap((tag, "jax"), (tag, "port32")):.3g}, JAX − port float64 '
          f'{gap((tag, "jax"), (tag, "port64")):.3g}, port fp32 − float64 '
          f'{gap((tag, "port32"), (tag, "port64")):.3g}')
  print(f'port float64, step − staged inputs: '
        f'{gap(("step", "port64"), ("staged", "port64")):.3g}; '
        f'JAX fp32, step − staged inputs: '
        f'{gap(("step", "jax"), ("staged", "jax")):.3g}')


if __name__ == '__main__':
  main()
