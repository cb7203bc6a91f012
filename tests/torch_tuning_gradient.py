"""The demo tuning loss and its gradient in both packages, on JAX's template.

    JAX_PLATFORMS=cpu python tests/torch_tuning_gradient.py [P ...]

The demo command of logs/rsr_demo_r4/README.md: AirbotCubePush at its full
width, 30 transitions of data_rsr_demo from 15, k 1, the default friction
setter.  The JAX package's ``env_params_tuning`` builds its template (the
reset of PRNGKey(0), one zero-action step) and its loss, the Pallas kernels
in interpret mode; ``jax.value_and_grad`` of that loss is taken at each P
(0.4 and 0.6 by default).  The port gets the same template through
``make_env_tuning_loss(template=...)`` and gives its loss and gradient on
the CPU in fp32 and in float64, and the central difference of its float64
loss (step 1e-4).  It prints one line per P.  Takes about 15 minutes on 8
CPU cores, most of it JAX's compile of the gradient.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START, N, FD_STEP = 15, 30, 1e-4


def demo_rows():
  load = lambda name: np.loadtxt(os.path.join(ROOT, 'data_rsr_demo', name),
                                delimiter=',', ndmin=2)
  obs, act = load('real_obs.txt'), load('real_action.txt')
  return (obs[START:START + N], act[START:START + N],
          obs[START + 1:START + N + 1])


def jax_side(points):
  """JAX's template (reset state, stepped state) as numpy trees, and its
  (loss, gradient) at each point."""
  import jax
  import jax.numpy as jnp

  from rsr_mjx_tpu import envs as jenvs
  from rsr_mjx_tpu.physics import fwd_fused as jFF
  from rsr_mjx_tpu.physics import linalg_kernels as jlk
  from rsr_mjx_tpu.rsr import pipeline as jpipeline

  jlk._INTERPRET = True
  jFF._CACHE.clear()
  env = jenvs.load('AirbotCubePush')
  state_0 = jax.jit(env.reset)(jax.random.PRNGKey(0))
  state_1 = jax.jit(env.step)(state_0, jnp.zeros(env.action_size))
  # the loss env_params_tuning builds (zero Adam steps)
  got, real = [], jpipeline._make_tuning_loss
  jpipeline._make_tuning_loss = lambda *a, **k: got.append(real(*a, **k)) \
      or got[-1]
  try:
    jpipeline.env_params_tuning(env, 0, 0.4, 0.08, 4.0, *demo_rows())
  finally:
    jpipeline._make_tuning_loss = real
  value_and_grad = jax.jit(jax.value_and_grad(got[0]))
  out = {}
  for p in points:
    t = time.time()
    loss, grad = value_and_grad(jnp.float32(p))
    out[p] = (float(loss), float(grad))
    print(f'jax at {p}: {time.time() - t:.1f} s', file=sys.stderr)
  template = tuple(jax.tree.map(np.asarray, s) for s in (state_0, state_1))
  return template, out


def port_template(template, dtype):
  """The port's (reset state, stepped state) holding JAX's values: every
  Data field the two packages share, the contact distances, obs, reward,
  done, metrics and info, each with a batch axis of 1."""
  import torch

  from rsr_mjx_tpu_torch import envs as penvs
  from rsr_mjx_tpu_torch.physics import types as ptypes

  env = penvs.load('AirbotCubePush', device='cpu', dtype=dtype)
  t = lambda a: torch.from_numpy(np.array(a))[None].to(
      dtype if np.issubdtype(np.asarray(a).dtype, np.floating) else None)
  out = []
  for js in template:
    jd = js.data
    st = env.reset_to(t(jd.qpos), t(jd.qvel), t(jd.ctrl))
    fields = {f: t(getattr(jd, f)) for f in ptypes.DATA_FIELDS
              if hasattr(jd, f) and np.shape(getattr(jd, f))
              == tuple(getattr(st.data, f).shape[1:])}
    contact = st.data.contact
    contact = type(contact)(**{**contact.__dict__,
                               'dist': t(jd.contact.dist)})
    assert set(st.info) <= set(js.info) and set(st.metrics) <= set(js.metrics)
    out.append(st.replace(
        data=st.data.replace(contact=contact, **fields), obs=t(js.obs),
        reward=t(js.reward), done=t(js.done),
        metrics={k: t(js.metrics[k]) for k in st.metrics},
        info={k: t(js.info[k]) for k in st.info}))
  return env, tuple(out)


def port_side(template, points):
  """The port's (loss, gradient) in fp32 and float64 at each point, and
  the central difference of its float64 loss."""
  import torch

  from rsr_mjx_tpu_torch.rsr import pipeline as ppipeline

  fns = {}
  for dtype in (torch.float32, torch.float64):
    env, tmpl = port_template(template, dtype)
    fns[dtype] = ppipeline.make_env_tuning_loss(
        env, *demo_rows(), template=tmpl, device='cpu')
  out = {}
  for p in points:
    row = []
    for dtype, fn in fns.items():
      x = torch.tensor(p, dtype=torch.float32).to(dtype).requires_grad_(True)
      loss = fn(x)
      (g,) = torch.autograd.grad(loss, x)
      row += [loss.item(), g.item()]
    with torch.no_grad():
      x = torch.tensor(p, dtype=torch.float32).to(torch.float64)
      fd = (fns[torch.float64](x + FD_STEP).item()
            - fns[torch.float64](x - FD_STEP).item()) / (2 * FD_STEP)
    out[p] = tuple(row) + (fd,)
  return out


def main(points):
  os.environ['JAX_PLATFORMS'] = 'cpu'
  sys.path.insert(0, ROOT)
  template, jax_out = jax_side(points)
  port_out = port_side(template, points)
  for p in points:
    jl, jg = jax_out[p]
    l32, g32, l64, g64, fd = port_out[p]
    print(f'at {p}: loss JAX {jl!r} port fp32 {l32!r} float64 {l64!r}; '
          f'gradient JAX {jg!r} port fp32 {g32!r} float64 {g64!r}; '
          f'central difference of the float64 loss (step {FD_STEP}) {fd!r}')


if __name__ == '__main__':
  main([float(a) for a in sys.argv[1:]] or [0.4, 0.6])
