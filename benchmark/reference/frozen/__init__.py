"""A frozen copy of the port's plain path: the physics step (every stage,
with the four kernels' plain versions), the cube-push and Go2 joystick
envs, the training wrappers, the PPO networks, normaliser and loss.

Copied from ``rsr_mjx_tpu_torch`` at commit 521e15e18949 and kept here so
that the benchmark's reference does not move when the port does.  The
copy imports nothing of ``rsr_mjx_tpu_torch``; its own edits are:

- imports renamed to ``benchmark.reference.frozen``;
- ``physics/linalg_kernels.py``: the plain versions of K1-K4 alone (the
  CUDA route, the shared-memory sizing and the backward passes cut);
- ``physics/fwd_fused.py``: the gradient path (``FusedRegion`` and the
  implicit-function-theorem ``solver``) cut;
- ``physics/io.py``: the snapshot reader alone (``put_model`` and the
  writer cut); ``envs/*/snapshot.py``: the snapshot's path alone (the
  MJCF builders in ``scene.py``, which need ``mujoco``, cut);
- ``envs/airbot/cube_push.py``: the 'train' variant alone;
- ``train/losses.py``: the RSR term, 0 without past data, cut (with
  ``rsr/``);
- ``physics/forward.py``: ``ALLOW_TF32`` (False, as the port) that the
  precision control sets;
- ``envs/__init__.py`` and ``train/__init__.py`` trimmed to the two envs
  and the modules copied; ``assets/`` holds the two model snapshots the
  envs read (written by the port's ``put_model``; the envs built on them
  are held to the JAX package's in
  ``benchmark/tests/test_bench_jax_fixtures.py``).

The docstrings are the port's (two reworded) and name its paths.
"""
