#!/bin/bash
# The port's full-length figures on one card, in turn, each timed by the
# host clock: the cube-push parting capture of tests/torch_cube_parting_states.py,
# the benchmark at full length on cube-push (B 2048) and the Go2 joystick
# (B 8192), and the default evaluations of the three trained checkpoints
# (cube-push 128 x 1200, joystick 64 x 500, getup 128 x 500).  Each run's
# output goes to chiprun_out/card_figures_<tag>.log; its last lines and
# wall time to the standard output.  Run from the repository root:
#     bash tests/torch_card_figures.sh
set -o pipefail
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
run() {
  local tag=$1; shift
  local t0=$EPOCHREALTIME
  "$@" 2>&1 | tee chiprun_out/card_figures_$tag.log | grep -v Warning | tail -12
  local rc=${PIPESTATUS[0]}
  echo "== $tag rc=$rc wall $(awk "BEGIN{print $EPOCHREALTIME - $t0}") s"
}
run capture python3 tests/torch_cube_parting_states.py --capture
run bench_cube python3 -m rsr_mjx_tpu_torch.bench
run bench_go2 python3 -m rsr_mjx_tpu_torch.bench --env Go2JoystickFlatTerrain --num_envs 8192
run eval_cube python3 -m rsr_mjx_tpu_torch.train.eval_policy logs/cube_ppo_15M_r4/final_params.pkl
run eval_joystick python3 -m rsr_mjx_tpu_torch.train.eval_go2 logs/go2_joystick_50M_r5/final_params.pkl
run eval_getup python3 -m rsr_mjx_tpu_torch.train.eval_go2 logs/go2_getup_5M_r5/final_params.pkl --env Go2Getup --episodes 128
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
