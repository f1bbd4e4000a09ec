#!/usr/bin/env bash
# The three training runs that scripts/bf16_dynamics_check.py compares, then the
# check: float32 seeds 4 and 5 and bf16 seed 4, each 15 epochs of cli.train on
# 50,000 synthetic jets with the FPD every 3 epochs.
#
#   scripts/bf16_dynamics_runs.sh flagship|knn20 OUT_DIR
#
# flagship: the 30-particle MPGAN; knn20: the 150-particle knn-20 MPGAN. For a
# machine with a CUDA card. The runs land in OUT_DIR/{f32_s4,f32_s5,bf16_s4}.
set -euo pipefail
path=$1
out=$2
case $path in
  flagship) model=(--model mpgan) ;;
  knn20) model=(--model mpgan --num-hits 150 --no-fully-connected --num-knn 20) ;;
  *) echo "unknown path $path" >&2; exit 2 ;;
esac
mkdir -p "$out"
for run in f32_s4:4: f32_s5:5: bf16_s4:4:bfloat16; do
  IFS=: read -r name seed dtype <<<"$run"
  extra=()
  [ -n "$dtype" ] && extra=(--compute-dtype "$dtype")
  python -m mpgan_tpu_torch.cli.train --name "$name" --jets g "${model[@]}" \
    --num-samples 50000 --num-epochs 15 --save-epochs 3 --fpd --seed "$seed" \
    --dir-path "$out" "${extra[@]}" >"$out/$name.log" 2>&1
done
python "$(dirname "$0")/bf16_dynamics_check.py" "$out"
