#!/usr/bin/env bash
# Time a parent checkout and this tree in turns on one card: P C C P P C C P, each
# turn running the benches (default the four: knn, step, fwd, bwd) with --reps as
# given and the extra flags, if any, on every bench.
#
#   scripts/torch_turns.sh PARENT_DIR [OUT_DIR] [REPS] [BENCHES] [FLAGS]
#
# e.g. the bf16 backward kernels and bf16 graph steps:
#   scripts/torch_turns.sh build/parent build/turns 10 "bwd step" --bf16
#
# PARENT_DIR holds the parent's chip_smoke.py and mpgan_tpu_torch, for example
#   mkdir -p build/parent && git archive HEAD chip_smoke.py mpgan_tpu_torch scripts \
#     | tar -x -C build/parent
# Every bench line (one JSON object) goes to OUT_DIR/turns.jsonl with its turn
# number in "turn"; stderr to OUT_DIR/turns.err. Stops at the first failure.
set -euo pipefail
parent=$1
out=${2:-chiprun_out}
reps=${3:-10}
benches=${4:-knn step fwd bwd}
flags=${5:-}
here=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
turn=0
for side in parent change change parent parent change change parent; do
  turn=$((turn + 1))
  root=$here
  [ "$side" = parent ] && root=$(cd "$parent" && pwd)
  for bench in $benches; do
    r=$reps
    [ "$bench" = step ] && r=4
    # shellcheck disable=SC2086
    python "$here/scripts/torch_${bench}_bench.py" --root "$root" --label "$side" --reps "$r" \
      $flags 2>>"$out/turns.err" | sed "s/^{/{\"turn\": $turn, /" | tee -a "$out/turns.jsonl"
  done
done
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
