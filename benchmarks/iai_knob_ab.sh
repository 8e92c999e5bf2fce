#!/bin/bash
# Depth-knob A/B matrix for the warm aps IAI leg (run on a quiet host: host
# load inflates the walls of this depth-bound leg).
# Each run prints the IAI telemetry line; results accumulate in $OUT.
OUT=${OUT:-/tmp/iai_knob_ab.txt}
cd "$(dirname "$0")/.." || exit 1
run() {
  local tag="$1"; shift
  echo "=== $tag : $* ===" | tee -a "$OUT"
  local t0=$SECONDS
  timeout 1200 python examples/aps_example.py --with-iai --skip-ptr \
    --out /tmp/ab_$tag.npz "$@" 2>&1 | grep -E "IAI|DOS|chunk evals" | tee -a "$OUT"
  echo "total wall: $((SECONDS - t0)) s" | tee -a "$OUT"
}
run base
run p8   --iai-leaf-presplit 8
run p16  --iai-leaf-presplit 16
run n2   --iai-leaf-nbisect 2
run p8n2 --iai-leaf-presplit 8 --iai-leaf-nbisect 2
run w4   --iai-inner-seed-width 4
run c66  --iai-chunk 66
