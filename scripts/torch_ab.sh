#!/usr/bin/env bash
# Parent-vs-change comparison of the PyTorch port on one GPU: each tree's own
# chip_smoke.py, run in the order parent, change, change, parent, so that a
# drift of the card's clocks over the call shows as a trend, not as a gain.
#
# Step 1, in a git checkout (stage the change first: git add -A):
#     scripts/torch_ab.sh prepare [PARENT [CHANGE]]
#   unpacks `git archive` of PARENT (default HEAD) and of CHANGE (default the
#   staged tree, `git write-tree`) into build/ab/parent and build/ab/change.
#   build/ is ignored by git; each tree is exactly what git would commit.
# Step 2, on the machine with the GPU, from the repository root:
#     scripts/torch_ab.sh run
#   runs the four smoke runs, each from its tree's root (each tree builds
#   its own kernels into its build/torch_kernels/), writes each run's whole
#   output to $AB_LOG_DIR/ab_<n>_<tree>.log (default build/ab/logs), and
#   prints each run's exit code, its timing and memory lines and its last
#   line. Exits 1 if any run failed.
set -u -o pipefail
cd "$(dirname "$0")/.."
AB=build/ab

case "${1:-}" in
  prepare)
    parent=${2:-HEAD}
    change=${3:-$(git write-tree)}
    rm -rf "$AB"
    for side in parent change; do
      mkdir -p "$AB/$side"
      rev=$parent; [ "$side" = change ] && rev=$change
      git archive "$rev" | tar -x -C "$AB/$side"
      echo "$side: $(git rev-parse "$rev") -> $AB/$side"
    done
    ;;
  run)
    logs=${AB_LOG_DIR:-$AB/logs}
    mkdir -p "$logs"
    fail=0
    n=0
    for side in parent change change parent; do
      n=$((n + 1))
      log=$logs/ab_${n}_${side}.log
      (cd "$AB/$side" && python3 chip_smoke.py) > "$log" 2>&1
      rc=$?
      echo "== run $n: $side, exit $rc"
      grep -E "forward|peak device memory|smoke wall time|^FAIL" "$log" | grep -v launches
      tail -n 1 "$log"
      [ "$rc" -eq 0 ] || fail=1
    done
    exit "$fail"
    ;;
  *)
    echo "usage: $0 prepare [PARENT [CHANGE]] | run" >&2
    exit 2
    ;;
esac
