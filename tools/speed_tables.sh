#!/usr/bin/env bash
# The speed drivers at their studies' grids, on the card: the tables of
# PERF.md section 6.  Each study's text and JSON lines go to $OUT/<study>.txt
# (default chiprun_out/speed_tables), the card's name and power limit to
# $OUT/card.txt.  Run from anywhere:
#
#   tools/speed_tables.sh [alg] [dense] [spmv] [profile] [error]
#
# (no argument: all five).  REPEATS sets `range`'s repeats (300, the
# reference's).  A study that fails is named at the end and the exit code is
# non-zero; the others still run.
set -uo pipefail
cd "$(dirname "$0")/.."
OUT=${OUT:-chiprun_out/speed_tables}
REPEATS=${REPEATS:-300}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
  | tee "$OUT/card.txt"
studies=("$@")
[ ${#studies[@]} -eq 0 ] && studies=(alg dense spmv profile error)
failed=()

alg() {
  local a=(python3 -m spmm_tpu_torch.benchmarks.alg_comparison --algs 1 2 3
           --chunk-fraction 0.2 --seed 2008 --memory --json
           --save-grid "$OUT/alg_grid.json")
  "${a[@]}" --size 512 1024 --density 0.1 0.5 --runs 20 &&
  "${a[@]}" --size 4096 --density 0.01 --runs 10 &&
  # alg3's host structural product takes seconds a call at 2048^2/0.5
  "${a[@]}" --size 2048 --density 0.1 0.5 --runs 5 --warmup 1 \
    --busy-calls 1
}

dense() {
  python3 -m spmm_tpu_torch.benchmarks.dense_vs_sparse --op spgemm --alg 2 \
    --size 1024 2048 4096 8192 --density 0.001 0.005 0.01 0.05 0.1 \
    --runs 10 --json
}

spmv() {
  python3 -m spmm_tpu_torch.benchmarks.spgemm_vs_spmv \
    --size 256 512 1024 --density 0.01 0.1 0.5 --runs 10 --json
}

profile() {
  python3 -m spmm_tpu_torch.benchmarks.component_profile --size 1024 \
    --density 0.1 --json &&
  python3 -m spmm_tpu_torch.benchmarks.component_profile --size 8192 \
    --density 0.001 --json
}

error() {
  local ne=(python3 -m spmm_tpu_torch.experiments.numerical_error)
  "${ne[@]}" error --sizes 256 512 1024 --densities 0.01 0.1 0.5 --json &&
  "${ne[@]}" distribution --size 1024 --density 0.1 --json &&
  "${ne[@]}" fraction --size 1024 --density 0.1 --ref f64 --json &&
  "${ne[@]}" range --size 512 --density 0.1 --repeats "$REPEATS" --json
}

for s in "${studies[@]}"; do
  t0=$(date +%s)
  "$s" 2>&1 | tee "$OUT/$s.txt"
  rc=${PIPESTATUS[0]}
  echo "# $s: rc=$rc in $(( $(date +%s) - t0 )) s" | tee -a "$OUT/$s.txt"
  [ "$rc" -eq 0 ] || failed+=("$s")
done
if [ ${#failed[@]} -gt 0 ]; then
  echo "failed: ${failed[*]}"
  exit 1
fi
