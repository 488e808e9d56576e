#!/bin/sh
# the spread of a cell: two sets of 6 runs at the cell's run_seconds,
# the same 6 seeds in each, each run its own process; then 3 traced
# runs. Result lines in <out>/sets.jsonl (default build/sets).
#   sh portbench/sets.sh <workload> <seconds> <first seed> [<out>]
w=$1; sec=$2; s0=$3; out=${4:-build/sets}
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for set in a b; do
  for i in 0 1 2 3 4 5; do
    seed=$((s0 + 97 * i))
    python3 portbench/run.py --workload $w --seed $seed --seconds $sec --trace 0 \
      > $out/run.out 2> $out/run.err
    rc=$?
    echo "{\"set\": \"$set\", \"seed\": $seed, \"rc\": $rc, \"result\": $(tail -n 1 $out/run.out || echo null)}" >> $out/sets.jsonl
    grep "portbench:" $out/run.err | cut -c1-300
  done
done
for i in 6 7 8; do
  seed=$((s0 + 97 * i))
  python3 portbench/run.py --workload $w --seed $seed --seconds $sec --trace 1 \
    > $out/run.out 2> $out/run.err
  rc=$?
  echo "{\"set\": \"trace\", \"seed\": $seed, \"rc\": $rc, \"result\": $(tail -n 1 $out/run.out || echo null)}" >> $out/sets.jsonl
  grep "portbench:" $out/run.err | cut -c1-300
done
nvidia-smi --query-gpu=name,power.limit,clocks.sm,temperature.gpu --format=csv,noheader
