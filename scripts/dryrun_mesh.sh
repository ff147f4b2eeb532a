#!/bin/sh
# The dry run of LM cells' sharded steps on the (16, 16) and (2, 16, 16)
# production meshes: `python -m repro_torch.launch.dryrun --mesh both
# --arch A --shape S` for each cell, all at once, one process each (a
# fake process group of 256 or 512 ranks in each, on meta tensors: no
# card needed; a full-size cell takes minutes and GBs of host memory,
# so run it on a large host). Records go to $DRYRUN_RESULTS (default
# results/dryrun_torch/), each cell's summary lines to
# <log dir>/mesh_<arch>_<shape>.log (default: the results directory).
# The default cells are the four of tests/test_dryrun_small.py and
# nemotron-4-340b's sequence-parallel train_4k.
#
#   sh scripts/dryrun_mesh.sh [log dir] [arch:shape ...]
set -e
cd "$(dirname "$0")/.."
out="${DRYRUN_RESULTS:-results/dryrun_torch}"
logs="${1:-$out}"
[ $# -gt 0 ] && shift
cells="${*:-minitron-4b:train_4k deepseek-v2-236b:train_4k gemma3-4b:decode_32k mamba2-370m:train_4k nemotron-4-340b:train_4k}"
mkdir -p "$out" "$logs"
pids=""
for c in $cells; do
  a=${c%%:*}
  s=${c##*:}
  PYTHONPATH=src python3 -m repro_torch.launch.dryrun --mesh both \
    --arch "$a" --shape "$s" > "$logs/mesh_${a}_${s}.log" 2>&1 &
  pids="$pids $!"
done
rc=0
for p in $pids; do wait "$p" || rc=1; done
grep -h '^\[pod' "$logs"/mesh_*.log
exit $rc
