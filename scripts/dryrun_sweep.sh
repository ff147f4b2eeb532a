#!/bin/sh
# The dry run of all 40 (arch x shape) cells on meta tensors (no card
# needed): `python -m repro_torch.launch.dryrun --arch A` for each of the
# 10 archs, all at once, one process each. Records go to $DRYRUN_RESULTS
# (default results/dryrun_torch/), each arch's summary lines to
# <log dir>/dryrun_<arch>.log (default: the results directory).
#
#   sh scripts/dryrun_sweep.sh [log dir]
set -e
cd "$(dirname "$0")/.."
out="${DRYRUN_RESULTS:-results/dryrun_torch}"
logs="${1:-$out}"
mkdir -p "$out" "$logs"
archs=$(PYTHONPATH=src python3 -c "from repro_torch.configs import registry; print(' '.join(registry.REGISTRY))")
pids=""
for a in $archs; do
  PYTHONPATH=src python3 -m repro_torch.launch.dryrun --arch "$a" \
    > "$logs/dryrun_$a.log" 2>&1 &
  pids="$pids $!"
done
rc=0
for p in $pids; do wait "$p" || rc=1; done
cat "$logs"/dryrun_*.log
exit $rc
