#!/usr/bin/env bash
# Train a preset on the card and run the analysis tools on its checkpoint,
# in one process tree (a checkpoint lives in a temporary workdir, gone
# with the machine):
#
#   bash scripts/torch_analysis_runs.sh u28 [OUT]   # canonical_uniform28 to
#       20,000 steps (seed 0), its overlap-error bins, the supervised
#       ceiling at 30,000 steps, the overlap characterization, the parity
#       check at canonical batch 16
#   bash scripts/torch_analysis_runs.sh iwae [OUT]  # iwae_trained to
#       10,000 steps (seed 0), the IWAE k-sweep at k = 1, 5, 25 and 64
#
# Each tool's output (and its wall, on the host's clock) goes to
# OUT (default chiprun_out/analysis) beside the card's name and power limit.
set -euo pipefail
cd "$(dirname "$0")/.."
what=${1:?u28 or iwae}
out=${2:-chiprun_out/analysis}
mkdir -p "$out"
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT

step() {        # step NAME COMMAND...: run it, its output and wall to OUT
    local name=$1 t0
    shift
    t0=$(date +%s.%N)
    "$@" > "$out/$name.log" 2>&1
    echo "$name: $(awk "BEGIN {print $(date +%s.%N) - $t0}") s wall" \
        | tee -a "$out/walls.txt"
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    | tee "$out/card.txt"
case $what in
u28)
    step u28_train python3 -m attend_infer_repeat_torch.train \
        --config canonical_uniform28 --iters 20000 --seed 0 \
        --workdir "$work/u28" --no-tensorboard
    step u28_overlap_errors python3 scripts/torch_analyze_overlap_errors.py \
        --config canonical_uniform28 --workdir "$work/u28" --train-seed 0 \
        --out "$out/u28_overlap_errors.json"
    step supervised_ceiling python3 scripts/torch_supervised_ceiling.py \
        --out "$out/supervised_ceiling_u28.json"
    step overlap_characterization \
        python3 scripts/torch_characterize_overlap.py \
        --out "$out/overlap_characterization.json"
    step parity_canonical python3 scripts/torch_parity_check.py
    ;;
iwae)
    step iwae_trained_train python3 -m attend_infer_repeat_torch.train \
        --config iwae_trained --iters 10000 --seed 0 \
        --workdir "$work/iwae" --no-tensorboard
    step iwae_ksweep python3 scripts/torch_iwae_ksweep.py \
        --config iwae_trained --workdir "$work/iwae"
    step iwae_ksweep_64 python3 scripts/torch_iwae_ksweep.py \
        --config iwae_trained --workdir "$work/iwae" --ks 64
    ;;
*)
    echo "unknown run $what (u28 or iwae)" >&2
    exit 2
    ;;
esac
