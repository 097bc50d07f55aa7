#!/bin/bash
# Figure-reproduction driver — parity with the reference's
# base_results/rerun-experiments.sh: re-runs the sweep experiments and
# regenerates every figure from their data (measurements/data/).
#
# Usage:  bash measurements/rerun-experiments.sh [cpu|gpu]
#   cpu: validation-scale sweeps on the CPU backend (fast, no GPU needed)
#   gpu: full sweeps on one GPU (each CLI run is its own process, so run
#        nothing else on the card meanwhile)
set -e
cd "$(dirname "$0")/.."
MODE=${1:-gpu}

if [ "$MODE" = cpu ]; then
    python measurements/run.py quick
    python measurements/run.py scaling
else
    HBRJ_SWEEP_R=16000000 HBRJ_SWEEP_S=128000000 \
        python measurements/run.py algos
    python measurements/run.py algos_b      # workload B: 128M x 128M
    HBRJ_SWEEP_R=16000000 HBRJ_SWEEP_S=128000000 \
        python measurements/run.py bloom
    python measurements/run.py params
    HBRJ_SWEEP_R=8000000 HBRJ_SWEEP_S=64000000 \
        python measurements/run.py scaling
    python measurements/run.py dist_bloom
fi
python measurements/plot_basics.py all
