#!/bin/sh
# GPU-backend experiment driver of the PyTorch port, with the same
# 14-positional-parameter surface as the reference's shadow/run.sh
# (run.sh:23-38) and as scripts/run_tpu.sh: the whole network runs as one
# PyTorch program on a CUDA card (pass --device cpu after the positionals
# for the CPU); latencies<i> files and summaries come out in the same
# format (the reference's summary_latency*.awk run unchanged on them).
#
# Example (matches shadow/run.sh:19):
#   ./scripts/run_gpu.sh 1 1000 15000 1 10 50 150 40 130 5 0.0 4 0 4000
set -e

if [ $# -lt 14 ]; then
    echo "Usage: $0 <runs> <nodes> <message_size> <num_fragment> <num_publishers>
            <min_bandwidth> <max_bandwidth> <min_latency> <max_latency> <anchor_stages>
            <packet_loss> <publisher_id> <publisher_rotation> <inter_message_delay> [extra flags]"
    echo "$0 1 1000 15000 1 10 50 150 40 130 5 0.0 4 0 4000"
    exit 1
fi

PYTHON=$(command -v python3 || command -v python)
ROOT=$(dirname "$0")/..

rm -f shadowlog* latencies* stats*

PYTHONPATH="$ROOT" exec "$PYTHON" -m dst_libp2p_test_node_tpu_torch run "$@" --stats-json
