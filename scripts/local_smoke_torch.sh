#!/bin/sh
# Local end-to-end smoke of the PyTorch port's node service, the twin of
# scripts/local_smoke.sh: one `serve` process hosts the simulated network;
# the `inject` publisher controller drives /publish; we assert latency
# lines, /metrics and /health came out the reference-shaped way.
# SIMPLATFORM=cpu (the default here, as in local_smoke.sh) runs it with
# --device cpu; SIMPLATFORM=gpu on the card.
#
# Usage: ./scripts/local_smoke_torch.sh  (exits 0 on success)
set -e

ROOT=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH="$ROOT:$PYTHONPATH"
PYTHON=$(command -v python3 || command -v python)
DIR=$(mktemp -d)
trap 'kill $SERVE_PID 2>/dev/null || true; rm -rf "$DIR"' EXIT

CONTROL_PORT=${CONTROL_PORT:-18645}
METRICS_PORT=${METRICS_PORT:-18008}
DEVICE=""
[ "${SIMPLATFORM:-cpu}" = cpu ] && DEVICE="--device cpu"

# -u: unbuffered stdout: the latency-line check below reads serve.log
# after a SIGTERM, which would otherwise lose block-buffered output
PEERS=50 CONNECTTO=6 MUXER=yamux \
  "$PYTHON" -u -m dst_libp2p_test_node_tpu_torch serve $DEVICE \
  --control-port "$CONTROL_PORT" --metrics-port "$METRICS_PORT" \
  --warmup-s 10 --tick-s 0.2 --time-scale 5 --duration-s 60 \
  > "$DIR/serve.log" 2>&1 &
SERVE_PID=$!

# wait for /ready (the k8s readiness contract)
READY=0
for i in $(seq 1 120); do
    if curl -sf "http://127.0.0.1:$CONTROL_PORT/ready" >/dev/null 2>&1; then
        READY=1
        break
    fi
    kill -0 $SERVE_PID 2>/dev/null || { echo "serve died:"; cat "$DIR/serve.log"; exit 1; }
    sleep 1
done
[ "$READY" = 1 ] || { echo "FAIL /ready timeout:"; tail "$DIR/serve.log"; exit 1; }
curl -sf "http://127.0.0.1:$CONTROL_PORT/health" >/dev/null || { echo "FAIL /health"; exit 1; }

# inject's status captured explicitly: under `set -e` a bare failing
# command would abort before the diagnostic below could print
if ! "$PYTHON" -m dst_libp2p_test_node_tpu_torch inject "127.0.0.1:$CONTROL_PORT" \
    -s 2000 -m 3 -d 1.0 > "$DIR/inject.log"; then
    echo "FAIL publish:"; cat "$DIR/inject.log"; exit 1
fi
grep -q '"status": "success"' "$DIR/inject.log" || { echo "FAIL publish"; cat "$DIR/inject.log"; exit 1; }

# give the pump a couple of ticks to drain and emit
sleep 3
curl -sf "http://127.0.0.1:$METRICS_PORT/metrics" > "$DIR/metrics.txt"
grep -q '^dst_testnode_publish_requests_total' "$DIR/metrics.txt" || { echo "FAIL metrics names"; exit 1; }
grep -q '^libp2p_gossipsub_peers_per_topic_mesh' "$DIR/metrics.txt" || { echo "FAIL libp2p metrics"; exit 1; }

kill $SERVE_PID 2>/dev/null || true
wait $SERVE_PID 2>/dev/null || true

# the stdout contract: one "<msgId> milliseconds: <ms>" line per receiver
LINES=$(grep -c ' milliseconds: ' "$DIR/serve.log" || true)
[ "$LINES" -ge 50 ] || { echo "FAIL latency lines ($LINES)"; head "$DIR/serve.log"; exit 1; }

echo "local smoke OK: $LINES latency lines, metrics + health + publish verified"
