#!/usr/bin/env bash
# Evaluate (WER on the test list) with the latest checkpoint, with the
# PyTorch/CUDA port (scripts/eval.sh for conformer_tpu_torch); the
# arguments go on to main.
set -euo pipefail
cd "$(dirname "$0")/.."

CONFIG=${CONFIG:-configs/conformer_m.json}
CKPT_DIR=${CKPT_DIR:-experiments/conformer-m-rnnt-ctc}

python -m conformer_tpu_torch.main \
    --config "$CONFIG" \
    --set train.checkpoint_dir="$CKPT_DIR" \
    --eval --resume --resume_from "$CKPT_DIR" \
    "$@"
