#!/usr/bin/env bash
# Train the Conformer-M CTC+RNN-T recipe with the PyTorch/CUDA port
# (scripts/train.sh for conformer_tpu_torch): on the card unless
# "--device cpu" is among the arguments, which go on to main.
set -euo pipefail
cd "$(dirname "$0")/.."

CONFIG=${CONFIG:-configs/conformer_m.json}
CKPT_DIR=${CKPT_DIR:-experiments/conformer-m-rnnt-ctc}
mkdir -p "$CKPT_DIR"
cp "$CONFIG" "$CKPT_DIR/"

python -m conformer_tpu_torch.main \
    --config "$CONFIG" \
    --set train.checkpoint_dir="$CKPT_DIR" \
    --train \
    "$@"
