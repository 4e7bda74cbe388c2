#!/usr/bin/env bash
# Data preparation with the PyTorch/CUDA port's tools
# (scripts/preprocess_data.sh for conformer_tpu_torch): collect
# LibriSpeech -> data.list (the arguments go on to collect_librispeech,
# e.g. --audio_ext wav), train BPE (external spm or HF tokenizers),
# convert vocab, compute global CMVN. Runs on the CPU.
set -euo pipefail
cd "$(dirname "$0")/.."

LIBRISPEECH=${LIBRISPEECH:-LibriSpeech/train-clean-100}
OUT=${OUT:-data/train-100}

python -m conformer_tpu_torch.tools.collect_librispeech \
    --data_dir "$LIBRISPEECH" --output_dir "$OUT" "$@"

# BPE vocab (pick one):
#   spm_train --input=$OUT/transcripts.txt --model_prefix=bpe_model \
#       --vocab_size=5000 --model_type=bpe
#   spm_export_vocab --model=bpe_model.model --output=bpe_model.vocab
#   python -m conformer_tpu_torch.tools.convert_vocab \
#       --spm_vocab bpe_model.vocab --output vocab.txt

python -m conformer_tpu_torch.tools.compute_cmvn_stats \
    --data_list "$OUT/data.list" --output "$OUT/global_cmvn"
