"""Offline data tools: data lists of a LibriSpeech tree, global CMVN
statistics, vocab conversion and the golden fbank signals (the port's own
copies of the JAX package's ``tools``, with their flags, defaults and file
formats). Each runs as ``python -m conformer_tpu_torch.tools.<name>``."""
