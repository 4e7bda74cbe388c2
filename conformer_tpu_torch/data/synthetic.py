"""A synthetic corpus, made from a seed, for smoke runs and tests of the
training path where no real corpus is at hand: speech-like wavs, JSONL
data lists and a '▁'-piece vocab of exactly ``vocab_size`` entries, which
the tokenizer segments by greedy longest match (no model file).

    python -m conformer_tpu_torch.data.synthetic OUT_DIR --train 40 --dev 8

The audio does not say its transcript: a model learns nothing from it, but
every stage of the pipeline, the losses and the WER run as on real data.
"""

from __future__ import annotations

import argparse
import json
import os
import string

import numpy as np

from .audio import save_wav

SAMPLE_RATE = 16000


def synthetic_wav(seed: int, seconds: float, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Seeded speech-like audio: harmonic tones whose pitch changes every
    120 ms, amplitude-modulated, over low noise; float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = np.repeat(rng.uniform(90, 260, n // 1920 + 1), 1920)[:n]
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(rng.uniform(0.05, 0.2) * np.sin(k * phase) for k in (1, 2, 3, 5))
    wav = wav * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(n)
    return np.clip(wav, -1, 1).astype(np.float32)


def write_recordings(out_dir: str, n: int = 4, seconds: float = 8.0, seed: int = 900) -> str:
    """``n`` seeded speech-like recordings of ``seconds`` s,
    ``out_dir``/sample_{i}.wav from seed ``seed + i``: a stand-in for the
    micro corpus tool's ``--samples`` (at the defaults, 64 segments of 0.5
    s, the trained micro fixture's vocabulary of 24). Returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n):
        save_wav(os.path.join(out_dir, f"sample_{i}.wav"), synthetic_wav(seed + i, seconds),
                 SAMPLE_RATE)
    return str(out_dir)


def synthetic_vocab(vocab_size: int, seed: int) -> list[str]:
    """<blank>, <unk>, every letter with and without '▁', random pieces of
    2-5 letters, <sos/eos>: ``vocab_size`` entries, index order."""
    letters = string.ascii_uppercase
    pieces = [*letters, *("▁" + c for c in letters)]
    n_rand = vocab_size - 3 - len(pieces)
    if n_rand < 0:
        raise ValueError(f"vocab_size must be at least {len(pieces) + 3}")
    rng = np.random.default_rng(seed)
    seen = set(pieces)
    while len(pieces) < vocab_size - 3:
        piece = "".join(rng.choice(list(letters), int(rng.integers(2, 6))))
        piece = ("▁" if rng.random() < 0.5 else "") + piece
        if piece not in seen:
            seen.add(piece)
            pieces.append(piece)
    return ["<blank>", "<unk>", *pieces, "<sos/eos>"]


def _transcript(rng: np.random.Generator, vocab: list[str], seconds: float) -> str:
    """About 2.5 words per second, each word one to three pieces."""
    starts = [p for p in vocab[2:-1] if p.startswith("▁")]
    inner = [p for p in vocab[2:-1] if not p.startswith("▁")]
    words = []
    for _ in range(max(1, int(round(2.5 * seconds)))):
        parts = [starts[int(rng.integers(len(starts)))]]
        parts += [inner[int(rng.integers(len(inner)))] for _ in range(int(rng.integers(0, 3)))]
        words.append("".join(parts)[1:])
    return " ".join(words)


def write_corpus(out_dir: str, *, seed: int = 0, n_train: int = 40, n_dev: int = 8,
                 seconds: tuple[float, float] = (2.0, 15.0), vocab_size: int = 5002) -> dict:
    """Write ``out_dir``/{vocab.txt, train.list, dev.list, wav/*.wav};
    returns their paths {vocab, train, dev}. Durations are uniform in
    ``seconds``."""
    os.makedirs(os.path.join(out_dir, "wav"), exist_ok=True)
    rng = np.random.default_rng(seed)
    vocab = synthetic_vocab(vocab_size, seed)
    paths = {k: os.path.join(out_dir, f) for k, f in
             (("vocab", "vocab.txt"), ("train", "train.list"), ("dev", "dev.list"))}
    with open(paths["vocab"], "w") as f:
        f.writelines(f"{p} {i}\n" for i, p in enumerate(vocab))
    for split, n in (("train", n_train), ("dev", n_dev)):
        with open(paths[split], "w") as f:
            for i in range(n):
                key = f"{split}-{i:05d}"
                secs = float(rng.uniform(*seconds))
                wav_path = os.path.join(out_dir, "wav", f"{key}.wav")
                save_wav(wav_path, synthetic_wav(int(rng.integers(2**31)), secs), SAMPLE_RATE)
                f.write(json.dumps({"key": key, "wav_path": wav_path,
                                    "transcript": _transcript(rng, vocab, secs)}) + "\n")
    return paths


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", type=int, default=40)
    ap.add_argument("--dev", type=int, default=8)
    ap.add_argument("--min_seconds", type=float, default=2.0)
    ap.add_argument("--max_seconds", type=float, default=15.0)
    ap.add_argument("--vocab_size", type=int, default=5002)
    a = ap.parse_args()
    print(json.dumps(write_corpus(a.out_dir, seed=a.seed, n_train=a.train, n_dev=a.dev,
                                  seconds=(a.min_seconds, a.max_seconds),
                                  vocab_size=a.vocab_size)))
