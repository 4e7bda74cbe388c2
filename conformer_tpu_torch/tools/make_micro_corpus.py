"""A micro speech corpus with held-out eval utterances, built from a few
recordings (the port's copy of the JAX package's
``tools/make_micro_corpus.py``; the same files, byte for byte, from the
same recordings and seed).

The reference shipped four recordings of about 33 s in all, with no
transcripts. To get a real, non-overfit WER out of so little audio, the
tool builds a compositional recognition task from them:

  1. Slice the recordings into fixed-length SEGMENTS (default 0.5 s) and
     give each voiced segment a word of a fixed English word list: the
     segment IS the acoustic form of its word.
  2. TRAIN utterances: random sequences of 2-4 segments, joined with a
     short crossfade, each rendered under seeded augmentation (gain,
     additive noise, speed perturbation).
  3. EVAL utterances: segment orders never seen in training, rendered
     under augmentation (noise seeds, speeds, gains) disjoint from the
     train set's. Every eval waveform is novel audio: an unseen word order
     and unseen acoustics.

A model with a low WER here recognizes each word's acoustic form in new
contexts: closed-vocabulary generalization, scaled to the audio at hand
(not open-vocabulary or unseen-speaker generalization).

The recordings are not in this repository: name their directory with
``--samples`` (any directory of mono wavs of one sample rate).

    python -m conformer_tpu_torch.tools.make_micro_corpus --out build/micro \\
        --samples DIR
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.audio import load_audio, save_wav, speed_perturb

# 96 common short words; segment i is labelled WORDS[i]. Real words (shared
# character n-grams) keep the character-level task non-trivial.
WORDS = (
    "the of and to in is was he for it with as his on be at by had not are "
    "but from or have an they which one you were her all she there would "
    "their we him been has when who will more no if out so said what up its "
    "about into than them can only other new some could time these two may "
    "then do first any my now such like our over man me even most made "
    "after also did many before must through back years where much your way "
    "well down should because each just those people"
).split()


def _crossfade_concat(parts: list[np.ndarray], sr: int, fade_ms: float = 5.0):
    """Concatenate with a linear crossfade, against splice clicks."""
    n_fade = int(sr * fade_ms / 1000.0)
    out = parts[0].astype(np.float32).copy()
    ramp = np.linspace(0.0, 1.0, n_fade, dtype=np.float32)
    for p in parts[1:]:
        p = p.astype(np.float32)
        out[-n_fade:] = out[-n_fade:] * (1.0 - ramp) + p[:n_fade] * ramp
        out = np.concatenate([out, p[n_fade:]])
    return out


def _augment(wav: np.ndarray, sr: int, rng: np.random.Generator,
             speeds: tuple[float, ...]) -> np.ndarray:
    """Seeded augmentation: speed perturbation, gain, additive noise at an
    SNR drawn from [25, 40] dB."""
    speed = speeds[rng.integers(len(speeds))]
    if speed != 1.0:
        wav = speed_perturb(wav, sr, speed)
    gain = rng.uniform(0.7, 1.3)
    wav = wav * gain
    snr_db = rng.uniform(25.0, 40.0)
    sig_pow = float(np.mean(wav**2)) + 1e-12
    noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
    wav = wav + rng.standard_normal(len(wav)).astype(np.float32) * np.sqrt(noise_pow)
    return np.clip(wav, -1.0, 1.0).astype(np.float32)


def build_micro_corpus(
    out_dir: str,
    samples_dir: str,
    *,
    seg_s: float = 0.5,
    n_train: int = 600,
    n_eval: int = 80,
    seed: int = 0,
) -> dict:
    """Build the corpus from the wavs of ``samples_dir`` (sorted by name):
    ``wav/``, ``train.list``, ``eval.list``, ``vocab.txt`` and
    ``meta.json`` under ``out_dir``; returns the meta. Deterministic in
    ``seed``."""
    os.makedirs(out_dir, exist_ok=True)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)

    # ---- 1. segments ------------------------------------------------------
    segments: list[np.ndarray] = []
    sr0 = None
    for fname in sorted(os.listdir(samples_dir)):
        if not fname.endswith(".wav"):
            continue
        wav, sr = load_audio(os.path.join(samples_dir, fname))
        sr0 = sr0 or sr
        if sr != sr0:
            raise ValueError(f"{fname}: {sr} Hz, the recordings before it {sr0} Hz")
        n_seg = int(sr * seg_s)
        for k in range(len(wav) // n_seg):
            segments.append(wav[k * n_seg : (k + 1) * n_seg])
    # drop near-silent segments (no acoustic identity to learn)
    rms = np.asarray([float(np.sqrt(np.mean(s**2))) for s in segments])
    keep = rms > 0.25 * np.median(rms)
    segments = [s for s, k in zip(segments, keep) if k]
    segments = segments[: len(WORDS)]
    # upper case: the tokenizer upper-cases transcripts (data/tokenizer.py),
    # so lower-case vocab characters would all map to <unk>
    words = [w.upper() for w in WORDS[: len(segments)]]

    # ---- 2/3. utterance orders: train and DISJOINT eval -------------------
    rng = np.random.default_rng(seed)
    n_segs = len(segments)

    def draw_order(r):
        length = int(r.integers(2, 5))
        return tuple(r.choice(n_segs, size=length, replace=False).tolist())

    train_orders: list[tuple[int, ...]] = []
    seen = set()
    while len(train_orders) < n_train:
        o = draw_order(rng)
        train_orders.append(o)
        seen.add(o)
    eval_orders: list[tuple[int, ...]] = []
    while len(eval_orders) < n_eval:
        o = draw_order(rng)
        if o not in seen:          # a novel word order, never trained
            eval_orders.append(o)
            seen.add(o)

    # augmentation streams: disjoint seed spaces and speed sets
    train_speeds = (0.9, 1.0, 1.1)
    eval_speeds = (0.95, 1.05)     # speeds never seen in training

    def render(split: str, orders, speeds, seed_base: int):
        entries = []
        for i, order in enumerate(orders):
            utt = _crossfade_concat([segments[j] for j in order], sr0)
            arng = np.random.default_rng(seed_base + i)
            utt = _augment(utt, sr0, arng, speeds)
            path = os.path.join(wav_dir, f"{split}_{i}.wav")
            save_wav(path, utt, sr0)
            entries.append({"key": f"{split}_{i}", "wav_path": path,
                            "transcript": " ".join(words[j] for j in order)})
        lst = os.path.join(out_dir, f"{split}.list")
        with open(lst, "w") as f:
            for e in entries:
                f.write(json.dumps(e) + "\n")
        return lst

    train_list = render("train", train_orders, train_speeds, seed_base=10_000)
    eval_list = render("eval", eval_orders, eval_speeds, seed_base=20_000_000)

    # ---- character vocab over the word list -------------------------------
    chars = sorted(set("".join(words)))
    vocab = {"<blank>": 0, "<unk>": 1, "_": 2}
    for c in chars:
        vocab[c] = len(vocab)
    vocab["<sos/eos>"] = len(vocab)
    vocab_path = os.path.join(out_dir, "vocab.txt")
    with open(vocab_path, "w") as f:
        for w, i in vocab.items():
            f.write(f"{w} {i}\n")

    meta = {
        "n_segments": n_segs,
        "seg_s": seg_s,
        "n_train": n_train,
        "n_eval": n_eval,
        "vocab_size": len(vocab),
        "train_list": train_list,
        "eval_list": eval_list,
        "vocab_path": vocab_path,
        "words": words,
        "seed": seed,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--samples", required=True,
                    help="directory of the recordings (wav, one sample rate)")
    ap.add_argument("--n-train", type=int, default=600)
    ap.add_argument("--n-eval", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    meta = build_micro_corpus(args.out, args.samples, n_train=args.n_train,
                              n_eval=args.n_eval, seed=args.seed)
    print(json.dumps({k: v for k, v in meta.items() if k != "words"}, indent=1))


if __name__ == "__main__":
    main()
