"""Write the golden Kaldi fbank and MFCC fixture with torchaudio.

``torchaudio.compliance.kaldi`` is the ground truth the recipe's features
follow; torchaudio is imported only in ``main``, which raises ImportError
naming it where it is not installed. On a machine that has it, run

    python -m conformer_tpu_torch.tools.gen_golden_fbank \\
        --out tests/fixtures/fbank_golden.npz

and commit the file. The input signals are made here from a legacy
``RandomState``, which is bit-stable across numpy versions, so a test
regenerates exactly the signals the fixture was made from.
"""

from __future__ import annotations

import argparse

import numpy as np


def golden_signals(sample_rate: int = 16000) -> dict[str, np.ndarray]:
    """Three signals of 0.45 s (a tone, a chirp, their mix with noise),
    already scaled by 2**15, float32."""
    t = np.arange(int(0.45 * sample_rate), dtype=np.float64) / sample_rate
    tone = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    chirp = 0.4 * np.sin(2 * np.pi * (200.0 + 4000.0 * t) * t)
    noise = 0.1 * np.random.RandomState(1234).standard_normal(len(t))
    return {
        "tone": (tone * (1 << 15)).astype(np.float32),
        "chirp": (chirp * (1 << 15)).astype(np.float32),
        "mix": ((tone + chirp + noise) * (1 << 15)).astype(np.float32),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="tests/fixtures/fbank_golden.npz")
    args = ap.parse_args(argv)
    try:
        import torch
        import torchaudio.compliance.kaldi as kaldi
    except ImportError as e:
        raise ImportError(f"gen_golden_fbank needs torchaudio, which is not installed "
                          f"({e})") from e

    out: dict[str, np.ndarray] = {}
    for name, wav in golden_signals().items():
        wf = torch.from_numpy(wav[None, :])
        out[f"fbank_{name}"] = kaldi.fbank(
            wf, num_mel_bins=80, frame_length=25, frame_shift=10,
            dither=0.0, energy_floor=0.0, sample_frequency=16000,
        ).numpy()
        out[f"mfcc_{name}"] = kaldi.mfcc(
            wf, num_mel_bins=23, num_ceps=13, frame_length=25,
            frame_shift=10, dither=0.0, energy_floor=0.0,
            sample_frequency=16000,
        ).numpy()
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {sorted(out)}")


if __name__ == "__main__":
    main()
