"""Crawl a LibriSpeech split into a data.list JSONL.

Every ``*.trans.txt`` under the split gives transcripts by key; every audio
file with a transcript gives one ``{key, wav_path, transcript}`` line of
``data.list`` (sorted by path, absolute paths) and one line of
``transcripts.txt`` (the text alone, for BPE training).

    python -m conformer_tpu_torch.tools.collect_librispeech \\
        --data_dir LibriSpeech/train-clean-100 --output_dir data/train-100
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def collect(data_dir: str, output_dir: str, audio_ext: str = "flac") -> int:
    """Write ``output_dir``/{data.list, transcripts.txt}; returns the
    number of utterances."""
    os.makedirs(output_dir, exist_ok=True)
    transcripts: dict[str, str] = {}
    for trans_path in glob.glob(os.path.join(data_dir, "**", "*.trans.txt"), recursive=True):
        with open(trans_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    key, _, text = line.partition(" ")
                    transcripts[key] = text

    audio_files = sorted(glob.glob(os.path.join(data_dir, "**", f"*.{audio_ext}"),
                                   recursive=True))
    n = 0
    with open(os.path.join(output_dir, "data.list"), "w") as out, \
            open(os.path.join(output_dir, "transcripts.txt"), "w") as tr_out:
        for path in audio_files:
            key = os.path.splitext(os.path.basename(path))[0]
            text = transcripts.get(key)
            if text is None:
                continue
            out.write(json.dumps({"key": key, "wav_path": os.path.abspath(path),
                                  "transcript": text}) + "\n")
            tr_out.write(text + "\n")
            n += 1
    return n


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--audio_ext", default="flac", choices=["flac", "wav"])
    args = ap.parse_args(argv)
    n = collect(args.data_dir, args.output_dir, args.audio_ext)
    print(f"wrote {n} utterances to {args.output_dir}/data.list")


if __name__ == "__main__":
    main()
