"""Convert a SentencePiece ``.vocab`` export to the framework's vocab.txt.

The export lists one piece per line (``<unk>``, ``<s>``, ``</s>`` first);
the output numbers ``<blank>`` 0, ``<unk>`` 1, then the pieces in order,
then ``<sos/eos>`` last.

    python -m conformer_tpu_torch.tools.convert_vocab \\
        --spm_vocab bpe_model.vocab --output vocab.txt
"""

from __future__ import annotations

import argparse


def convert(spm_vocab: str, output: str) -> int:
    """Write ``output``; returns the number of entries."""
    pieces = []
    with open(spm_vocab, encoding="utf-8") as f:
        for line in f:
            piece = line.split("\t")[0].strip()
            if piece not in ("<unk>", "<s>", "</s>", ""):
                pieces.append(piece)
    with open(output, "w", encoding="utf-8") as f:
        f.write("<blank> 0\n<unk> 1\n")
        for idx, piece in enumerate(pieces, start=2):
            f.write(f"{piece} {idx}\n")
        f.write(f"<sos/eos> {len(pieces) + 2}\n")
    return len(pieces) + 3


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spm_vocab", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)
    n = convert(args.spm_vocab, args.output)
    print(f"wrote {n} entries to {args.output}")


if __name__ == "__main__":
    main()
