"""Pure-Python SentencePiece ``.model`` reader and encoder (the port's own
copy of the JAX package's ``data/spm_reader.py``).

Training and serving read a BPE/unigram ``.model`` with the SentencePiece
C++ runtime where it is installed; the machine with the card has neither
it nor HF ``tokenizers``, so this module reads the ``.model`` protobuf
directly (a minimal wire-format walker, no protobuf runtime) and
reimplements the two segmenters that matter:

  - unigram (spm_train default): Viterbi segmentation maximizing the sum
    of piece log-probs;
  - bpe: greedy merge of the best-scoring adjacent pair (scores in BPE
    models encode merge rank as -rank).

Normalization is the identity plus whitespace handling (add_dummy_prefix,
'▁' replacement, collapsed runs); NFKC tables are skipped, which is
exact for ASCII corpora such as LibriSpeech.

ModelProto schema (the fields used here):
  field 1 (repeated) SentencePiece { 1: piece (string), 2: score (float),
                                     3: type (enum) }
  field 2 TrainerSpec { 3: model_type (enum: 1=unigram, 2=bpe, 3=word,
                                       4=char) }
"""

from __future__ import annotations

import struct
from typing import Iterator, Sequence

_SPACE = "▁"  # '▁'

# SentencePiece.Type values
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _walk(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:                     # 64-bit
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        elif wire == 2:                     # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                     # 32-bit
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")


def parse_model(path: str) -> tuple[list[tuple[str, float, int]], int]:
    """Read a .model file -> ([(piece, score, type)], model_type)."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces: list[tuple[str, float, int]] = []
    model_type = 1  # unigram default (spm_train default)
    for field, wire, val in _walk(buf):
        if field == 1 and wire == 2:        # SentencePiece submessage
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _walk(val):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            pieces.append((piece, score, ptype))
        elif field == 2 and wire == 2:      # TrainerSpec
            for f2, w2, v2 in _walk(val):
                if f2 == 3 and w2 == 0:
                    model_type = v2
    return pieces, model_type


class PureSentencePieceEncoder:
    """encode_as_pieces / decode_pieces compatible with the C++ runtime
    for unigram and BPE models (the ``tokenizer.PieceEncoder`` protocol)."""

    def __init__(self, model_path: str):
        pieces, model_type = parse_model(model_path)
        self.model_type = model_type
        self.scores: dict[str, float] = {}
        self.unk_piece = "<unk>"
        self.max_piece_len = 1
        # --byte_fallback models carry 256 BYTE-type pieces "<0xNN>"; they
        # are fallback codes, NOT text (literal input "<0x41>" must not
        # match them), so they live in a separate table keyed by byte value.
        self.byte_pieces: dict[int, str] = {}
        for piece, score, ptype in pieces:
            if ptype in (CONTROL, UNUSED):
                continue
            if ptype == UNKNOWN:
                self.unk_piece = piece
                continue
            if ptype == BYTE:
                if (piece.startswith("<0x") and piece.endswith(">")
                        and len(piece) == 6):
                    self.byte_pieces[int(piece[3:5], 16)] = piece
                continue
            self.scores[piece] = score
            if len(piece) > self.max_piece_len:
                self.max_piece_len = len(piece)

    # -- normalization ------------------------------------------------
    @staticmethod
    def _normalize(text: str) -> str:
        text = " ".join(text.split())       # collapse whitespace runs
        if not text:
            return ""
        return _SPACE + text.replace(" ", _SPACE)

    # -- segmenters ---------------------------------------------------
    def _viterbi(self, text: str) -> list[str]:
        n = len(text)
        # best[i]: (score, backpointer start) for prefix of length i
        neg = -1e18
        best = [neg] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores.values(), default=0.0) - 10.0
        for i in range(n):
            if best[i] <= neg:
                continue
            hi = min(n, i + self.max_piece_len)
            for j in range(i + 1, hi + 1):
                s = self.scores.get(text[i:j])
                if s is not None and best[i] + s > best[j]:
                    best[j] = best[i] + s
                    back[j] = i
            # unknown single char fallback
            if best[i] + unk_penalty > best[i + 1]:
                best[i + 1] = best[i] + unk_penalty
                back[i + 1] = i
        out: list[str] = []
        j = n
        while j > 0:
            i = back[j]
            out.append(text[i:j])
            j = i
        return out[::-1]

    def _bpe(self, text: str) -> list[str]:
        symbols = list(text)
        while len(symbols) > 1:
            best_idx, best_score = -1, None
            for i in range(len(symbols) - 1):
                merged = symbols[i] + symbols[i + 1]
                s = self.scores.get(merged)
                if s is not None and (best_score is None or s > best_score):
                    best_idx, best_score = i, s
            if best_idx < 0:
                break
            symbols[best_idx:best_idx + 2] = [
                symbols[best_idx] + symbols[best_idx + 1]
            ]
        return symbols

    def _fallback(self, piece: str) -> list[str]:
        """Out-of-vocab segment -> byte pieces (byte-fallback models, like
        the C++ runtime) or the unk piece."""
        if self.byte_pieces:
            out = []
            for byte in piece.encode("utf-8"):
                out.append(self.byte_pieces.get(byte, self.unk_piece))
            return out
        return [self.unk_piece]

    # -- public API -----------------------------------------------------
    def encode_as_pieces(self, text: str) -> list[str]:
        norm = self._normalize(text)
        if not norm:
            return []
        if self.model_type == 2:
            pieces = self._bpe(norm)
        else:
            pieces = self._viterbi(norm)
        out: list[str] = []
        for p in pieces:
            if p in self.scores:
                out.append(p)
            else:
                out.extend(self._fallback(p))
        return out

    def decode_pieces(self, pieces: Sequence[str]) -> str:
        # reassemble byte-fallback runs before joining
        out: list[str] = []
        byte_run: list[int] = []
        inv_bytes = {v: k for k, v in self.byte_pieces.items()}

        def flush():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run.clear()

        for p in pieces:
            if p in inv_bytes:
                byte_run.append(inv_bytes[p])
            else:
                flush()
                out.append(p)
        flush()
        return "".join(out).replace(_SPACE, " ").strip()
