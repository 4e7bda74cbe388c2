"""Tokenization: vocab file, piece encoders and the transcript tokenizer
(the port's own copy of the JAX package's ``data/tokenizer.py``).

  - ``vocab.txt``: "piece idx" lines, <blank>=0, <unk>=1, <sos/eos>=last;
  - CJK characters are split out and kept whole; other text goes through
    a BPE/unigram ``.model`` (the SentencePiece runtime where installed,
    else the pure reader ``spm_reader.py``), an HF ``tokenizers`` JSON, a
    greedy longest match over a '▁'-piece vocab, or char splitting with
    ' ' -> '_';
  - non-lang-sym patterns ([x], <x>, {x}) pass through as single tokens.
"""

from __future__ import annotations

import re
from typing import Protocol, Sequence

_CJK = re.compile(r"([一-鿿])")
_NON_LANG = re.compile(r"(\[[^\[\]]+\]|<[^<>]+>|{[^{}]+})")


def load_vocab(path: str) -> dict[str, int]:
    """``piece idx`` lines -> {piece: idx}."""
    vocab: dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            word, idx = line.split(" ")
            vocab[word] = int(idx)
    return vocab


def save_vocab(vocab: dict[str, int], path: str) -> None:
    with open(path, "w") as f:
        for word, idx in sorted(vocab.items(), key=lambda kv: kv[1]):
            f.write(f"{word} {idx}\n")


class PieceEncoder(Protocol):
    def encode_as_pieces(self, text: str) -> list[str]: ...
    def decode_pieces(self, pieces: Sequence[str]) -> str: ...


class SentencePieceEncoder:
    """The SentencePiece C++ runtime, where the package is installed."""

    def __init__(self, model_path: str):
        import sentencepiece as spm

        self._sp = spm.SentencePieceProcessor()
        self._sp.load(model_path)

    def encode_as_pieces(self, text: str) -> list[str]:
        return self._sp.encode_as_pieces(text)

    def decode_pieces(self, pieces: Sequence[str]) -> str:
        return self._sp.decode_pieces(list(pieces))


class HFTokenizersEncoder:
    """A BPE ``tokenizer.json`` through HF ``tokenizers``, where installed."""

    def __init__(self, tokenizer_json: str):
        from tokenizers import Tokenizer as HFTokenizer

        self._tok = HFTokenizer.from_file(tokenizer_json)

    def encode_as_pieces(self, text: str) -> list[str]:
        return self._tok.encode(text).tokens

    def decode_pieces(self, pieces: Sequence[str]) -> str:
        return "".join(pieces).replace("▁", " ").strip()


class CharEncoder:
    """Characters; spaces become '_'."""

    def encode_as_pieces(self, text: str) -> list[str]:
        return ["_" if ch == " " else ch for ch in text]

    def decode_pieces(self, pieces: Sequence[str]) -> str:
        return "".join(pieces).replace("_", " ")


class GreedyVocabEncoder:
    """SentencePiece-style segmentation from the vocab alone (no model
    file): greedy longest match of '▁'-prefixed words over the vocab. Every
    emitted piece is in the vocab (an unknown character is emitted alone
    and maps to <unk>), and decode(encode(text)) == text for in-vocab
    words; it need not equal the trained merges."""

    def __init__(self, vocab: dict[str, int]):
        self._vocab = vocab
        self._max_len = max(len(k) for k in vocab)

    def encode_as_pieces(self, text: str) -> list[str]:
        out: list[str] = []
        for word in text.split():
            s = "▁" + word
            i = 0
            while i < len(s):
                j = min(len(s), i + self._max_len)
                while j > i and s[i:j] not in self._vocab:
                    j -= 1
                if j == i:
                    out.append(s[i])
                    i += 1
                else:
                    out.append(s[i:j])
                    i = j
        return out

    def decode_pieces(self, pieces: Sequence[str]) -> str:
        return "".join(pieces).replace("▁", " ").strip()


def make_piece_encoder(bpe_model: str | None) -> PieceEncoder:
    """Chars without a model; an HF ``.json``; a ``.model`` through the
    SentencePiece runtime, or through the pure reader where it is absent."""
    if bpe_model is None:
        return CharEncoder()
    if bpe_model.endswith(".json"):
        return HFTokenizersEncoder(bpe_model)
    try:
        return SentencePieceEncoder(bpe_model)
    except ImportError:
        from .spm_reader import PureSentencePieceEncoder

        return PureSentencePieceEncoder(bpe_model)


class Tokenizer:
    """Transcript -> (tokens, label ids), and ids -> text."""

    def __init__(
        self,
        vocab: dict[str, int],
        bpe_model: str | None = None,
        non_lang_syms: Sequence[str] | None = None,
        split_with_space: bool = False,
    ):
        self.vocab = vocab
        self.inv_vocab = {i: w for w, i in vocab.items()}
        if bpe_model is None and any(w.startswith("▁") for w in vocab):
            # a '▁'-piece vocab without a model file: char splitting would
            # never hit its pieces
            self.encoder: PieceEncoder = GreedyVocabEncoder(vocab)
            self.use_bpe = True
        else:
            self.encoder = make_piece_encoder(bpe_model)
            self.use_bpe = bpe_model is not None
        self.non_lang_syms = set(non_lang_syms or ())
        self.split_with_space = split_with_space
        self.unk_id = vocab.get("<unk>")

    def text_to_tokens(self, transcript: str) -> list[str]:
        if self.non_lang_syms:
            parts = [w for w in _NON_LANG.split(transcript.upper()) if w.strip()]
        else:
            parts = [transcript]
        tokens: list[str] = []
        for part in parts:
            if part in self.non_lang_syms:
                tokens.append(part)
                continue
            for piece in (w for w in _CJK.split(part.upper()) if w.strip()):
                if _CJK.fullmatch(piece):
                    tokens.append(piece)
                elif self.use_bpe:
                    tokens.extend(self.encoder.encode_as_pieces(piece))
                elif self.split_with_space:
                    tokens.extend(w for w in piece.split(" ") if w)
                else:
                    tokens.extend("_" if ch == " " else ch for ch in piece)
        return tokens

    def tokens_to_ids(self, tokens: Sequence[str]) -> list[int]:
        out = []
        for tok in tokens:
            if tok in self.vocab:
                out.append(self.vocab[tok])
            elif self.unk_id is not None:
                out.append(self.unk_id)
        return out

    def encode(self, transcript: str) -> tuple[list[str], list[int]]:
        tokens = self.text_to_tokens(transcript)
        return tokens, self.tokens_to_ids(tokens)

    def decode_ids(self, ids: Sequence[int], stop_id: int | None = None) -> str:
        """ids -> text: cut at ``stop_id``, drop <blank> and <unk>, join."""
        pieces = []
        for i in ids:
            if stop_id is not None and i == stop_id:
                break
            piece = self.inv_vocab.get(int(i))
            if piece is None or piece in ("<blank>", "<unk>"):
                continue
            pieces.append(piece)
        return self.encoder.decode_pieces(pieces)

