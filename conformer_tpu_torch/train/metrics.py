"""Word error rate (the port's own copy of the JAX package's
``train/metrics.py``)."""

from __future__ import annotations

from typing import Sequence


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Levenshtein distance over token sequences (words)."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


class WordErrorRate:
    """Accumulating WER: total edits / total reference words."""

    def __init__(self) -> None:
        self.errors = 0
        self.total = 0

    def update(self, preds: Sequence[str], refs: Sequence[str]) -> None:
        for pred, ref in zip(preds, refs):
            ref_words = ref.split()
            self.errors += edit_distance(ref_words, pred.split())
            self.total += len(ref_words)

    def compute(self) -> float:
        return self.errors / max(self.total, 1)

    def reset(self) -> None:
        self.errors = 0
        self.total = 0
