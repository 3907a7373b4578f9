"""Corpus BLEU: the port's copy of the n-gram counting BLEU of
``s2st_tpu/scoring/__init__.py`` (:94-185, :209-219).

``--scoring bleu`` and ``--scoring sacrebleu`` both take this scorer. It
splits on whitespace and counts clipped n-gram matches up to 4 with the
brevity penalty, with no tokenizer: the JAX package computes the same
numbers when the ``sacrebleu`` package is absent, and the port never uses
that package.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n])
                   for i in range(len(tokens) - n + 1))


def corpus_bleu_counts(refs: List[List[str]], hyps: List[List[str]],
                       max_n: int = 4):
    """Clipped n-gram matches and totals per order, and the corpus's
    reference and hypothesis lengths."""
    match, total = [0] * max_n, [0] * max_n
    ref_len = hyp_len = 0
    for ref, hyp in zip(refs, hyps):
        ref_len += len(ref)
        hyp_len += len(hyp)
        for n in range(1, max_n + 1):
            h, r = _ngrams(hyp, n), _ngrams(ref, n)
            total[n - 1] += max(len(hyp) - n + 1, 0)
            match[n - 1] += sum(min(c, r[g]) for g, c in h.items())
    return match, total, ref_len, hyp_len


def bleu_from_counts(match, total, ref_len: int, hyp_len: int) -> float:
    logs = 0.0
    for m, t in zip(match, total):
        if t == 0 or m == 0:
            return 0.0
        logs += math.log(m / t)
    bp = min(0.0, 1.0 - ref_len / hyp_len) if hyp_len > 0 else -9999.0
    return 100.0 * math.exp(logs / len(match) + bp)


class BleuScorer:
    def __init__(self):
        self.refs: List[str] = []
        self.hyps: List[str] = []

    def add_string(self, ref: str, pred: str) -> None:
        self.refs.append(ref)
        self.hyps.append(pred)

    def score(self) -> float:
        return bleu_from_counts(*corpus_bleu_counts(
            [r.split() for r in self.refs], [h.split() for h in self.hyps]))

    def result_string(self) -> str:
        return f"BLEU4 = {self.score():.2f}"


def build_scorer(args) -> BleuScorer:
    name = getattr(args, "scoring", "sacrebleu")
    if name in ("bleu", "sacrebleu"):
        return BleuScorer()
    raise NotImplementedError(f"--scoring {name} is not ported; bleu and "
                              "sacrebleu are")
