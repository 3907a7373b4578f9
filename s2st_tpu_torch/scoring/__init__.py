"""Scorers: WER and corpus BLEU in the form the JAX package prints.

Counterpart of ``s2st_tpu/scoring/__init__.py``: ``edit_distance`` (:22,
the Python DP), ``WerScorer`` (:48-91) and ``BleuScorer`` (:151-183). JAX
scores BLEU with ``sacrebleu.corpus_bleu(hyps, [refs], tokenize="13a")``
when that package is installed; the port carries its own copy of what that
call computes in sacrebleu 2.6.0, and never imports the package:

- ``Tokenizer13a`` (``tokenizers/tokenizer_13a.py`` and
  ``tokenizer_re.py``): mteval-v13a's tokenization;
- the statistics of ``metrics/bleu.py`` over one or more reference
  streams: each n-gram clipped at its largest count in any reference,
  totals up to order 4, the hypothesis length and the reference length
  closest to it (the shorter on a tie), after ``lowercase`` where asked;
- ``BLEU.compute_bleu`` with ``exp`` smoothing and without effective
  order, and ``BLEUScore``'s line ``BLEU = 12.34 a/b/c/d (BP = ...
  ratio = ... hyp_len = ... ref_len = ...)``.

``--wer-tokenizer 13a`` takes the same tokenizer.
"""

from __future__ import annotations

import math
import re
import string
from collections import Counter
from typing import List, Sequence, Tuple

MAX_NGRAM_ORDER = 4


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance between two token sequences."""
    n, m = len(a), len(b)
    if n == 0:
        return m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (a[i - 1] != b[j - 1]))
        prev = cur
    return prev[m]


class Tokenizer13a:
    """sacrebleu's ``13a`` tokenizer (mteval-v13a)."""

    _RE = [
        # language-dependent part (assuming Western languages)
        (re.compile(r'([\{-\~\[-\` -\&\(-\+\:-\@\/])'), r' \1 '),
        # period and comma unless preceded by a digit
        (re.compile(r'([^0-9])([\.,])'), r'\1 \2 '),
        # period and comma unless followed by a digit
        (re.compile(r'([\.,])([^0-9])'), r' \1 \2'),
        # dash when preceded by a digit
        (re.compile(r'([0-9])(-)'), r'\1 \2 '),
    ]

    def __call__(self, line: str) -> str:
        line = line.replace('<skipped>', '')
        line = line.replace('-\n', '')
        line = line.replace('\n', ' ')
        if '&' in line:
            line = line.replace('&quot;', '"')
            line = line.replace('&amp;', '&')
            line = line.replace('&lt;', '<')
            line = line.replace('&gt;', '>')
        line = f' {line} '
        for regex, repl in self._RE:
            line = regex.sub(repl, line)
        return ' '.join(line.split())


class WerScorer:
    """``--scoring wer`` with ``--wer-tokenizer``, ``--wer-lowercase`` and
    ``--wer-remove-punct``: token edit distance over reference tokens, in
    percent. ``13a`` runs the port's ``Tokenizer13a``; any other name
    (``none``, ``intl``, ``char``, ...) splits on white space, as JAX's
    scorer does (``s2st_tpu/scoring/__init__.py:54-66``)."""

    def __init__(self, lowercase: bool = False, remove_punct: bool = False,
                 tokenizer: str = "none"):
        self.lowercase = lowercase
        self.remove_punct = remove_punct
        self.distance = 0
        self.ref_length = 0
        self._pre = Tokenizer13a() if tokenizer == "13a" else None

    def _tok(self, s: str) -> List[str]:
        if self._pre is not None:
            s = self._pre(s)
        if self.lowercase:
            s = s.lower()
        if self.remove_punct:
            s = s.translate(str.maketrans("", "", string.punctuation))
        return s.split()

    def add_string(self, ref: str, pred: str) -> None:
        ref_t, pred_t = self._tok(ref), self._tok(pred)
        self.distance += edit_distance(ref_t, pred_t)
        self.ref_length += len(ref_t)

    def score(self) -> float:
        return 100.0 * self.distance / self.ref_length \
            if self.ref_length > 0 else 0.0

    def result_string(self) -> str:
        return f"WER: {self.score():.2f}"


def _ngrams(line: str) -> Tuple[Counter, int]:
    """All n-grams of orders 1..4 of the whitespace tokens, and the token
    count."""
    tokens = line.split()
    grams = [tuple(tokens[i:i + n]) for n in range(1, MAX_NGRAM_ORDER + 1)
             for i in range(len(tokens) - n + 1)]
    return Counter(grams), len(tokens)


def _segment_stats(hyp: str, refs: Sequence[str]) -> List[int]:
    """[hyp_len, ref_len, correct 1..4, total 1..4] of one tokenized
    hypothesis against its references (``_extract_reference_info`` and
    ``_compute_segment_statistics``)."""
    ref_grams: Counter = Counter()
    ref_lens = []
    for ref in refs:
        grams, n = _ngrams(ref)
        ref_lens.append(n)
        for gram, count in grams.items():
            ref_grams[gram] = max(ref_grams[gram], count)
    hyp_grams, hyp_len = _ngrams(hyp)
    # the closest reference length, the shorter of two as close
    ref_len = min(ref_lens, key=lambda n: (abs(hyp_len - n), n))
    correct = [0] * MAX_NGRAM_ORDER
    total = [0] * MAX_NGRAM_ORDER
    for gram, count in hyp_grams.items():
        n = len(gram) - 1
        total[n] += count
        if gram in ref_grams:
            correct[n] += min(count, ref_grams[gram])
    return [hyp_len, ref_len] + correct + total


class BLEUScore:
    """sacrebleu's ``BLEUScore``: the score and the line it prints."""

    def __init__(self, score: float, counts: List[int], totals: List[int],
                 precisions: List[float], bp: float, sys_len: int,
                 ref_len: int):
        self.score = score
        self.counts, self.totals = counts, totals
        self.precisions = precisions
        self.bp = bp
        self.sys_len, self.ref_len = sys_len, ref_len
        self.ratio = sys_len / ref_len if ref_len else 0

    def __str__(self) -> str:
        prec = "/".join(f"{p:.1f}" for p in self.precisions)
        return (f"BLEU = {self.score:.2f} {prec} (BP = {self.bp:.3f} "
                f"ratio = {self.ratio:.3f} hyp_len = {self.sys_len:d} "
                f"ref_len = {self.ref_len:d})")


def compute_bleu(correct: List[int], total: List[int], sys_len: int,
                 ref_len: int) -> BLEUScore:
    """``BLEU.compute_bleu`` with ``exp`` smoothing, effective order off:
    an order with no match counts 100 / (2^k total), k its rank among
    such orders; an order with no n-gram ends the precisions there, and
    log(0) is -9999999999."""
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * MAX_NGRAM_ORDER
    if not any(correct):
        return BLEUScore(0.0, correct, total, precisions, bp, sys_len,
                         ref_len)
    smooth = 1.0
    for n in range(1, MAX_NGRAM_ORDER + 1):
        if total[n - 1] == 0:
            break
        if correct[n - 1] == 0:
            smooth *= 2
            precisions[n - 1] = 100. / (smooth * total[n - 1])
        else:
            precisions[n - 1] = 100. * correct[n - 1] / total[n - 1]
    logs = [math.log(p) if p != 0.0 else -9999999999 for p in precisions]
    score = bp * math.exp(sum(logs) / MAX_NGRAM_ORDER)
    return BLEUScore(score, correct, total, precisions, bp, sys_len, ref_len)


def corpus_bleu(hyps: Sequence[str], ref_streams: Sequence[Sequence[str]],
                lowercase: bool = False) -> BLEUScore:
    """``sacrebleu.corpus_bleu(hyps, ref_streams, lowercase=lowercase,
    tokenize="13a")``: ``ref_streams`` holds one stream of references a
    reference set, each aligned with ``hyps``; segments are zipped to the
    shortest of them, as sacrebleu zips."""
    tok = Tokenizer13a()

    def prep(s: str) -> str:
        return tok((s.lower() if lowercase else s).rstrip())

    stats = [0] * (2 + 2 * MAX_NGRAM_ORDER)
    for hyp, refs in zip(hyps, zip(*ref_streams)):
        for i, v in enumerate(_segment_stats(prep(hyp),
                                             [prep(r) for r in refs])):
            stats[i] += v
    return compute_bleu(stats[2:2 + MAX_NGRAM_ORDER],
                        stats[2 + MAX_NGRAM_ORDER:], stats[0], stats[1])


class BleuScorer:
    """``--scoring bleu`` / ``sacrebleu``: sacrebleu's corpus BLEU with
    the 13a tokenizer, lowercased first with ``lowercase``."""

    def __init__(self, lowercase: bool = False):
        self.lowercase = lowercase
        self.refs: List[str] = []
        self.hyps: List[str] = []

    def add_string(self, ref: str, pred: str) -> None:
        self.refs.append(ref)
        self.hyps.append(pred)

    def bleu(self) -> BLEUScore:
        return corpus_bleu(self.hyps, [self.refs], self.lowercase)

    def score(self) -> float:
        return self.bleu().score

    def result_string(self) -> str:
        return str(self.bleu())


def build_scorer(args):
    name = getattr(args, "scoring", "sacrebleu")
    if name == "wer":
        return WerScorer(lowercase=getattr(args, "wer_lowercase", False),
                         remove_punct=getattr(args, "wer_remove_punct",
                                              False),
                         tokenizer=getattr(args, "wer_tokenizer", "none"))
    if name in ("bleu", "sacrebleu"):
        return BleuScorer()
    raise NotImplementedError(f"--scoring {name} is not ported; wer, bleu "
                              "and sacrebleu are")
