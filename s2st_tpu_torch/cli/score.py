"""Stage 9: BLEU or WER of a system output file against reference files.

Counterpart of ``s2st_tpu/cli/score.py`` (:12-59), one sentence a line:

    python -m s2st_tpu_torch.cli.score --scoring sacrebleu --ignore-case \\
        --sys decode.txt.prediction --ref en.0.norm.lc.rm en.1.norm.lc.rm ...

Several ``--ref`` files give multi-reference BLEU; the line printed is
sacrebleu 2.6.0's (``scoring.corpus_bleu``), which is what JAX prints where
sacrebleu is installed. ``--scoring wer`` takes one reference.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..scoring import BleuScorer, WerScorer, corpus_bleu


def read_lines(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sys", "-s", required=True, help="system output file")
    p.add_argument("--ref", "-r", required=True, nargs="+",
                   help="reference file(s); several give multi-reference "
                        "BLEU")
    p.add_argument("--scoring", default="sacrebleu",
                   choices=["sacrebleu", "bleu", "wer"])
    p.add_argument("--ignore-case", action="store_true")
    args = p.parse_args(argv)

    hyps = read_lines(args.sys)
    ref_streams = [read_lines(r) for r in args.ref]
    for refs in ref_streams:
        if len(refs) != len(hyps):
            # JAX's assert, raised whatever -O says
            raise AssertionError("sys/ref line-count mismatch")

    if len(ref_streams) > 1:
        if args.scoring == "wer":
            p.error("--scoring wer supports a single reference")
        if args.ignore_case:
            hyps = [h.lower() for h in hyps]
            ref_streams = [[r.lower() for r in refs] for refs in ref_streams]
        print(str(corpus_bleu(hyps, ref_streams)))
        return 0

    scorer = (WerScorer(lowercase=args.ignore_case)
              if args.scoring == "wer"
              else BleuScorer(lowercase=args.ignore_case))
    for hyp, ref in zip(hyps, ref_streams[0]):
        scorer.add_string(ref, hyp)
    print(scorer.result_string())
    return 0


if __name__ == "__main__":
    sys.exit(main())
