"""Constraint extraction/validation helpers for lexically constrained
decoding: the port's copy of ``s2st_tpu/preprocessing/constraints_tools.py``
(fairseq's scripts/constraints/{extract,validate}.py). Python's
``random.Random(--seed)`` makes the same draws as JAX's tool, so the files
are the same bytes.

extract: sample random non-overlapping phrases from each utterance's
reference text in an audio manifest -> a constraints TSV
(``id\\tphrase\\tphrase...``) consumable by
``generate_for_s2st --constraints {ordered,unordered} --constraints-file``.

validate: read a generate_for_s2st output stream and report how many C-
line constraints appear verbatim in their sentence's first H- hypothesis.
"""

from __future__ import annotations

import argparse
import csv
import random
import sys
from typing import List, Optional


def sample_phrases(words: List[str], number: int, max_len: int,
                   rng: random.Random) -> List[str]:
    """Up to `number` random non-overlapping phrases of 1..max_len words
    (each phrase is removed before the next draw, like the reference's
    get_phrase pop loop)."""
    words = list(words)
    out = []
    for _ in range(number):
        if not words:
            break
        length = rng.randint(1, min(max_len, len(words)))
        index = rng.randint(0, len(words) - length)
        out.append(" ".join(words[index:index + length]))
        del words[index:index + length]
    return out


def extract_main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("s2st_tpu_torch constraints extract")
    p.add_argument("--audio-manifest", required=True,
                   help="TSV with id + reference text columns")
    p.add_argument("--field", default="tgt_text",
                   help="manifest column holding the reference text")
    p.add_argument("--number", "-n", type=int, default=1,
                   help="constraints per utterance")
    p.add_argument("--max-len", type=int, default=3,
                   help="max words per constraint phrase")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--output", "-o", default="-")
    args = p.parse_args(argv)

    rng = random.Random(args.seed)
    out = sys.stdout if args.output == "-" else open(args.output, "w",
                                                     encoding="utf-8")
    with open(args.audio_manifest, encoding="utf-8") as f:
        for row in csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE):
            phrases = sample_phrases(row[args.field].split(), args.number,
                                     args.max_len, rng)
            out.write("\t".join([row["id"]] + phrases) + "\n")
    if out is not sys.stdout:
        out.close()
    return 0


def validate_stream(lines) -> tuple:
    """(found, total) over C-/H- line pairs (validate.py parity: each
    sentence's constraints checked against its FIRST hypothesis)."""
    constraints: List[str] = []
    found = total = 0
    seen_hyp = False
    for line in lines:
        if line.startswith("C-"):
            constraints.append(line.rstrip("\n").split("\t")[1])
            seen_hyp = False
        elif line.startswith("H-") and not seen_hyp:
            text = line.rstrip("\n").split("\t")[2]
            for c in constraints:
                total += 1
                if c in text:
                    found += 1
                else:
                    print(f"No {c} in {text}", file=sys.stderr)
            constraints = []
            seen_hyp = True
    return found, total


def validate_main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("s2st_tpu_torch constraints validate")
    p.add_argument("--input", "-i", default="-",
                   help="generate_for_s2st output (default stdin)")
    args = p.parse_args(argv)
    fh = sys.stdin if args.input == "-" else open(args.input,
                                                  encoding="utf-8")
    found, total = validate_stream(fh)
    pct = 100 * found / total if total else 0.0
    print(f"Found {found} / {total} = {pct:.1f}%")
    return 0 if found == total else 1


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("extract", "validate"):
        print("usage: constraints_tools {extract,validate} ...",
              file=sys.stderr)
        return 2
    return (extract_main if argv[0] == "extract" else validate_main)(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
