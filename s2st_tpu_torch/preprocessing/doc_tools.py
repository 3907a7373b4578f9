"""Document-corpus tools (the port's own copy of
``s2st_tpu/preprocessing/doc_tools.py``), each an entry point taking argv:

- ``count_docs``: documents (separated by blank lines), lines and tokens;
- ``shard_docs``: documents dealt round-robin into ``<input>.shardN``;
- ``split_train_valid_docs``: ``-k`` documents (or lines with ``--lines``)
  reservoir-sampled into a held-out file, the rest into another;
- ``rm_pt``: delete numbered checkpoints (``checkpointN.npz``,
  ``checkpoint_E_U.npz``) under directories, keeping ``--save-last`` /
  ``--save-every`` selections and, unless asked, the best and last.

    python -c "from s2st_tpu_torch.preprocessing.doc_tools import rm_pt; \\
        rm_pt(['ckpt', '--save-last', '5', '--dry-run'])"
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import os
import random
import re
import sys
from typing import List, Optional

import numpy as np


def count_docs(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("--gzip", action="store_true")
    args = p.parse_args(argv)

    opener = (lambda: gzip.open(args.input, "rt")) if args.gzip else \
        (lambda: open(args.input, "r", encoding="utf-8"))
    num_lines, num_toks = [], []
    with opener() as h:
        num_docs = 1
        nl = nt = 0
        for line in h:
            if len(line.strip()) == 0:
                num_docs += 1
                num_lines.append(nl)
                num_toks.append(nt)
                nl = nt = 0
            else:
                nl += 1
                nt += len(line.rstrip().split())
    print(f"found {num_docs} docs")
    print(f"average num lines per doc: {np.mean(num_lines)}")
    print(f"average num toks per doc: {np.mean(num_toks)}")
    return 0


def shard_docs(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("--num-shards", type=int, required=True)
    args = p.parse_args(argv)
    assert args.num_shards > 1

    with open(args.input, "r", encoding="utf-8") as h, \
            contextlib.ExitStack() as stack:
        outputs = [stack.enter_context(
            open(f"{args.input}.shard{i}", "w", encoding="utf-8"))
            for i in range(args.num_shards)]
        doc: List[str] = []
        first = [True] * args.num_shards

        def flush(i):
            if not first[i]:
                outputs[i].write("\n")
            first[i] = False
            for line in doc:
                outputs[i].write(line)
            doc.clear()

        n = 0
        for line in h:
            if line.strip() == "":
                flush(n % args.num_shards)
                n += 1
            else:
                doc.append(line)
        flush(n % args.num_shards)
    return 0


def split_train_valid_docs(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("sample_output")
    p.add_argument("remainder_output")
    p.add_argument("-k", type=int, required=True)
    p.add_argument("--lines", action="store_true")
    args = p.parse_args(argv)

    sample: List[List[str]] = []
    remainder: List[List[str]] = []
    n_docs = [0]

    def update(doc):
        if len(sample) < args.k:
            sample.append(doc.copy())
        else:
            j = random.randrange(n_docs[0] + 1)
            if j < args.k:
                remainder.append(sample[j])
                sample[j] = doc.copy()
            else:
                remainder.append(doc.copy())
        n_docs[0] += 1
        doc.clear()

    with open(args.input, "r", encoding="utf-8") as h:
        doc: List[str] = []
        for line in h:
            if line.strip() == "":
                update(doc)
            else:
                doc.append(line)
            if args.lines:
                update(doc)
        if doc:
            update(doc)
    assert len(sample) == args.k

    for path, docs in ((args.sample_output, sample),
                       (args.remainder_output, remainder)):
        with open(path, "w", encoding="utf-8") as out:
            first = True
            for d in docs:
                if not first and not args.lines:
                    out.write("\n")
                first = False
                for line in d:
                    out.write(line)
    return 0


_CKPT_EPOCH = re.compile(r"checkpoint(\d+)\.npz")
_CKPT_UPDATE = re.compile(r"checkpoint_\d+_(\d+)\.npz")


def _parse_checkpoints(files):
    out = []
    for f in files:
        m = _CKPT_EPOCH.fullmatch(f) or _CKPT_UPDATE.fullmatch(f)
        if m is not None:
            out.append((int(m.group(1)), m.group(0)))
    return out


def rm_pt(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Recursively delete numbered checkpoints, preserving "
                    "checkpoint_best/checkpoint_last (scripts/rm_pt.py)")
    p.add_argument("root_dirs", nargs="*")
    p.add_argument("--save-last", type=int, default=0)
    p.add_argument("--save-every", type=int, default=0)
    p.add_argument("--delete-best", action="store_true")
    p.add_argument("--delete-last", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)

    for root in args.root_dirs:
        for dirpath, _dirs, files in os.walk(root):
            entries = _parse_checkpoints(files)
            keep = set()
            if args.save_last > 0:
                keep.update(f for _, f in
                            sorted(entries, reverse=True)[:args.save_last])
            if args.save_every > 0:
                keep.update(f for _, f in
                            sorted(entries)[::-args.save_every])
            to_delete = [f for _, f in entries if f not in keep]
            if args.delete_best and "checkpoint_best.npz" in files:
                to_delete.append("checkpoint_best.npz")
            if args.delete_last and "checkpoint_last.npz" in files:
                to_delete.append("checkpoint_last.npz")
            for f in to_delete:
                path = os.path.join(dirpath, f)
                if args.dry_run:
                    print(f"would delete {path}")
                else:
                    os.remove(path)
                    print(f"deleted {path}", file=sys.stderr)
    return 0
