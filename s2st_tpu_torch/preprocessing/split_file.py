"""Split a manifest TSV into N shards, or concatenate shards back (stage 2
of the recipe; counterpart of ``s2st_tpu/preprocessing/split_file.py``).

    python -m s2st_tpu_torch.preprocessing.split_file --type split --n 8 \\
        --input-file tst.audio.tsv --output-path split_8/tst
    python -m s2st_tpu_torch.preprocessing.split_file --type contat \\
        --file-part split_8/tst/tst.audio_phone.*.tsv --output-path .

Shards are ``<stem>.audio.<i>.tsv``, numbered from 1, contiguous, the last
taking the remainder; the concatenation is ``<stem>.audio_phone.tsv``.
``--type`` takes ``concat`` and the recipe's spelling ``contat``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .manifest_utils import load_tsv, save_tsv


def split_manifest(rows, n: int) -> list:
    """n contiguous shards of len(rows) // n rows; the last takes the
    remainder."""
    per = len(rows) // n
    return [rows[i * per:(i + 1) * per if i < n - 1 else len(rows)]
            for i in range(n)]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("s2st_tpu_torch split_file")
    p.add_argument("--input-file", type=str)
    p.add_argument("--output-path", required=True, type=str)
    p.add_argument("--file-part", "-s", type=str, nargs="+")
    p.add_argument("--type", required=True,
                   choices=["split", "concat", "contat"])
    p.add_argument("--n", type=int)
    args = p.parse_args(argv)

    os.makedirs(args.output_path, exist_ok=True)
    if args.type == "split":
        stem = os.path.basename(args.input_file).split(".")[0]
        for i, shard in enumerate(split_manifest(load_tsv(args.input_file),
                                                 args.n)):
            save_tsv(shard, os.path.join(args.output_path,
                                         f"{stem}.audio.{i + 1}.tsv"))
    else:
        rows = []
        for part in args.file_part:
            rows.extend(load_tsv(part))
        stem = os.path.basename(args.file_part[0]).split(".")[0]
        save_tsv(rows, os.path.join(args.output_path,
                                    f"{stem}.audio_phone.tsv"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
