"""Filter or join a feature manifest (the port's own copy of
``s2st_tpu/preprocessing/filter_manifest.py``): keep the rows whose id is in
a reference manifest, attaching its text as ``tgt_text_orig``, within
frame-count bounds, and not in an exclusion list; the TSV is JAX's byte for
byte.

    python -m s2st_tpu_torch.preprocessing.filter_manifest \\
        --manifest train.tsv --output train.filtered.tsv \\
        [--reference-manifest ref.tsv] [--orig-text-column tgt_text] \\
        [--exclude-ids bad.txt] [--max-src-frames N] [--max-tgt-frames N] \\
        [--min-src-frames N] [--min-tgt-frames N]
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Optional

from .manifest_utils import MANIFEST_COLUMNS, load_tsv, save_tsv

logger = logging.getLogger("s2st_tpu_torch.filter_manifest")


def filter_rows(samples, reference=None, orig_text_column="tgt_text",
                max_src_frames: int = 0, max_tgt_frames: int = 0,
                min_src_frames: int = 0, min_tgt_frames: int = 0,
                exclude_ids=frozenset()):
    """Keep rows present in `reference` (dict id -> row, optional), within
    the frame-count bounds, and not in `exclude_ids`; when `reference` is
    given, its `orig_text_column` is attached as ``tgt_text_orig``
    Returns (kept_rows, n_dropped)."""
    kept, dropped = [], 0
    for s in samples:
        sid = s["id"]
        if sid in exclude_ids:
            dropped += 1
            continue
        if reference is not None and sid not in reference:
            dropped += 1
            continue
        src_n = int(s.get("src_n_frames", 0) or 0)
        tgt_n = int(s.get("tgt_n_frames", 0) or 0)
        if max_src_frames and src_n > max_src_frames:
            dropped += 1
            continue
        if max_tgt_frames and tgt_n > max_tgt_frames:
            dropped += 1
            continue
        if src_n < min_src_frames or tgt_n < min_tgt_frames:
            dropped += 1
            continue
        row = dict(s)
        if reference is not None:
            row["tgt_text_orig"] = reference[sid].get(orig_text_column, "")
        kept.append(row)
    return kept, dropped


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    p = argparse.ArgumentParser("s2st_tpu_torch filter_manifest")
    p.add_argument("--manifest", required=True,
                   help="feature manifest TSV to filter")
    p.add_argument("--output", required=True)
    p.add_argument("--reference-manifest", default=None,
                   help="keep only ids present here; attach its text as "
                        "tgt_text_orig")
    p.add_argument("--orig-text-column", default="tgt_text")
    p.add_argument("--exclude-ids", default=None,
                   help="file with one id (or 'id,...' csv row) per line "
                        "to drop (bad-case list)")
    p.add_argument("--max-src-frames", type=int, default=0)
    p.add_argument("--max-tgt-frames", type=int, default=0)
    p.add_argument("--min-src-frames", type=int, default=0)
    p.add_argument("--min-tgt-frames", type=int, default=0)
    args = p.parse_args(argv)

    samples = load_tsv(args.manifest)
    reference = None
    if args.reference_manifest:
        reference = {e["id"]: e for e in load_tsv(args.reference_manifest)}
    exclude = frozenset()
    if args.exclude_ids:
        with open(args.exclude_ids, encoding="utf-8") as f:
            exclude = frozenset(
                ln.strip().split(",")[0].replace(" ", "")
                for ln in f if ln.strip())

    kept, dropped = filter_rows(
        samples, reference, args.orig_text_column,
        args.max_src_frames, args.max_tgt_frames,
        args.min_src_frames, args.min_tgt_frames, exclude)
    cols = MANIFEST_COLUMNS + (["tgt_text_orig"] if reference else [])
    cols = [c for c in cols if kept and c in kept[0]]
    save_tsv(kept, args.output, columns=cols or None)
    logger.info(f"kept {len(kept)} rows, dropped {dropped} -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
