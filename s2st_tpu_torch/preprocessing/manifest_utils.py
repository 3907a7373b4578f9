"""TSV manifests of the preprocessing tools (counterpart of
``s2st_tpu/preprocessing/manifest_utils.py``: the reference's
``load_tsv_to_dicts`` / ``save_df_to_tsv`` without pandas)."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Iterable, List, Optional

MANIFEST_COLUMNS = ["id", "src_audio", "src_n_frames", "src_text",
                    "tgt_audio", "tgt_n_frames", "tgt_text", "speaker"]


def load_tsv(path) -> List[Dict[str, str]]:
    with open(path, encoding="utf-8") as f:
        return [dict(e) for e in csv.DictReader(
            f, delimiter="\t", quoting=csv.QUOTE_NONE)]


def save_tsv(rows: Iterable[Dict[str, str]], path,
             columns: Optional[List[str]] = None) -> None:
    """Rows under ``columns`` (the first row's keys by default); a tab or
    newline inside a field becomes a space, and nothing is quoted. No rows
    write an empty file."""
    rows = list(rows)
    if not rows:
        Path(path).write_text("")
        return

    def scrub(v):
        if isinstance(v, str) and any(c in v for c in "\t\n\r"):
            return " ".join(v.split())
        return v

    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=columns or list(rows[0].keys()),
                           delimiter="\t", quoting=csv.QUOTE_NONE,
                           quotechar=None, extrasaction="ignore")
        w.writeheader()
        w.writerows([{k: scrub(v) for k, v in r.items()} for r in rows])
