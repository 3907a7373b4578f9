"""Paired-corpus audio manifests (stage 1 of the recipe; counterpart of
``s2st_tpu/preprocessing/audio_manifest.py``).

    python -m s2st_tpu_torch.preprocessing.audio_manifest \\
        --metadata train:meta_train.tsv tst:meta_tst.tsv \\
        --audio-root wavs --output-root manifests [--src-lang en] \\
        [--tgt-lang es] [--no-normalize]

Each metadata TSV (id, src_wav, tgt_wav, src_text, tgt_text[, speaker];
WAV paths relative to ``--audio-root``) becomes ``<split>.audio.tsv`` with
the manifest's columns: the sample counts read from the WAV headers, the
texts normalized by language (``zh*`` through ``cn_text_norm``, others as
cleaned English), ``spk0`` where no speaker is given. Rows whose audio is
missing are skipped and counted.
"""

from __future__ import annotations

import argparse
import logging
import sys
import wave
from pathlib import Path
from typing import List, Optional

from .cn_text_norm import normalize as cn_normalize
from .cn_text_norm import strip_punctuation
from .g2p import clean_english
from .manifest_utils import MANIFEST_COLUMNS, load_tsv, save_tsv

logger = logging.getLogger("s2st_tpu_torch.audio_manifest")


def wav_n_samples(path: Path) -> int:
    with wave.open(str(path), "rb") as w:
        return w.getnframes()


def normalize_text(text: str, lang: str) -> str:
    if lang.startswith("zh"):
        return strip_punctuation(cn_normalize(text)).strip()
    return clean_english(text)


def build_rows(meta_rows, audio_root: Path, src_lang: str, tgt_lang: str,
               normalize: bool = True):
    """(manifest rows, rows skipped for missing audio)."""
    rows, skipped = [], 0
    for e in meta_rows:
        src = audio_root / e["src_wav"]
        tgt = audio_root / e["tgt_wav"]
        if not src.exists() or not tgt.exists():
            skipped += 1
            continue
        src_text, tgt_text = e.get("src_text", ""), e.get("tgt_text", "")
        if normalize:
            src_text = normalize_text(src_text, src_lang)
            tgt_text = normalize_text(tgt_text, tgt_lang)
        rows.append({
            "id": e["id"],
            "src_audio": src.as_posix(),
            "src_n_frames": wav_n_samples(src),
            "src_text": src_text,
            "tgt_audio": tgt.as_posix(),
            "tgt_n_frames": wav_n_samples(tgt),
            "tgt_text": tgt_text,
            "speaker": e.get("speaker", "spk0") or "spk0",
        })
    return rows, skipped


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    p = argparse.ArgumentParser("s2st_tpu_torch audio_manifest")
    p.add_argument("--metadata", required=True, nargs="+",
                   help="a metadata TSV a split, as <split>:<path> or a "
                        "bare path (the split is the file's stem)")
    p.add_argument("--audio-root", default=".",
                   help="the directory the WAV paths are relative to")
    p.add_argument("--output-root", "-o", required=True)
    p.add_argument("--src-lang", default="en")
    p.add_argument("--tgt-lang", default="es",
                   help="zh* normalizes tgt_text as Chinese")
    p.add_argument("--no-normalize", action="store_true")
    args = p.parse_args(argv)

    out_root = Path(args.output_root)
    out_root.mkdir(parents=True, exist_ok=True)
    for spec in args.metadata:
        if ":" in spec and not Path(spec).exists():
            split, path = spec.split(":", 1)
        else:
            split, path = Path(spec).stem, spec
        rows, skipped = build_rows(load_tsv(path), Path(args.audio_root),
                                   args.src_lang, args.tgt_lang,
                                   normalize=not args.no_normalize)
        save_tsv(rows, out_root / f"{split}.audio.tsv",
                 columns=MANIFEST_COLUMNS)
        logger.info(f"{split}: {len(rows)} rows ({skipped} skipped, "
                    f"missing audio) -> {out_root}/{split}.audio.tsv")
    return 0


if __name__ == "__main__":
    sys.exit(main())
