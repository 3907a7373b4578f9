"""Grapheme-to-phoneme rewriting of a manifest (stage 2 of the recipe;
counterpart of ``s2st_tpu/preprocessing/g2p.py``).

    python -m s2st_tpu_torch.preprocessing.g2p --input-file in.tsv \\
        --output-file out.tsv [--src-backend auto|g2p_en|chars] \\
        [--tgt-backend auto|pypinyin|chars] [--keep-latin-tgt]

The source side is cleaned English (``clean_english``), phonemized by
``g2p_en``; the target side is Chinese, normalized by ``cn_text_norm``,
kept to ``[0-9A-Za-z一-龥]`` and phonemized per character by ``pypinyin``
(TONE3 initials and finals). Both phonemizers are optional imports:
``auto`` takes each where it is installed and falls back to ``chars``
(words for the source, characters for the target); naming one that is
missing raises ImportError, as in the JAX package. Rows whose target text
holds a Latin letter are dropped unless ``--keep-latin-tgt``.
"""

from __future__ import annotations

import argparse
import logging
import re
import sys
from typing import List, Optional

from .cn_text_norm import normalize as cn_normalize
from .manifest_utils import MANIFEST_COLUMNS, load_tsv, save_tsv

logger = logging.getLogger("s2st_tpu_torch.g2p")

_EN_CHAR = re.compile(r"[A-Za-z]")
_NON_WORD = re.compile(r"[^0-9A-Za-z一-龥]")

# the essentials of tacotron's custom_english_cleaners: abbreviations
# expanded, whitespace collapsed, lower case
_ABBREV = [(re.compile(rf"\b{a}\.", re.IGNORECASE), b) for a, b in [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"),
    ("ft", "fort")]]


def clean_english(text: str) -> str:
    for pat, repl in _ABBREV:
        text = pat.sub(repl, text)
    return re.sub(r"\s+", " ", text).strip().lower()


def phonemize_en(text: str, backend: str) -> str:
    text = clean_english(text)
    if backend == "g2p_en":
        from g2p_en import G2p  # optional
        return " ".join(p for p in G2p()(text) if p != " ")
    return text


def pinyin_phones(text: str) -> List[str]:
    """Per-character pypinyin TONE3 initials and finals."""
    from pypinyin import Style, pinyin  # optional
    from pypinyin.style._utils import get_finals, get_initials
    out = []
    for syl in pinyin(text, style=Style.TONE3):
        for part in (get_initials(syl[0], strict=True),
                     get_finals(syl[0], strict=True)):
            if part:
                out.append(part)
    return out


def phonemize_zh(text: str, backend: str) -> str:
    norm = _NON_WORD.sub("", cn_normalize(text.replace(" ", "")))
    if backend == "pypinyin":
        return " ".join(pinyin_phones("|".join(norm)))
    return " ".join(norm)


def _resolve(backend: str, module: str) -> str:
    """``auto`` -> the phonemizer where it imports, else ``chars``."""
    if backend != "auto":
        return backend
    try:
        __import__(module)
        return module
    except ImportError:
        logger.warning(f"{module} unavailable -> chars fallback")
        return "chars"


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    p = argparse.ArgumentParser("s2st_tpu_torch g2p")
    p.add_argument("--input-file", required=True)
    p.add_argument("--output-file", required=True)
    p.add_argument("--src-backend", default="auto",
                   choices=["auto", "g2p_en", "chars"])
    p.add_argument("--tgt-backend", default="auto",
                   choices=["auto", "pypinyin", "chars"])
    p.add_argument("--keep-latin-tgt", action="store_true",
                   help="keep rows whose tgt_text holds Latin letters")
    args = p.parse_args(argv)
    src_backend = _resolve(args.src_backend, "g2p_en")
    tgt_backend = _resolve(args.tgt_backend, "pypinyin")

    rows_out, dropped = [], 0
    for s in load_tsv(args.input_file):
        if not args.keep_latin_tgt and _EN_CHAR.search(s["tgt_text"]):
            logger.info(f"latin chars in tgt of id {s['id']}; dropped")
            dropped += 1
            continue
        rows_out.append({**s,
                         "src_text": phonemize_en(s["src_text"], src_backend),
                         "tgt_text": phonemize_zh(s["tgt_text"],
                                                  tgt_backend)})
    cols = [c for c in MANIFEST_COLUMNS if rows_out and c in rows_out[0]]
    save_tsv(rows_out, args.output_file, columns=cols or None)
    logger.info(f"wrote {len(rows_out)} rows ({dropped} dropped) "
                f"-> {args.output_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
