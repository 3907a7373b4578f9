"""The translation task over a fairseq-binarized corpus: the port's copy of
``infer_language_pair``, ``setup_task`` and one shard of ``load_dataset``
(``s2st_tpu/tasks/translation.py:48-140``).

A corpus directory holds ``dict.<lang>.txt`` for both languages and
``<split>.<src>-<tgt>.<lang>.{bin,idx}`` (either naming direction) in the
``mmap`` format.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

from ..data.dictionary import Dictionary
from ..data.indexed_dataset import MMapIndexedDataset
from ..data.language_pair_dataset import LanguagePairDataset

logger = logging.getLogger(__name__)


def infer_language_pair(path: str) -> Tuple[Optional[str], Optional[str]]:
    """The pair of the first ``train.<src>-<tgt>.*`` file, by name."""
    for fname in sorted(os.listdir(path)):
        parts = fname.split(".")
        if len(parts) >= 3 and parts[0] == "train" and \
                parts[1].count("-") == 1:
            src, tgt = parts[1].split("-")
            return src, tgt
    return None, None


class TranslationTask:
    def __init__(self, args, src_dict: Dictionary, tgt_dict: Dictionary):
        self.args = args
        self.src_dict, self.tgt_dict = src_dict, tgt_dict

    @classmethod
    def setup_task(cls, args) -> "TranslationTask":
        """Dictionaries of the pair; the pair from the file names unless
        ``--source-lang``/``--target-lang`` give it."""
        data = str(args.data).split(os.pathsep)[0]
        if args.source_lang is None or args.target_lang is None:
            args.source_lang, args.target_lang = infer_language_pair(data)
            if args.source_lang is None:
                raise ValueError("could not infer language pair; use "
                                 "--source-lang and --target-lang")
        src_dict = Dictionary.load(os.path.join(
            data, f"dict.{args.source_lang}.txt"))
        tgt_dict = Dictionary.load(os.path.join(
            data, f"dict.{args.target_lang}.txt"))
        logger.info(f"[{args.source_lang}] dictionary: {len(src_dict)} types")
        logger.info(f"[{args.target_lang}] dictionary: {len(tgt_dict)} types")
        return cls(args, src_dict, tgt_dict)

    def _prefix(self, split: str) -> Optional[str]:
        data = str(self.args.data).split(os.pathsep)[0]
        src, tgt = self.args.source_lang, self.args.target_lang
        for a, b in ((src, tgt), (tgt, src)):
            prefix = os.path.join(data, f"{split}.{a}-{b}.")
            if MMapIndexedDataset.exists(prefix + src):
                return prefix
        return None

    def load_dataset(self, split: str) -> LanguagePairDataset:
        """One shard of ``split``; the target side when it exists."""
        prefix = self._prefix(split)
        if prefix is None:
            raise FileNotFoundError(f"Dataset not found: {split} "
                                    f"({self.args.data})")
        if self._prefix(split + "1") is not None:
            raise NotImplementedError(f"{split} has more than one shard; "
                                      "combining shards is not ported")
        src = MMapIndexedDataset(prefix + self.args.source_lang)
        tgt_prefix = prefix + self.args.target_lang
        tgt = MMapIndexedDataset(tgt_prefix) \
            if MMapIndexedDataset.exists(tgt_prefix) else None
        logger.info(f"{self.args.data} {split} {self.args.source_lang}-"
                    f"{self.args.target_lang} {len(src)} examples")
        return LanguagePairDataset(src, tgt,
                                   left_pad_source=self.args.left_pad_source,
                                   left_pad_target=self.args.left_pad_target)
