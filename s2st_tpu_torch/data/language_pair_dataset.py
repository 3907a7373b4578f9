"""Paired source/target text for translation: items, collate and batches.

Counterpart of ``s2st_tpu/data/language_pair_dataset.py`` and of the
batching in ``s2st_tpu/data/iterators.py`` that the translation task's
``get_batch_iterator`` uses for generation (no shuffling):

- a sample's batching cost is max(source, target) tokens;
- samples go in descending cost order, ties by descending index
  (``iterators.ordered_indices``);
- batches fill to ``--max-tokens`` (rows x longest cost) and
  ``--batch-size`` rows, cut to a multiple of
  ``--required-batch-size-multiple`` (``iterators.batch_by_size``);
- collate sorts a batch's rows by descending source length, LEFT-pads the
  sources, right-pads the targets, and builds ``prev_output_tokens`` as the
  target with its EOS moved to the front.

The JAX collate also pads rows and lengths up to a coarse grid so that XLA
compiles few shapes; the port runs eagerly and pads only to the batch's
longest row. Padding rows and columns are PAD, which the model masks, so
the real rows' results do not depend on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .iterators import batch_by_size, ordered_indices

PAD = 1


@dataclass
class LanguagePairItem:
    id: int
    source: np.ndarray            # (Ts,) eos-terminated
    target: Optional[np.ndarray]  # (Tt,) eos-terminated


class LanguagePairDataset:
    def __init__(self, src, tgt=None, left_pad_source: bool = True,
                 left_pad_target: bool = False):
        self.src, self.tgt = src, tgt
        self.src_sizes = np.asarray(src.sizes)
        self.tgt_sizes = np.asarray(tgt.sizes) if tgt is not None else None
        self.left_pad_source = left_pad_source
        self.left_pad_target = left_pad_target

    def __len__(self) -> int:
        return len(self.src)

    def __getitem__(self, i: int) -> LanguagePairItem:
        tgt = self.tgt[i] if self.tgt is not None else None
        return LanguagePairItem(id=i, source=np.asarray(self.src[i]),
                                target=None if tgt is None
                                else np.asarray(tgt))

    def num_tokens(self) -> np.ndarray:
        """Batching cost of every sample: max(source, target) tokens."""
        if self.tgt_sizes is None:
            return self.src_sizes.astype(np.int64)
        return np.maximum(self.src_sizes, self.tgt_sizes).astype(np.int64)

    def batches(self, max_tokens: int, max_sentences: Optional[int] = None,
                required_batch_size_multiple: int = 1,
                max_positions: Optional[int] = None) -> List[np.ndarray]:
        lengths = self.num_tokens()
        order = ordered_indices(lengths, False, 0, 0)
        if max_positions is not None:
            order = order[lengths[order] <= max_positions]
        return batch_by_size(order, lengths, max_tokens, max_sentences,
                             required_batch_size_multiple)

    def collate(self, indices) -> Dict[str, torch.Tensor]:
        """(B, Ts) src_tokens, (B,) src_lengths and ids; with targets also
        target, prev_output_tokens and target_lengths. int64 CPU tensors."""
        items = sorted((self[int(i)] for i in indices),
                       key=lambda it: -len(it.source))
        b = len(items)
        ts = max(len(it.source) for it in items)
        src = np.full((b, ts), PAD, np.int64)
        for row, it in enumerate(items):
            n = len(it.source)
            if self.left_pad_source:
                src[row, ts - n:] = it.source
            else:
                src[row, :n] = it.source
        batch = {"id": torch.tensor([it.id for it in items]),
                 "src_tokens": torch.from_numpy(src),
                 "src_lengths": torch.tensor([len(it.source)
                                              for it in items])}
        if items[0].target is None:
            return batch
        tt = max(len(it.target) for it in items)
        target = np.full((b, tt), PAD, np.int64)
        prev = np.full((b, tt), PAD, np.int64)
        for row, it in enumerate(items):
            n = len(it.target)
            off = tt - n if self.left_pad_target else 0
            target[row, off:off + n] = it.target
            prev[row, off] = it.target[-1]            # the EOS, moved first
            prev[row, off + 1:off + n] = it.target[:-1]
        batch["target"] = torch.from_numpy(target)
        batch["prev_output_tokens"] = torch.from_numpy(prev)
        batch["target_lengths"] = torch.tensor([len(it.target)
                                                for it in items])
        return batch
