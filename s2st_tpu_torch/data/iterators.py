"""Epoch batches as the JAX training CLI forms and orders them.

The port's own copy of what stage 5 uses of ``s2st_tpu/data/iterators.py``:

- ``ordered_indices`` (:42-50): length-major order, ties broken by a
  permutation from ``RandomState(seed + 1)``;
- ``batch_by_size`` (:54-90, the semantics of the native batcher of
  ``s2st_tpu/clib``): a token budget of rows * longest, ``max_sentences``,
  and batches cut to a multiple of ``required_batch_size_multiple``;
- ``EpochBatchIterator`` (:93-393) with one shard: the max-positions
  filter, batches frozen once and shuffled each epoch with
  ``RandomState(seed + epoch)`` (or, with ``shuffle=False`` as validation
  and generation take them, in length order, ties by index), each item's SpecAugment stream seeded from
  (seed, epoch, index) (``_fetch_item``, :269-279), batches padded to the
  static shapes of ``snap_len`` or ``--num-batch-buckets`` quantiles
  (:258-307; a waveform source's time pad counts its samples, :296-300),
  and ``state_dict`` / ``next_epoch_itr(offset)`` for a resume
  in the middle of an epoch;
- a temperature-resampled dataset (``resampled``, ``set_epoch``) draws
  each epoch's rows before its batches are formed (:207-221);
- ``GroupedIterator`` (:396-413) for ``--update-freq``.

The dataset gives ``src_n_frames`` (the lengths batches are formed from),
``item(index, rng)`` and ``collate(items, pad_batch, pad_src_t, pad_tgt_t,
pad_src_txt, pad_tgt_txt)`` (``data/s2st_dataset.py::TrainSplit``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def snap_len(n: int, min_step: int = 16) -> int:
    """n rounded up to a multiple of 2^(bitlen(n) - 3), at least min_step."""
    n = max(int(n), 1)
    step = max(min_step, 1 << max(n.bit_length() - 3, 0))
    return -(-n // step) * step


def get_buckets(sizes: np.ndarray, num_buckets: int) -> np.ndarray:
    """The unique length percentiles at linspace(0, 100, N + 1)[1:]."""
    return np.unique(np.percentile(
        sizes, np.linspace(0, 100, num_buckets + 1), method="lower")[1:])


def ordered_indices(lengths: np.ndarray, shuffle: bool, seed: int,
                    epoch: int) -> np.ndarray:
    """Longest first; ties in a seeded random order when shuffling."""
    tie = np.random.RandomState(seed + epoch).permutation(len(lengths)) \
        if shuffle else np.arange(len(lengths))
    return np.lexsort((tie, lengths))[::-1]


def batch_by_size(indices: np.ndarray, lengths: np.ndarray, max_tokens: int,
                  max_sentences: Optional[int] = None,
                  required_batch_size_multiple: int = 1
                  ) -> List[np.ndarray]:
    """Greedy batches of ``indices`` in order: a batch closes when one more
    row would make rows * longest exceed ``max_tokens`` or the rows reach
    ``max_sentences``; a closed batch of at least ``mult`` rows keeps a
    multiple of ``mult`` and hands the rest to the next. Samples longer
    than ``max_tokens`` are skipped."""
    mult = required_batch_size_multiple
    batches: List[np.ndarray] = []
    cur: List[int] = []
    cur_max = 0
    for idx in indices:
        ln = int(lengths[idx])
        if ln > max_tokens:
            logger.warning(f"skipping sample {idx}: length {ln} > max_tokens")
            continue
        new_max = max(cur_max, ln)
        if cur and ((len(cur) + 1) * new_max > max_tokens
                    or (max_sentences and len(cur) >= max_sentences)):
            bs = max(len(cur) // mult * mult, 1) if len(cur) >= mult \
                else len(cur)
            batches.append(np.asarray(cur[:bs]))
            cur = cur[bs:]
            cur_max = max((int(lengths[i]) for i in cur), default=0)
            new_max = max(cur_max, ln)
        cur.append(int(idx))
        cur_max = new_max
    if cur:
        batches.append(np.asarray(cur))
    return batches


def item_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of one item's augmentation stream."""
    return (seed * 1_000_003 + epoch * 8191 + int(index)) % (2 ** 32)


class EpochBatchIterator:
    """Frozen, shuffled and resumable epoch batches of one training
    dataset, each collated to static shapes on the host."""

    def __init__(self, dataset, max_tokens: int,
                 max_sentences: Optional[int] = None, seed: int = 1,
                 required_batch_size_multiple: int = 1,
                 max_positions: Optional[int] = None,
                 num_batch_buckets: int = 0, shuffle: bool = True):
        """max_positions: drop samples with more source frames
        (``--skip-invalid-size-inputs-valid-test`` with
        ``--max-source-positions``). num_batch_buckets: pad the source time
        to N length-quantile buckets instead of the ``snap_len`` grid."""
        self.dataset = dataset
        self.max_tokens = max_tokens
        self.max_sentences = max_sentences
        self.seed = seed
        self.required_batch_size_multiple = required_batch_size_multiple
        self.max_positions = max_positions
        self.shuffle = shuffle
        self.epoch = 1
        self.iterations_in_epoch = 0
        lengths = np.asarray(dataset.src_n_frames)
        self._buckets = get_buckets(lengths, num_batch_buckets) \
            if num_batch_buckets > 0 else None
        self._frozen: Optional[List[np.ndarray]] = None

    def frozen_batches(self) -> List[np.ndarray]:
        if self._frozen is None:
            lengths = np.asarray(self.dataset.src_n_frames)
            order = ordered_indices(lengths, self.shuffle, self.seed, 1)
            if self.max_positions is not None:
                keep = lengths[order] <= self.max_positions
                if not keep.all():
                    logger.warning(f"filtered {int((~keep).sum())} samples "
                                   f"longer than max_positions="
                                   f"{self.max_positions}")
                order = order[keep]
            self._frozen = batch_by_size(order, lengths, self.max_tokens,
                                         self.max_sentences,
                                         self.required_batch_size_multiple)
        return self._frozen

    def batches_for_epoch(self, epoch: int) -> List[np.ndarray]:
        """The epoch's batches; a resampled dataset first draws the
        epoch's rows, and its batches are formed from them anew
        (:207-221), so a resume in the middle of an epoch draws them
        again."""
        if getattr(self.dataset, "resampled", False):
            self.dataset.set_epoch(epoch)
            self._frozen = None
        batches = list(self.frozen_batches())
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(batches)
        return batches

    def __len__(self) -> int:
        return len(self.batches_for_epoch(self.epoch))

    def next_epoch_itr(self, offset: int = 0) -> Iterator[Dict[str, Any]]:
        """The current epoch's collated batches from ``offset`` (else from
        the loaded ``iterations_in_epoch``); the epoch advances when the
        last one has been taken."""
        batches = self.batches_for_epoch(self.epoch)
        start = offset or self.iterations_in_epoch
        self.iterations_in_epoch = start

        def gen():
            for i in range(start, len(batches)):
                self.iterations_in_epoch = i + 1
                yield self.collate(batches[i])
            self.iterations_in_epoch = 0
            self.epoch += 1
        return gen()

    def fetch_item(self, index: int):
        """The item with its own SpecAugment stream."""
        rng = np.random.RandomState(item_seed(self.seed, self.epoch, index))
        return self.dataset.item(int(index), rng)

    def _snap_time(self, n: int) -> int:
        if self._buckets is not None and len(self._buckets):
            pos = int(np.searchsorted(self._buckets, n))
            return int(self._buckets[pos]) if pos < len(self._buckets) \
                else int(n)
        return snap_len(n)

    def collate(self, indices: np.ndarray) -> Dict[str, Any]:
        items = [self.fetch_item(int(i)) for i in indices]
        return self.dataset.collate(
            items, pad_batch=snap_len(len(items), 8),
            pad_src_t=self._snap_time(max(len(it["src_speech"])
                                          for it in items)),
            pad_tgt_t=snap_len(max(len(it["tgt_speech"]) for it in items)),
            pad_src_txt=snap_len(max(len(it["src_text"]) for it in items), 8),
            pad_tgt_txt=snap_len(max(len(it["tgt_text"]) for it in items), 8))

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch,
                "iterations_in_epoch": self.iterations_in_epoch,
                "shuffle": True}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.epoch = state.get("epoch", 1)
        self.iterations_in_epoch = state.get("iterations_in_epoch", 0)


class GroupedIterator:
    """Lists of ``chunk_size`` consecutive items (the last may be short)."""

    def __init__(self, itr, chunk_size: int):
        self.itr = itr
        self.chunk_size = chunk_size

    def __iter__(self):
        chunk = []
        for x in self.itr:
            chunk.append(x)
            if len(chunk) == self.chunk_size:
                yield chunk
                chunk = []
        if chunk:
            yield chunk
