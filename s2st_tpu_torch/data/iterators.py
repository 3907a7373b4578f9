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
  in the middle of an epoch; with ``num_workers`` > 1 the batches are
  collated in a pool of that many threads, ``2 * num_workers`` batches
  ahead, and delivered in order, ``iterations_in_epoch`` counting the
  delivered ones (:227-245); with ``pin_memory`` the collating thread
  copies each batch's tensors into pinned host memory (for a copy to the
  card that does not block);
- a temperature-resampled dataset (``resampled``, ``set_epoch``) draws
  each epoch's rows before its batches are formed (:207-221);
- ``GroupedIterator`` (:396-413) for ``--update-freq``;
- ``BufferedIterator`` (:462-486): the epoch's batches formed in a
  background thread, ``buffer_size`` ahead, an error raised where the
  consumer takes the next batch;
- ``DevicePrefetcher`` (:416-459): ``depth`` groups put on the device
  ahead of the consumer. ``device_put`` gives the put function: on a CUDA
  device ``CudaPut`` copies a batch's pinned tensors with
  ``non_blocking=True`` on a stream of its own and records an event; when
  the prefetcher hands the group out, the consumer's stream waits for that
  event and each tensor is ``record_stream``-ed on it, so the caching
  allocator reuses its memory only after the work queued there. On the CPU
  the put function is a plain move.

The loop reads ``iterations_in_epoch`` only before ``next_epoch_itr``
(the thread and the pool run ahead of it) and counts the batches it
consumed itself, as JAX's does (``cli/train.py:443, 479``).

The dataset gives ``src_n_frames`` (the lengths batches are formed from),
``item(index, rng)`` and ``collate(items, pad_batch, pad_src_t, pad_tgt_t,
pad_src_txt, pad_tgt_txt)`` (``data/s2st_dataset.py::TrainSplit``), or,
where it has ``snap_kwargs(items)``, ``collate(items, **snap_kwargs)`` with
the shapes it chooses itself (the raw-audio datasets of ``tasks/``; their
``collate_meta`` in JAX is None, so JAX's path is this one).
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

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
                 num_batch_buckets: int = 0, shuffle: bool = True,
                 num_workers: int = 0, pin_memory: bool = False):
        """max_positions: drop samples with more source frames
        (``--skip-invalid-size-inputs-valid-test`` with
        ``--max-source-positions``). num_batch_buckets: pad the source time
        to N length-quantile buckets instead of the ``snap_len`` grid.
        num_workers: collate threads (``--num-workers``; one or none
        collates in the caller's thread). pin_memory: each batch's tensors
        copied into pinned host memory by the thread that collates it."""
        self.dataset = dataset
        self.max_tokens = max_tokens
        self.max_sentences = max_sentences
        self.seed = seed
        self.required_batch_size_multiple = required_batch_size_multiple
        self.max_positions = max_positions
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.pin_memory = pin_memory
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

        if self.num_workers > 1:
            def pooled():
                depth = 2 * self.num_workers
                nb = len(batches)
                with ThreadPoolExecutor(self.num_workers) as ex:
                    futs = {j: ex.submit(self.collate, batches[j])
                            for j in range(start, min(start + depth, nb))}
                    for i in range(start, nb):
                        batch = futs.pop(i).result()
                        if i + depth < nb:
                            futs[i + depth] = ex.submit(
                                self.collate, batches[i + depth])
                        self.iterations_in_epoch = i + 1
                        yield batch
                self.iterations_in_epoch = 0
                self.epoch += 1
            return pooled()

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
        if hasattr(self.dataset, "snap_kwargs"):
            # the dataset's own static shapes (raw audio, :286-297)
            batch = self.dataset.collate(items,
                                         **self.dataset.snap_kwargs(items))
        else:
            batch = self.dataset.collate(
                items, pad_batch=snap_len(len(items), 8),
                pad_src_t=self._snap_time(max(len(it["src_speech"])
                                              for it in items)),
                pad_tgt_t=snap_len(max(len(it["tgt_speech"])
                                       for it in items)),
                pad_src_txt=snap_len(max(len(it["src_text"])
                                         for it in items), 8),
                pad_tgt_txt=snap_len(max(len(it["tgt_text"])
                                         for it in items), 8))
        if self.pin_memory:
            batch = {k: v.pin_memory() if isinstance(v, torch.Tensor) else v
                     for k, v in batch.items()}
        return batch

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


class BufferedIterator:
    """The items of ``iterable`` taken in a daemon thread, ``buffer_size``
    ahead of the consumer; the thread's error is raised at the consumer's
    next item."""

    _END = object()

    def __init__(self, iterable, buffer_size: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
        self._exc: Optional[BaseException] = None

        def worker():
            try:
                for item in iterable:
                    self._queue.put(item)
            except BaseException as e:  # raised on the consumer's side
                self._exc = e
            finally:
                self._queue.put(self._END)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="batch-buffer")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._END:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


class DevicePrefetcher:
    """``depth`` groups of batches put on the device ahead of the consumer:
    yields (host group, device group). ``put_fn`` puts one batch; where it
    has a ``ready`` method, that is called on each of a group's device
    batches when the group is handed out."""

    def __init__(self, groups, put_fn: Callable, depth: int = 2):
        self._it = iter(groups)
        self._put = put_fn
        self._ready = getattr(put_fn, "ready", None)
        self._depth = max(depth, 1)
        self._buf: list = []
        self._done = False

    def _fill(self):
        while not self._done and len(self._buf) < self._depth:
            try:
                group = next(self._it)
            except StopIteration:
                self._done = True
                return
            self._buf.append((group, [self._put(b) for b in group]))

    def __iter__(self):
        return self

    def __next__(self):
        self._fill()
        if not self._buf:
            raise StopIteration
        host_group, dev_group = self._buf.pop(0)
        if self._ready is not None:
            dev_group = [self._ready(b) for b in dev_group]
        self._fill()   # the next copies start before the consumer's step
        return host_group, dev_group


class CudaPut:
    """Puts a batch on a CUDA device: its (pinned) host tensors copied with
    ``non_blocking=True`` on a stream of this object's own, an event
    recorded after them. ``ready`` makes the current stream wait for the
    event and marks each tensor as used by that stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, batch: Dict[str, Any]):
        with torch.cuda.stream(self.stream):
            out = {k: v.to(self.device, non_blocking=True)
                   if isinstance(v, torch.Tensor) else v
                   for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        # the host batch rides along until the copies are waited for
        return out, event, batch

    def ready(self, pending) -> Dict[str, Any]:
        out, event, _ = pending
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for v in out.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(current)
        return out


def device_put(device: torch.device) -> Callable:
    """The put function of ``DevicePrefetcher`` for ``device``: a
    ``CudaPut`` on a CUDA device, a plain move on any other."""
    if device.type == "cuda":
        return CudaPut(device)
    return lambda batch: {k: v.to(device) if isinstance(v, torch.Tensor)
                          else v for k, v in batch.items()}
