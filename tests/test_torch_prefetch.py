"""Threaded collate, the collate thread and the device prefetch of the
port's training loop against JAX's (``s2st_tpu/data/iterators.py``,
``s2st_tpu/cli/train.py:440-452``), on the CPU.

- ``EpochBatchIterator(num_workers=4)`` through the loop's wrapping,
  ``DevicePrefetcher(GroupedIterator(BufferedIterator(...)))``, over two
  epochs: every batch equal to JAX's ``EpochBatchIterator(num_workers=4)``
  (exact: the same numpy draws, whichever thread collates an item);
- a mid-epoch position counted in consumed batches resumes where the
  uninterrupted epoch goes on, as JAX's does, while the iterator's own
  ``iterations_in_epoch`` has run ahead of it;
- ``BufferedIterator`` raises its thread's error to the consumer, and
  ``DevicePrefetcher`` keeps the order and calls ``ready`` on hand-out;
- the train CLI: a run under ``--num-workers 4`` stopped and saved in
  the middle of an epoch, then resumed, gives the losses and gradient
  norms of an uninterrupted run under ``--num-workers 1``, bit for bit:
  the same batches in the same order, and the save counts the batches the
  loop consumed.
"""

from __future__ import annotations

import json
import sys

import pytest
import torch

from s2st_tpu.data import iterators as jit_
from s2st_tpu_torch.data import iterators as pit
from s2st_tpu_torch.train import checkpoint as pckpt
from tests._torch_port import one_thread  # noqa: F401
from tests.test_torch_iterators import (SETTINGS, assert_batch_equal, both,
                                        corpora)  # noqa: F401
from tests.test_torch_train import TINY_FLAGS


def loop_batches(p, uf=1):
    """The port CLI's wrapping of one epoch on the CPU."""
    return pit.DevicePrefetcher(pit.GroupedIterator(pit.BufferedIterator(
        p.next_epoch_itr()), uf), pit.device_put(torch.device("cpu")))


@pytest.mark.parametrize("setting,workers", [(0, 4), (1, 4), (1, 32)])
def test_pooled_batches_match_jax_over_two_epochs(corpora, setting,  # noqa: F811
                                                  workers):
    """32 workers (more than the cores) with a switch interval of 1 us
    stress the pool's hand-over: a batch collated or delivered out of
    place, or an item drawn from another's stream, would differ."""
    j, p = both(corpora[20], num_workers=workers, **SETTINGS[setting])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6 if workers > 4 else interval)
    try:
        for epoch in (1, 2):
            ref = list(j.next_epoch_itr())
            got = [dev for _, group in loop_batches(p) for dev in group]
            assert len(got) == len(ref) > 2
            for i, (g, r) in enumerate(zip(got, ref)):
                assert_batch_equal(g, r, msg=f"epoch {epoch} batch {i}")
    finally:
        sys.setswitchinterval(interval)
    assert p.epoch == j.epoch == 3 and p.iterations_in_epoch == 0


def test_mid_epoch_resume_counts_consumed_batches(corpora):  # noqa: F811
    kw = dict(num_workers=4, **SETTINGS[1])
    j, p = both(corpora[20], **kw)
    list(p.next_epoch_itr())                       # epoch 1
    batches_done = p.iterations_in_epoch           # 0, before the epoch
    itr = loop_batches(p)
    taken = [next(itr)[1][0] for _ in range(2)]
    batches_done += len(taken)
    state = {"epoch": 2, "iterations_in_epoch": batches_done,
             "shuffle": True}
    rest = [dev for _, group in itr for dev in group]
    fresh = both(corpora[20], **kw)[1]
    fresh.load_state_dict(state)
    resumed = [dev for _, group in loop_batches(fresh) for dev in group]
    assert len(resumed) == len(rest) > 0
    for g, r in zip(resumed, rest):
        assert g["id"] == r["id"]
    # the iterator ran ahead of the loop: its own count would skip batches
    p2 = both(corpora[20], **kw)[1]
    list(p2.next_epoch_itr())
    ahead = loop_batches(p2)
    next(ahead)
    assert p2.iterations_in_epoch > 1
    j.load_state_dict(state)
    ref = list(j.next_epoch_itr())
    assert len(ref) == len(resumed)
    for g, r in zip(resumed, ref):
        assert_batch_equal(g, r)


def test_buffered_iterator_and_prefetcher():
    def gen():
        yield from range(5)
        raise RuntimeError("collate failed")

    itr = pit.BufferedIterator(gen())
    assert [next(itr) for _ in range(5)] == list(range(5))
    with pytest.raises(RuntimeError, match="collate failed"):
        next(itr)
    readied = []

    def put(x):
        return ("pending", x)
    put.ready = lambda pending: readied.append(pending[1]) or pending[1] * 10
    out = list(pit.DevicePrefetcher(pit.GroupedIterator(iter(range(7)), 3),
                                    put, depth=2))
    assert [h for h, _ in out] == list(jit_.GroupedIterator(iter(range(7)),
                                                            3))
    assert [d for _, d in out] == [[0, 10, 20], [30, 40, 50], [60]]
    assert readied == list(range(7))


def _train(corpus, save, *extra):
    from s2st_tpu_torch.cli import train
    log = save / "log.jsonl"
    argv = [str(corpus), "--config-yaml", "config.yaml", "--train-subset",
            "train", "--save-dir", str(save), "--max-tokens", "100",
            "--batch-size", "3", "--task", "s2s_translation",
            "--criterion", "s2st_loss", "--arch", "s2st_transformer",
            "--device", "cpu", "--disable-validation", "--log-interval", "1",
            "--log-file", str(log), "--dropout", "0.1", "--seed", "3",
            *TINY_FLAGS, *extra]
    assert train.main(argv) == 0
    return [(r["num_updates"], r["loss"], r["gnorm"])
            for r in map(json.loads, log.read_text().splitlines())]


def test_cli_workers_and_mid_epoch_resume(corpora, tmp_path):  # noqa: F811
    corpus = corpora[20]
    one = _train(corpus, tmp_path / "w1", "--max-update", "6",
                 "--num-workers", "1")
    assert len(one) == 6
    # stopped at update 4, in the middle of epoch 1 (7 batches an epoch),
    # then resumed to 6
    save = tmp_path / "resume"
    first = _train(corpus, save, "--max-update", "4", "--num-workers", "4")
    meta = pckpt.peek_meta(str(save / "checkpoint_last.npz"))
    assert meta["iterator"] == {"epoch": 1, "iterations_in_epoch": 4,
                                "shuffle": True}
    second = _train(corpus, save, "--max-update", "6", "--num-workers", "4")
    assert first + second[len(first):] == one
