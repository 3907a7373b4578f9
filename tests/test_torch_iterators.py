"""s2st_tpu_torch's epoch batches against s2st_tpu's EpochBatchIterator.

On small corpora whose source lengths tie often, with SpecAugment on both
sides of the train split, over 3 epochs and several --max-tokens /
--batch-size / --required-batch-size-multiple settings (with the
max-positions filter and length buckets in some):

- the index lists of every epoch's batches equal JAX's;
- every collated batch equals JAX's: the SpecAugment-ed source and target
  arrays, drawn source first from the item's own stream, the static pads
  and the counts;
- a ``state_dict`` taken in the middle of an epoch and loaded into a fresh
  iterator yields the batches that were left;
- ``GroupedIterator`` groups as JAX's does.

Every comparison is an exact equality: the same numpy draws and the same
float32 arithmetic on both sides.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from s2st_tpu.data import iterators as jit_
from s2st_tpu.data.data_cfg import S2STDataConfig as JaxDataConfig
from s2st_tpu.data.dictionary import Dictionary as JaxDictionary
from s2st_tpu.data.s2st_dataset import S2STDatasetCreator
from s2st_tpu_torch.data import iterators as pit
from s2st_tpu_torch.data.data_cfg import S2STDataConfig
from s2st_tpu_torch.data.dictionary import Dictionary
from s2st_tpu_torch.data.s2st_dataset import TrainSplit
from tests.make_tiny_corpus import make_tiny_corpus

TIED_LENGTHS = (20, 24, 24, 32, 32, 32, 41, 48)
SPECAUGMENT = """src_transforms:
  _train:
  - specaugment
tgt_transforms:
  '*':
  - tgt_global_cmvn
  _train:
  - tgt_global_cmvn
  - specaugment
specaugment:
  freq_mask_F: 3
  freq_mask_N: 2
  time_mask_N: 2
  time_mask_T: 6
  time_mask_p: 1.0
"""


def tied_corpus(root: Path, n_train: int, seed: int) -> Path:
    """make_tiny_corpus with source lengths drawn from TIED_LENGTHS and
    SpecAugment on both sides of the train split."""
    corpus = make_tiny_corpus(root, n_train=n_train, seed=seed)
    tsv = corpus / "train.tsv"
    with open(tsv, encoding="utf-8") as f:
        rows = list(csv.DictReader(f, delimiter="\t",
                                   quoting=csv.QUOTE_NONE))
    r = np.random.RandomState(seed)
    for row in rows:
        n = int(r.choice(TIED_LENGTHS))
        np.save(corpus / row["src_audio"],
                r.randn(n, 8).astype(np.float32))
        row["src_n_frames"] = n
    with open(tsv, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t",
                           quoting=csv.QUOTE_NONE)
        w.writeheader()
        w.writerows(rows)
    cfg = (corpus / "config.yaml").read_text()
    cfg = cfg[:cfg.index("tgt_transforms:")] + SPECAUGMENT + \
        cfg[cfg.index("tgt_global_cmvn:\n  stats_npz_path"):]
    (corpus / "config.yaml").write_text(cfg)
    return corpus


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    return {n: tied_corpus(tmp_path_factory.mktemp(f"tied{n}"), n, seed=n)
            for n in (13, 20)}


def both(corpus, seed=1, **kw):
    """(JAX EpochBatchIterator, port EpochBatchIterator) over the train
    split with the same options."""
    jdicts = [JaxDictionary.load(str(corpus / f))
              for f in ("src_vocab.txt", "tgt_vocab.txt")]
    jds = S2STDatasetCreator.from_tsv(
        str(corpus), JaxDataConfig(corpus / "config.yaml"), "train",
        *jdicts, is_train_split=True, n_frames_per_step=2)
    dicts = [Dictionary.load(str(corpus / f))
             for f in ("src_vocab.txt", "tgt_vocab.txt")]
    split = TrainSplit(str(corpus), S2STDataConfig(corpus / "config.yaml"),
                       "train", *dicts, n_frames_per_step=2)
    return (jit_.EpochBatchIterator(jds, seed=seed, **kw),
            pit.EpochBatchIterator(split, seed=seed, **kw))


SETTINGS = [
    dict(max_tokens=200),
    dict(max_tokens=100, max_sentences=3),
    dict(max_tokens=1000, max_sentences=5, required_batch_size_multiple=2),
    dict(max_tokens=400, required_batch_size_multiple=8, max_positions=41),
    dict(max_tokens=64, num_batch_buckets=3),
]
KEYS = ("src_speech", "src_speech_lens", "prev_output_tokens", "tgt_speech",
        "target_lengths", "src_text", "src_text_len", "tgt_text",
        "tgt_text_len", "prev_src_text_tokens", "prev_tgt_text_tokens")
COUNTS = ("nsentences", "ntokens", "src_txt_ntokens", "tgt_txt_ntokens")


def assert_batch_equal(got, ref, msg=""):
    for key in KEYS:
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert g.shape == r.shape, (msg, key, g.shape, r.shape)
        assert np.array_equal(g, r), (msg, key)
    for key in COUNTS:
        assert got[key] == ref[key], (msg, key)
    assert got["id"] == [int(i) for i in ref["id"] if i >= 0], msg


@pytest.mark.parametrize("n", [13, 20])
@pytest.mark.parametrize("setting", range(len(SETTINGS)))
def test_epoch_batches_match_jax(corpora, n, setting):
    kw = SETTINGS[setting]
    j, p = both(corpora[n], seed=n, **kw)
    assert [b.tolist() for b in p.frozen_batches()] == \
        [b.tolist() for b in j._get_frozen_batches()]
    for epoch in (1, 2, 3):
        ref = [b.tolist() for b in j._batches_for_epoch(epoch)]
        assert [b.tolist() for b in p.batches_for_epoch(epoch)] == ref, epoch
    if len(p.frozen_batches()) > 2:      # the order moves with the epoch
        assert len({tuple(map(tuple, map(list, p.batches_for_epoch(e))))
                    for e in (1, 2, 3)}) > 1


@pytest.mark.parametrize("setting", [0, 1, 4])
def test_collated_batches_match_jax_over_three_epochs(corpora, setting):
    """Every batch of 3 epochs: the items' SpecAugment draws (source, then
    target, from the item's stream of its epoch) and the static pads."""
    j, p = both(corpora[13], **SETTINGS[setting])
    for epoch in (1, 2, 3):
        got, ref = list(p.next_epoch_itr()), list(j.next_epoch_itr())
        assert len(got) == len(ref) > 0
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_batch_equal(g, r, msg=f"epoch {epoch} batch {i}")
    assert p.epoch == j.epoch == 4


def test_item_specaugment_matches_jax(corpora):
    """One item at epoch 2: its source and target after SpecAugment; the
    augmentation moves them, and a target drawn before its source would
    not match."""
    j, p = both(corpora[20], max_tokens=1000)
    j.epoch = p.epoch = 2
    for index in (0, 7):
        got, ref = p.fetch_item(index), j._fetch_item(index)
        assert np.array_equal(got["src_speech"], ref.src_speech)
        assert np.array_equal(got["tgt_speech"], ref.tgt_speech)
        raw = np.load(corpora[20] / "features" / f"train_{index}_src.npy")
        assert not np.array_equal(got["src_speech"], raw)
    p.epoch = 3
    assert not np.array_equal(p.fetch_item(7)["src_speech"],
                              j._fetch_item(7).src_speech)


@pytest.mark.parametrize("taken", [1, 3])
def test_state_dict_mid_epoch_resumes_the_remaining_batches(corpora, taken):
    kw = SETTINGS[1]
    j, p = both(corpora[20], **kw)
    list(p.next_epoch_itr())                       # epoch 1
    itr = p.next_epoch_itr()
    for _ in range(taken):
        next(itr)
    state = p.state_dict()
    assert state == {"epoch": 2, "iterations_in_epoch": taken,
                     "shuffle": True}
    rest = list(itr)
    fresh = both(corpora[20], **kw)[1]
    fresh.load_state_dict(state)
    resumed = list(fresh.next_epoch_itr())
    assert len(resumed) == len(rest) > 0
    for g, r in zip(resumed, rest):
        assert g["id"] == r["id"]
        assert all(torch.equal(g[k], r[k]) for k in KEYS)
    assert fresh.epoch == 3 and fresh.iterations_in_epoch == 0
    # and they are JAX's remaining batches of epoch 2
    j.load_state_dict(state)
    ref = list(j.next_epoch_itr())
    assert len(ref) == len(resumed)
    for g, r in zip(resumed, ref):
        assert_batch_equal(g, r)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_grouped_iterator_matches_jax(chunk):
    for n in range(8):
        items = list(range(n))
        assert list(pit.GroupedIterator(iter(items), chunk)) == \
            list(jit_.GroupedIterator(iter(items), chunk))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100, 250, 1000])
def test_snap_len_and_item_seed_match_jax(n):
    assert pit.snap_len(n) == jit_.snap_len(n)
    assert pit.snap_len(n, 8) == jit_.snap_len(n, 8)
    assert pit.item_seed(1, 3, n) == \
        (1 * 1_000_003 + 3 * 8191 + n) % 2 ** 32
