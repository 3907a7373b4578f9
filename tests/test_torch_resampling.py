"""s2st_tpu_torch's multi-corpus train splits against s2st_tpu's, on the CPU.

``--train-subset train_a,train_b,train_c`` over three TSVs cut from
``tests/make_tiny_corpus.py``'s train split (5, 4 and 3 rows; train_a and
train_b of one language pair, train_c of another, each with its own
``speaker`` value), against JAX's ``S2STDatasetCreator.from_tsv`` and
``EpochBatchIterator``:

- without ``sampling_alpha``, the rows concatenated in order;
- with ``sampling_alpha: 0.5``, the ratios pooled by language pair, each
  epoch's drawn rows (ids) for epochs 1-3, and each epoch's batches: the
  indices, the ids, the collated arrays and the speaker ids of
  ``--speaker-to-id``;
- a resume in the middle of epoch 2 from the iterator's state gives the
  batches the uninterrupted run gave.

Everything is exact: the draws and batches are integers, the arrays the
same file's values.
"""

from pathlib import Path

import numpy as np
import pytest

SPEAKERS = {"fisher_spanish": 0, "mls_spanish": 1}
# (split, rows of train.tsv, language pair, speaker)
CORPORA = (("train_a", slice(0, 5), ("es", "en"), "fisher_spanish"),
           ("train_b", slice(5, 9), ("es", "en"), "mls_spanish"),
           ("train_c", slice(9, 12), ("fr", "en"), "mls_spanish"))


def multi_corpus(root: Path, alpha=None) -> Path:
    """The tiny corpus with train_a/b/c TSVs (``CORPORA``) beside its own
    splits, and ``sampling_alpha`` in config.yaml when given."""
    from tests.make_tiny_corpus import make_tiny_corpus
    root = make_tiny_corpus(root)
    header, *rows = (root / "train.tsv").read_text().splitlines()
    cols = header.split("\t")
    for name, part, (src, tgt), speaker in CORPORA:
        lines = [header + "\tsrc_lang\ttgt_lang"]
        for row in rows[part]:
            vals = dict(zip(cols, row.split("\t")), speaker=speaker)
            lines.append("\t".join(vals[c] for c in cols) + f"\t{src}\t{tgt}")
        (root / f"{name}.tsv").write_text("\n".join(lines) + "\n")
    if alpha is not None:
        with open(root / "config.yaml", "a") as f:
            f.write(f"sampling_alpha: {alpha}\n")
    return root


SPLIT = ",".join(c[0] for c in CORPORA)


def both(root, speakers=None):
    """(JAX's dataset, the port's split) of SPLIT with seed 1."""
    from s2st_tpu.data.data_cfg import S2STDataConfig as JaxDataConfig
    from s2st_tpu.data.dictionary import Dictionary as JaxDictionary
    from s2st_tpu.data.s2st_dataset import S2STDatasetCreator
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit
    names = ("src_vocab.txt", "tgt_vocab.txt")
    jds = S2STDatasetCreator.from_tsv(
        str(root), JaxDataConfig(root / "config.yaml"), SPLIT,
        *[JaxDictionary.load(str(root / n)) for n in names],
        is_train_split=True, n_frames_per_step=2, speaker_to_id=speakers,
        seed=1)
    split = TrainSplit(str(root), S2STDataConfig(root / "config.yaml"), SPLIT,
                       *[Dictionary.load(str(root / n)) for n in names],
                       n_frames_per_step=2, speaker_to_id=speakers, seed=1)
    return jds, split


def test_corpora_concatenate_without_alpha(tmp_path):
    jds, split = both(multi_corpus(tmp_path / "c"))
    assert not split.resampled and jds.can_reuse_epoch_itr_across_epochs
    assert split.ids == jds.ids == [f"train_{i}" for i in range(12)]
    assert split.src_n_frames.tolist() == jds.src_n_frames.tolist()


@pytest.fixture(scope="module")
def resampled(tmp_path_factory):
    root = multi_corpus(tmp_path_factory.mktemp("resampling") / "c",
                        alpha=0.5)
    return root, both(root, SPEAKERS)


def test_pooled_ratios_and_draws_match_jax(resampled):
    from s2st_tpu_torch.data.s2st_dataset import resample
    _, (jds, split) = resampled
    assert split.ratios == jds._resample["ratios"]
    # train_a and train_b share a pair, so one ratio; train_c is upsampled
    assert split.ratios[0] == split.ratios[1] < 1.0 < split.ratios[2]
    for epoch in (1, 2, 3):
        jds.set_epoch(epoch)
        split.set_epoch(epoch)
        assert split.ids == jds.ids, epoch
        assert split.src_n_frames.tolist() == jds.src_n_frames.tolist()
        assert [s["id"] for s in resample(split.corpora, split.ratios, 1,
                                          epoch)] == jds.ids
    draws = [resample(split.corpora, split.ratios, 1, e) for e in (1, 2)]
    assert [s["id"] for s in draws[0]] != [s["id"] for s in draws[1]]


def _epochs(itr, n, stop_after=None):
    """{epoch: [its collated batches]} of n epochs; with stop_after
    (epoch, k), the run stops after that epoch's k-th batch."""
    out = {}
    for _ in range(n):
        epoch = itr.epoch
        out[epoch] = []
        for batch in itr.next_epoch_itr():
            out[epoch].append(batch)
            if stop_after == (epoch, len(out[epoch])):
                return out
    return out


def test_epoch_batches_match_jax(resampled):
    from s2st_tpu.data.iterators import EpochBatchIterator as JaxIterator
    from s2st_tpu_torch.data.iterators import EpochBatchIterator
    _, (jds, split) = resampled
    kw = dict(max_tokens=100, seed=1, required_batch_size_multiple=2)
    jitr = JaxIterator(jds, **kw)
    itr = EpochBatchIterator(split, **kw)
    ref = {}
    for epoch in (1, 2, 3):
        ref[epoch] = list(jitr.next_epoch_itr(shuffle=True))
    got = _epochs(itr, 3)
    assert list(got) == [1, 2, 3]
    for epoch in (1, 2, 3):
        assert len(got[epoch]) == len(ref[epoch]) > 1, epoch
        for g, r in zip(got[epoch], ref[epoch]):
            # JAX marks its pad rows' ids -1
            assert g["id"] == [int(i) for i in r["id"] if i >= 0], epoch
            for key in ("src_speech", "tgt_speech", "src_text", "tgt_text",
                        "speaker"):
                np.testing.assert_array_equal(g[key].numpy(), r[key],
                                              err_msg=key)
    assert [b["id"] for b in got[1]] != [b["id"] for b in got[2]]
    assert {int(s) for b in got[1] for s in b["speaker"][:b["nsentences"]]} \
        == {0, 1}


def test_resume_mid_epoch_draws_the_same_batches(resampled):
    from s2st_tpu_torch.data.iterators import EpochBatchIterator
    _, (_, split) = resampled
    kw = dict(max_tokens=100, seed=1, required_batch_size_multiple=2)
    whole = _epochs(EpochBatchIterator(split, **kw), 3)
    first = EpochBatchIterator(split, **kw)
    _epochs(first, 3, stop_after=(2, 1))
    state = first.state_dict()
    assert state["epoch"] == 2 and state["iterations_in_epoch"] == 1
    split.set_epoch(3)      # another epoch's rows in between
    resumed = EpochBatchIterator(split, **kw)
    resumed.load_state_dict(state)
    rest = _epochs(resumed, 2)
    assert [b["id"] for b in rest[2]] == [b["id"] for b in whole[2][1:]]
    assert [b["id"] for b in rest[3]] == [b["id"] for b in whole[3]]
    for g, w in zip(rest[2], whole[2][1:]):
        np.testing.assert_array_equal(g["src_speech"].numpy(),
                                      w["src_speech"].numpy())
