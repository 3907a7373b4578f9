"""The training split: items and collate.

Counterpart of what stage 5 reads of ``s2st_tpu/data/s2st_dataset.py``:
``__getitem__`` (:183-227: source and target features through the split's
transforms, source first, both drawing SpecAugment from the item's stream;
under the data config's ``use_hubert`` the source is the raw waveform,
which the item keeps under ``src_speech`` where JAX keeps ``src_orig``;
targets packed by ``n_frames_per_step``; text encoded with eos appended)
and ``collate`` (:233-323: rows sorted by source length, descending;
``prev_output_tokens`` a zero BOS frame then the shifted target; the text
shifted with eos moved to the front; the token counts; padded to the
given static shapes, with rows past the batch's of length 0; waveforms
collate to a (B, L) source, :260-275), with each row's speaker id under
``speaker`` where the split has a ``--speaker-to-id`` map (:208-210,
:300-325), and FastSpeech2's ``duration``, ``pitch`` and ``energy``
columns (space-separated, or ``.npy`` paths; :49-52, :102-110, :225-227)
padded with 0 into ``durations``, ``pitches`` and ``energies`` (B, source
tokens) where the batch's first row has a duration (:326-345). Batches
and their order come from ``data/iterators.py``, whose pads then count
samples.

A train split of several corpora (``--train-subset train_a,train_b``)
under a ``sampling_alpha`` other than 1.0 is resampled by temperature
(``S2STDatasetCreator.from_tsv``, :365-400, and ``set_epoch``, :135-150):
each corpus's ratio comes from the source frames pooled by its
(src_lang, tgt_lang) pair (by corpus where the TSV has neither column),
and every epoch draws ceil(len * ratio) of its rows with
``RandomState([42, seed, epoch]).choice``, with replacement where the
ratio is at least 1; the iterator forms that epoch's batches anew.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .audio_utils import get_features, get_features_or_waveform
from .data_cfg import S2STDataConfig
from .dictionary import Dictionary
from .manifest import Manifest, pack_frames

PAD = 1
# FastSpeech2's per-token targets: (manifest column, batch key, dtype)
# (:49-52, :326-345)
VARIANCE_COLUMNS = (("duration", "durations", np.int64),
                    ("pitch", "pitches", np.float32),
                    ("energy", "energies", np.float32))

logger = logging.getLogger(__name__)


def resampling_ratios(corpora: List[List[Dict[str, str]]], alpha: float
                      ) -> List[float]:
    """Each corpus's size ratio of temperature ``alpha`` (the reference's
    get_size_ratios, pooled by language pair, s2st_dataset.py:368-393)."""
    def pair(rows, k):
        s = rows[0] if rows else {}
        return (s.get("src_lang", ""), s.get("tgt_lang", "")) \
            if ("src_lang" in s or "tgt_lang" in s) else ("", f"#{k}")
    pairs = [pair(rows, k) for k, rows in enumerate(corpora)]
    sizes = np.array([sum(int(s["src_n_frames"]) for s in rows)
                      for rows in corpora], np.float64)
    pooled: Dict = {}
    for p, sz in zip(pairs, sizes):
        pooled[p] = pooled.get(p, 0.0) + sz
    total = sum(pooled.values())
    prob = {p: (v / total) ** alpha for p, v in pooled.items()}
    prob_sum = sum(prob.values())
    return [float((prob[p] / prob_sum) * total / pooled[p]) for p in pairs]


def resample(corpora: List[List[Dict[str, str]]], ratios: Sequence[float],
             seed: int, epoch: int) -> List[Dict[str, str]]:
    """One epoch's rows: ceil(len * ratio) of each corpus in turn, drawn
    by ``RandomState([42, seed, epoch])`` (a fresh one a corpus), with
    replacement where the ratio is at least 1 (set_epoch, :135-150)."""
    drawn = []
    for rows, ratio in zip(corpora, ratios):
        n = int(np.ceil(len(rows) * ratio))
        rng = np.random.RandomState([42, seed % (2 ** 32), epoch])
        drawn.extend(rows[i] for i in rng.choice(len(rows), n,
                                                 replace=ratio >= 1.0))
    return drawn


class TrainSplit(Manifest):
    def __init__(self, root: str, cfg: S2STDataConfig, split: str,
                 src_dict: Dictionary, tgt_dict: Dictionary,
                 n_frames_per_step: int = 1,
                 speaker_to_id: Optional[Dict[str, int]] = None,
                 seed: int = 1):
        super().__init__(root, cfg, split)
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict
        self.n_frames_per_step = n_frames_per_step
        self.speaker_to_id = speaker_to_id
        self.seed = seed
        self.ratios = None
        if split.startswith("train") and len(self.corpora) > 1 \
                and cfg.sampling_alpha != 1.0:
            self.ratios = resampling_ratios(self.corpora, cfg.sampling_alpha)
            logger.info(f"temperature resampling (alpha="
                        f"{cfg.sampling_alpha}): ratios="
                        f"{[round(r, 3) for r in self.ratios]}")
            self.set_epoch(1)

    @property
    def resampled(self) -> bool:
        """Whether each epoch draws its own rows (and batches)."""
        return self.ratios is not None

    def set_epoch(self, epoch: int) -> None:
        """Draw the epoch's rows of a resampled split; else nothing."""
        if self.ratios is not None:
            self.set_samples(resample(self.corpora, self.ratios, self.seed,
                                      epoch))

    def __len__(self) -> int:
        return len(self.samples)

    def item(self, index: int,
             rng: Optional[np.random.RandomState] = None
             ) -> Dict[str, np.ndarray]:
        """One utterance; SpecAugment draws from ``rng`` (the item's stream
        of ``iterators.EpochBatchIterator``; numpy's global one without)."""
        s = self.samples[index]
        src = self.source(index, rng)
        tgt = pack_frames(self.tgt_transforms(get_features(s["tgt_audio"]),
                                              rng), self.n_frames_per_step)
        item = {"index": index, "src_speech": src, "tgt_speech": tgt,
                "src_text": self.src_dict.encode_line(s.get("src_text", "")),
                "tgt_text": self.tgt_dict.encode_line(s.get("tgt_text", ""))}
        if self.speaker_to_id is not None:
            # an unknown speaker is 0 (s2st_dataset.py:208-210)
            item["speaker"] = self.speaker_to_id.get(s.get("speaker", ""), 0)
        for col, _, dtype in VARIANCE_COLUMNS:
            if s.get(col):
                item[col] = variance(s[col], dtype)
        return item

    def collate(self, items: List[Dict[str, np.ndarray]], **pads
                ) -> Dict[str, Any]:
        return collate(items, **pads)


def collate(items: List[Dict[str, np.ndarray]],
            pad_batch: Optional[int] = None, pad_src_t: Optional[int] = None,
            pad_tgt_t: Optional[int] = None,
            pad_src_txt: Optional[int] = None,
            pad_tgt_txt: Optional[int] = None) -> Dict[str, Any]:
    """Pad a list of items to the given shapes (the batch maxima by
    default), rows sorted by source length, longest first; rows past the
    items have length 0. Tensors are on the CPU; the token counts are
    Python ints."""
    order = np.argsort([-it["src_speech"].shape[0] for it in items],
                       kind="stable")
    items = [items[i] for i in order]
    b = pad_batch or len(items)
    src_t = pad_src_t or max(it["src_speech"].shape[0] for it in items)
    tgt_t = pad_tgt_t or max(it["tgt_speech"].shape[0] for it in items)
    src_n = pad_src_txt or max(len(it["src_text"]) for it in items)
    tgt_n = pad_tgt_txt or max(len(it["tgt_text"]) for it in items)
    feat_shape = items[0]["src_speech"].shape[1:]
    out_dim = items[0]["tgt_speech"].shape[1]

    src_speech = np.zeros((b, src_t) + feat_shape, np.float32)
    tgt_speech = np.zeros((b, tgt_t, out_dim), np.float32)
    prev_output = np.zeros((b, tgt_t, out_dim), np.float32)
    texts = {k: np.full((b, n), PAD, np.int64) for k, n in (
        ("src_text", src_n), ("tgt_text", tgt_n),
        ("prev_src_text_tokens", src_n), ("prev_tgt_text_tokens", tgt_n))}
    lens = {k: np.zeros((b,), np.int64) for k in (
        "src_speech_lens", "target_lengths", "src_text_len", "tgt_text_len")}
    for i, it in enumerate(items):
        src, tgt = it["src_speech"], it["tgt_speech"]
        src_speech[i, :len(src)] = src
        tgt_speech[i, :len(tgt)] = tgt
        prev_output[i, 1:len(tgt)] = tgt[:-1]
        lens["src_speech_lens"][i] = len(src)
        lens["target_lengths"][i] = len(tgt)
        for side in ("src", "tgt"):
            text = it[f"{side}_text"]
            texts[f"{side}_text"][i, :len(text)] = text
            texts[f"prev_{side}_text_tokens"][i, 0] = text[-1]
            texts[f"prev_{side}_text_tokens"][i, 1:len(text)] = text[:-1]
            lens[f"{side}_text_len"][i] = len(text)
    batch: Dict[str, Any] = {
        "id": [it["index"] for it in items],
        "nsentences": len(items),
        "ntokens": int(lens["target_lengths"].sum()),
        "src_txt_ntokens": int(lens["src_text_len"].sum()),
        "tgt_txt_ntokens": int(lens["tgt_text_len"].sum()),
        "src_speech": torch.from_numpy(src_speech),
        "prev_output_tokens": torch.from_numpy(prev_output),
        "tgt_speech": torch.from_numpy(tgt_speech),
    }
    batch.update({k: torch.from_numpy(v) for k, v in texts.items()})
    batch.update({k: torch.from_numpy(v) for k, v in lens.items()})
    if "speaker" in items[0]:
        speaker = np.zeros((b,), np.int64)   # pad rows: speaker 0
        speaker[:len(items)] = [it["speaker"] for it in items]
        batch["speaker"] = torch.from_numpy(speaker)
    if "duration" in items[0]:
        # one value a source token, 0 past each row's values (:326-345)
        for col, key, dtype in VARIANCE_COLUMNS:
            arr = np.zeros((b, src_n), dtype)
            for i, it in enumerate(items):
                if col in it:
                    v = it[col][:src_n]
                    arr[i, :len(v)] = v
            batch[key] = torch.from_numpy(arr)
    return batch


def variance(value: str, dtype) -> np.ndarray:
    """A FastSpeech2 variance column's value: space-separated numbers, or
    a ``.npy`` path (or zip slice, with a ``:``) read as features
    (``_variance``, s2st_dataset.py:219-225)."""
    if value.endswith(".npy") or ":" in value:
        return np.asarray(get_features_or_waveform(value), dtype)
    return np.asarray(value.split(), dtype)


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch with its tensors on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}
