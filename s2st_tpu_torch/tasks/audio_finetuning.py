"""The CTC fine-tuning task and its dataset.

Counterpart of ``s2st_tpu/tasks/audio_finetuning.py`` (:31-190):
``--task audio_finetuning --arch wav2vec_ctc|hubert_ctc --criterion ctc``.

Data: the wav2vec manifest (``tasks/audio_pretraining.py``; rows shorter
than ``--min-sample-size`` left out) and the transcripts
``<label-dir>/<split>.<label>`` (a line of space-separated units per
manifest row: letters with "|" between words for ``ltr``) with
``dict.<label>.txt``, encoded without EOS. The audio is PADDED to the
batch's longest utterance (at most ``--max-sample-size``) snapped UP with
``snap_len(., 256)``, the labels to ``snap_len(longest, 8)`` with the pad
index; pad rows carry length 0 and pad-only targets. ``--w2v-path`` warm
starts the trunk (``models/ctc_asr.py::load_w2v_trunk``).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..data.dictionary import Dictionary
from ..data.iterators import snap_len
from .audio_pretraining import RawAudioDataset, layer_normalized

logger = logging.getLogger(__name__)


class FinetuneAudioDataset(RawAudioDataset):
    """``FinetuneAudioDataset`` (:31-107)."""

    def __init__(self, manifest_path: str, label_path: str,
                 dictionary: Dictionary, sample_rate: int = 16000,
                 max_sample_size: int = 250000, min_sample_size: int = 1,
                 normalize: bool = False):
        super().__init__(manifest_path, sample_rate=sample_rate,
                         max_sample_size=max_sample_size,
                         min_sample_size=min_sample_size,
                         normalize=normalize)
        self.dictionary = dictionary
        with open(label_path) as f:
            lines = f.read().splitlines()
        self.labels = [dictionary.encode_line(lines[i], append_eos=False)
                       for i in self.kept_rows]

    def item(self, index: int, rng: np.random.RandomState) -> Dict[str, Any]:
        item = super().item(index, rng)
        item["target"] = self.labels[index]
        return item

    def snap_kwargs(self, items: Sequence[Dict]) -> Dict[str, int]:
        return {"pad_batch": snap_len(len(items), 8),
                "target_size": snap_len(
                    min(max(len(it["wav"]) for it in items),
                        self.max_sample_size), 256),
                "label_size": snap_len(
                    max(len(it["target"]) for it in items), 8)}

    def collate(self, items: Sequence[Dict], pad_batch: Optional[int] = None,
                target_size: Optional[int] = None,
                label_size: Optional[int] = None) -> Dict[str, Any]:
        """Pad-to-longest (``collate``, :75-107): ``source``,
        ``source_lens``, ``id``, ``target`` (B, U) int64 and
        ``target_lengths``; ``ntokens`` counts the target units."""
        b = pad_batch or len(items)
        target = target_size if target_size is not None else min(
            max(len(it["wav"]) for it in items), self.max_sample_size)
        u = label_size if label_size is not None \
            else max(len(it["target"]) for it in items)
        source = np.zeros((b, target), np.float32)
        lens = np.zeros((b,), np.int64)
        ids = np.zeros((b,), np.int64)
        labels = np.full((b, u), self.dictionary.pad_index, np.int64)
        tgt_lens = np.zeros((b,), np.int64)
        for i, it in enumerate(items):
            wav = it["wav"][:target]
            if self.normalize:
                wav = layer_normalized(wav)
            source[i, :len(wav)] = wav
            lens[i], ids[i] = len(wav), it["id"]
            lab = it["target"][:u]
            labels[i, :len(lab)] = lab
            tgt_lens[i] = len(lab)
        return {"source": torch.from_numpy(source),
                "source_lens": torch.from_numpy(lens),
                "id": torch.from_numpy(ids),
                "target": torch.from_numpy(labels),
                "target_lengths": torch.from_numpy(tgt_lens),
                "nsentences": len(items), "ntokens": int(tgt_lens.sum())}


class AudioFinetuningTask:
    """``AudioFinetuningTask`` (:110-190): the first of ``--labels``
    (default ``ltr``) names the transcripts and their dictionary."""

    def __init__(self, args):
        self.args = args
        self.label = str(args.labels or "ltr").split(",")[0]
        self.label_dir = args.label_dir or args.data
        self.target_dictionary = Dictionary.load(
            os.path.join(self.label_dir, f"dict.{self.label}.txt"))

    def load_dataset(self, split: str) -> FinetuneAudioDataset:
        a = self.args
        return FinetuneAudioDataset(
            os.path.join(a.data, f"{split}.tsv"),
            os.path.join(self.label_dir, f"{split}.{self.label}"),
            self.target_dictionary, sample_rate=a.sample_rate,
            max_sample_size=a.max_sample_size,
            min_sample_size=a.min_sample_size, normalize=a.normalize)

    def build_model_config(self):
        from ..models.config_from_args import ctc_asr_config
        return ctc_asr_config(self.args, len(self.target_dictionary))

    def build_loss_config(self):
        """Blank is the dictionary's ``bos_index``, ``sep_idx`` its "|"."""
        from ..train.losses import CtcLossConfig
        d = self.target_dictionary
        return CtcLossConfig(
            zero_infinity=self.args.zero_infinity,
            sentence_avg=self.args.sentence_avg, pad_idx=d.pad_index,
            eos_idx=d.eos_index, blank_idx=d.bos_index,
            sep_idx=d.index("|") if "|" in d.indices else -1)

    def build_model_and_loss(self):
        """The seeded model, its trunk warm-started from ``--w2v-path``."""
        from ..models.ctc_asr import CtcAsrModel, load_w2v_trunk
        from ..train.losses import ctc_criterion
        cfg = self.build_model_config()
        model = CtcAsrModel(cfg).init_weights(self.args.seed)
        if self.args.w2v_path:
            logger.info(f"warm-starting trunk from {self.args.w2v_path}")
            load_w2v_trunk(model, self.args.w2v_path)
        return cfg, model, ctc_criterion


__all__ = ["FinetuneAudioDataset", "AudioFinetuningTask"]
