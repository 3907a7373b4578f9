"""The HuBERT pretraining task and its dataset.

Counterpart of ``s2st_tpu/tasks/hubert_pretraining.py`` (:45-226):
``--task hubert_pretraining --arch hubert --criterion hubert``.

Data: the wav2vec manifest (``tasks/audio_pretraining.py``) and, for each
``--labels`` stream, ``<label-dir>/<split>.<label>`` (a line of
space-separated units per manifest row, kept rows picked by their ORIGINAL
row, so the min-size filter cannot shift them) with its
``dict.<label>.txt``. The audio is cropped as in audio pretraining and each
label stream in step with it: ``frm_size = round(target * label_rate /
sample_rate)`` units from ``round(start * label_rate / sample_rate)``. The
crop's start is clamped left so that every stream's window fits (JAX's
static-shape stand-in for fairseq's shrink, :120-143); a stream still
short is padded with its last unit.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.dictionary import Dictionary
from .audio_pretraining import RawAudioDataset

logger = logging.getLogger(__name__)


class HubertPretrainDataset(RawAudioDataset):
    """``HubertPretrainDataset`` (:45-146)."""

    def __init__(self, manifest_path: str, label_paths: Sequence[str],
                 dictionaries: Sequence[Dictionary], label_rate: float,
                 sample_rate: int = 16000, max_sample_size: int = 250000,
                 min_sample_size: int = 32000, normalize: bool = False):
        super().__init__(manifest_path, sample_rate=sample_rate,
                         max_sample_size=max_sample_size,
                         min_sample_size=min_sample_size,
                         normalize=normalize)
        self.label_rate = float(label_rate)
        self.dictionaries = list(dictionaries)
        self.labels: List[List[np.ndarray]] = []   # [stream][kept row]
        for path, d in zip(label_paths, dictionaries):
            with open(path) as f:
                lines = f.read().splitlines()
            self.labels.append([d.encode_line(lines[i], append_eos=False)
                                for i in self.kept_rows])

    def item(self, index: int, rng: np.random.RandomState) -> Dict[str, Any]:
        item = super().item(index, rng)
        item["labels"] = [enc[index] for enc in self.labels]
        return item

    def collate(self, items: Sequence[Dict], pad_batch: Optional[int] = None,
                target_size: Optional[int] = None) -> Dict[str, Any]:
        """The audio as ``RawAudioDataset.collate`` crops it, and
        ``target_list`` (streams, B, frm_size) int64, pad rows holding each
        dictionary's pad index."""
        b = pad_batch or len(items)
        target = target_size if target_size is not None else min(
            min(len(it["wav"]) for it in items), self.max_sample_size)
        s2f = self.label_rate / self.sample_rate
        frm_size = int(round(target * s2f))
        source = np.zeros((b, target), np.float32)
        lens = np.zeros((b,), np.int64)
        ids = np.zeros((b,), np.int64)
        targets = np.stack([np.full((b, frm_size), d.pad_index, np.int64)
                            for d in self.dictionaries])
        for i, it in enumerate(items):
            max_start = None
            if len(it["wav"]) > target and s2f > 0:
                min_rem = min(len(lab) for lab in it["labels"])
                max_start = int(max(min_rem - frm_size, 0) / s2f)
            wav, start = self.crop(it, target, max_start)
            source[i, :len(wav)] = wav
            lens[i], ids[i] = len(wav), it["id"]
            frm_start = int(round(start * s2f))
            for s, lab in enumerate(it["labels"]):
                win = lab[frm_start:frm_start + frm_size]
                if len(win) < frm_size and len(lab):
                    logger.warning(
                        "label stream %d row %d short (%d < %d frames); "
                        "padding with last unit", s, it["id"], len(win),
                        frm_size)
                    win = np.concatenate(
                        [win, np.full(frm_size - len(win),
                                      lab[-1] if len(win) == 0 else win[-1],
                                      np.int32)])
                targets[s, i, :len(win)] = win
        return {"source": torch.from_numpy(source),
                "source_lens": torch.from_numpy(lens),
                "id": torch.from_numpy(ids),
                "target_list": torch.from_numpy(targets),
                "nsentences": len(items), "ntokens": int(lens.sum())}


class HubertPretrainingTask:
    """``HubertPretrainingTask`` (:149-226): ``--labels`` (comma list),
    ``--label-dir`` (default the data dir), ``--label-rate``."""

    def __init__(self, args):
        self.args = args
        self.label_dir = args.label_dir or args.data
        self.labels = [x for x in str(args.labels or "km").split(",")]
        self.dictionaries = [
            Dictionary.load(os.path.join(self.label_dir, f"dict.{lbl}.txt"))
            for lbl in self.labels]

    def load_dataset(self, split: str) -> HubertPretrainDataset:
        a = self.args
        return HubertPretrainDataset(
            os.path.join(a.data, f"{split}.tsv"),
            [os.path.join(self.label_dir, f"{split}.{lbl}")
             for lbl in self.labels],
            self.dictionaries, label_rate=a.label_rate,
            sample_rate=a.sample_rate, max_sample_size=a.max_sample_size,
            min_sample_size=a.min_sample_size, normalize=a.normalize)

    def build_model_config(self):
        from ..models.config_from_args import hubert_pretrain_config
        return hubert_pretrain_config(
            self.args, tuple(len(d) for d in self.dictionaries))

    def build_loss_config(self):
        """The first of ``--loss-weights`` weighs the features penalty."""
        from ..train.losses import HubertLossConfig
        pen = float(str(self.args.loss_weights or "10").split(",")[0])
        return HubertLossConfig(
            pred_masked_weight=self.args.pred_masked_weight,
            pred_nomask_weight=self.args.pred_nomask_weight,
            features_pen_weight=pen)

    def build_model_and_loss(self):
        from ..models.hubert import HubertPretrainModel
        from ..train.losses import hubert_loss
        cfg = self.build_model_config()
        return cfg, HubertPretrainModel(cfg).init_weights(self.args.seed), \
            hubert_loss


__all__ = ["HubertPretrainDataset", "HubertPretrainingTask"]
