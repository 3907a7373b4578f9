"""The generation split: TSV manifest, features, transforms and batches.

Reads what stage 7 reads of ``s2st_tpu/data/s2st_dataset.py``: the TSV
(``_load_tsv``, :55) with paths taken from ``audio_root``, source fbank
features through the split's global-CMVN transform
(``data/feature_transforms.py:60-89``), and, for teacher forcing, the
packed target log-mels. Batches are the JAX batcher's greedy
length-descending split under ``max_tokens`` (longest * rows) and
``batch_size``; they are padded to the batch maximum, not bucketed.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .audio_utils import get_features
from .data_cfg import S2STDataConfig

logger = logging.getLogger(__name__)

_CMVN = ("global_cmvn", "src_global_cmvn", "tgt_global_cmvn")


def load_tsv(path: Path) -> List[Dict[str, str]]:
    with open(path, encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t", quotechar=None,
                                doublequote=False, lineterminator="\n",
                                quoting=csv.QUOTE_NONE)
        return [dict(e) for e in reader]


def pack_frames(feature: np.ndarray, n_frames_per_step: int) -> np.ndarray:
    """(T, d) -> (T // n, n * d)."""
    if n_frames_per_step == 1:
        return feature
    n = feature.shape[0] // n_frames_per_step
    return feature[:n * n_frames_per_step].reshape(n, -1)


class _Transforms:
    """A split's feature transforms; only global CMVN runs at generation."""

    def __init__(self, cfg: S2STDataConfig, names: Optional[List[str]]):
        self.stats = []
        for name in names or []:
            if name not in _CMVN:
                raise NotImplementedError(
                    f"feature transform {name!r} is not ported")
            stats = np.load(cfg.cmvn_stats_path(name))
            self.stats.append((stats["mean"].astype(np.float32),
                               stats["std"].astype(np.float32)))

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        for mean, std in self.stats:
            x = (x - mean) / std
        return x


class GenerationSplit:
    def __init__(self, root: str, cfg: S2STDataConfig, split: str,
                 n_frames_per_step: int = 1):
        tsv = Path(root) / f"{split}.tsv"
        if not tsv.is_file():
            raise FileNotFoundError(f"Dataset not found: {tsv}")
        self.samples = load_tsv(tsv)
        audio_root = Path(cfg.audio_root)
        for s in self.samples:
            for k in ("src_audio", "tgt_audio"):
                if s.get(k) and not s[k].startswith("/"):
                    s[k] = (audio_root / s[k]).as_posix()
        self.ids = [s["id"] for s in self.samples]
        self.src_n_frames = np.array([int(s["src_n_frames"])
                                      for s in self.samples])
        self.n_frames_per_step = n_frames_per_step
        is_train = split.startswith("train")
        self.src_transforms = _Transforms(
            cfg, cfg.transforms_for("src_transforms", split, is_train))
        self.tgt_transforms = _Transforms(
            cfg, cfg.transforms_for("tgt_transforms", split, is_train))

    def batches(self, max_tokens: Optional[int],
                batch_size: Optional[int]) -> List[List[int]]:
        """Indices, longest first, cut greedily so that rows * longest
        stays within max_tokens and rows within batch_size
        (data/iterators.py:54-90; samples longer than max_tokens skipped)."""
        lengths = self.src_n_frames
        order = np.lexsort((np.arange(len(lengths)), lengths))[::-1]
        out: List[List[int]] = []
        cur: List[int] = []
        for idx in order:
            ln = int(lengths[idx])
            if max_tokens and ln > max_tokens:
                logger.warning(f"skipping sample {idx}: length {ln} > "
                               f"max_tokens")
                continue
            longest = int(lengths[cur[0]]) if cur else ln  # longest first
            if cur and ((max_tokens and (len(cur) + 1) * longest > max_tokens)
                        or (batch_size and len(cur) >= batch_size)):
                out.append(cur)
                cur = []
            cur.append(int(idx))
        if cur:
            out.append(cur)
        return out

    def collate(self, indices: List[int], with_target: bool = False
                ) -> Dict[str, object]:
        """Pad a batch; rows longest first. src_speech (B, T, F) fp32,
        src_speech_lens (B,); with_target adds prev_output_tokens (zero
        first frame, shifted targets) and target_lengths, in packed frames."""
        src = [self.src_transforms(get_features(self.samples[i]["src_audio"]))
               for i in indices]
        order = np.argsort([-x.shape[0] for x in src], kind="stable")
        indices = [indices[i] for i in order]
        src = [src[i] for i in order]
        b, t = len(src), max(x.shape[0] for x in src)
        src_speech = np.zeros((b, t, src[0].shape[1]), np.float32)
        for i, x in enumerate(src):
            src_speech[i, :x.shape[0]] = x
        batch: Dict[str, object] = {
            "ids": [self.ids[i] for i in indices],
            "src_speech": torch.from_numpy(src_speech),
            "src_speech_lens": torch.tensor([x.shape[0] for x in src]),
        }
        if with_target:
            tgt = [pack_frames(self.tgt_transforms(
                get_features(self.samples[i]["tgt_audio"])),
                self.n_frames_per_step) for i in indices]
            tt = max(x.shape[0] for x in tgt)
            prev = np.zeros((b, tt, tgt[0].shape[1]), np.float32)
            for i, x in enumerate(tgt):
                prev[i, 1:x.shape[0]] = x[:-1]
            batch["prev_output_tokens"] = torch.from_numpy(prev)
            batch["target_lengths"] = torch.tensor([x.shape[0] for x in tgt])
        return batch
