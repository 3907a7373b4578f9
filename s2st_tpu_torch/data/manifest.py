"""TSV manifests, feature transforms, and the generation split.

Reads what stages 5 and 7 read of ``s2st_tpu/data/s2st_dataset.py``: the
TSV (``_load_tsv``, :55) with paths taken from ``audio_root``, features
through the split's transforms (``data/feature_transforms.py``: global
and utterance CMVN, SpecAugment) and the packed target log-mels. With the data
config's ``use_hubert`` the source is instead the raw waveform of the
``src_orig`` column (``src_audio`` where it is empty), untransformed
(:158-166). Generation batches are the JAX batcher's greedy
length-descending split under ``max_tokens`` (longest * rows),
``batch_size`` and ``required_batch_size_multiple``
(``iterators.batch_by_size``); feature batches are padded to the batch
maximum, waveform batches to ``snap_len`` of it, as JAX's iterator pads
them: the frontend's GroupNorm takes its statistics over the padded
samples too, so the pad is part of the result.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from .audio_utils import get_features, get_features_or_waveform
from .data_cfg import S2STDataConfig
from .iterators import batch_by_size, ordered_indices, snap_len

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


def spec_augment(spec: np.ndarray, conf: Dict, rng: np.random.RandomState
                 ) -> np.ndarray:
    """Time warp and frequency/time masks (feature_transforms.py:111-183,
    the config keys of fairseq's specaugment block)."""
    spec = spec.copy()
    num_frames, num_freqs = spec.shape
    freq_n, freq_f = conf.get("freq_mask_N", 0), conf.get("freq_mask_F", 0)
    time_n, time_t = conf.get("time_mask_N", 0), conf.get("time_mask_T", 0)
    time_p = conf.get("time_mask_p", 0.0)
    mask_value = conf.get("mask_value", None)
    if mask_value is None:
        mask_value = spec.mean()
    if num_frames == 0 or num_freqs < freq_f:
        return spec
    w = conf.get("time_warp_W", 0)
    if w > 0 and 2 * w < num_frames:
        w0 = rng.randint(w, num_frames - w)
        s = rng.randint(-w + 1, w)
        src_pos = np.arange(num_frames, dtype=np.float64)
        left = src_pos[:w0 + s + 1] * (w0 / max(w0 + s, 1))
        right = w0 + (src_pos[w0 + s + 1:] - (w0 + s)) \
            * ((num_frames - 1 - w0) / max(num_frames - 1 - (w0 + s), 1))
        pos = np.concatenate([left, right])
        idx0 = np.clip(pos.astype(np.int64), 0, num_frames - 1)
        idx1 = np.clip(idx0 + 1, 0, num_frames - 1)
        frac = (pos - idx0)[:, None]
        spec = ((1 - frac) * spec[idx0] + frac * spec[idx1]).astype(np.float32)
    for _ in range(freq_n):
        f = rng.randint(0, freq_f + 1)
        f0 = rng.randint(0, max(num_freqs - f, 1))
        if f > 0:
            spec[:, f0:f0 + f] = mask_value
    max_t = min(time_t, int(num_frames * time_p) if time_p > 0 else time_t)
    for _ in range(time_n):
        t = rng.randint(0, max(max_t, 0) + 1)
        t0 = rng.randint(0, max(num_frames - t, 1))
        if t > 0:
            spec[t0:t0 + t, :] = mask_value
    return spec


def utterance_cmvn(x: np.ndarray, norm_means: bool = True,
                   norm_vars: bool = True) -> np.ndarray:
    """Each channel's mean (and std, floored at sqrt(1e-10)) over the
    utterance's frames taken out (feature_transforms.py:91-110)."""
    mean = x.mean(axis=0)
    square_sums = (x ** 2).sum(axis=0)
    if norm_means:
        x = x - mean
    if norm_vars:
        var = square_sums / x.shape[0] - mean ** 2
        x = x / np.sqrt(np.maximum(var, 1e-10))
    return x.astype(np.float32)


class FeatureTransforms:
    """A split's feature transforms by name, as the JAX package registers
    them: global CMVN (``global_cmvn``, ``src_global_cmvn``,
    ``tgt_global_cmvn``), ``utterance_cmvn`` (``norm_means``,
    ``norm_vars``) and ``specaugment`` (the train split's in the recipe's
    config.yaml); any other name raises."""

    def __init__(self, cfg: S2STDataConfig, names: Optional[List[str]]):
        self.steps = []
        for name in names or []:
            conf = cfg.config.get(name) or {}
            if name in _CMVN:
                stats = np.load(cfg.cmvn_stats_path(name))
                mean = stats["mean"].astype(np.float32)
                std = stats["std"].astype(np.float32)
                self.steps.append(
                    lambda x, rng, m=mean, s=std: (x - m) / s)
            elif name == "utterance_cmvn":
                self.steps.append(
                    lambda x, rng, m=conf.get("norm_means", True),
                    v=conf.get("norm_vars", True): utterance_cmvn(x, m, v))
            elif name == "specaugment":
                self.steps.append(
                    lambda x, rng, c=conf: spec_augment(x, c, rng))
            else:
                raise NotImplementedError(
                    f"feature transform {name!r} is not ported")

    def __call__(self, x: np.ndarray,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        """rng: the item's own stream for SpecAugment (np.random's global
        stream without one)."""
        x = np.asarray(x, np.float32)
        for step in self.steps:
            x = step(x, rng if rng is not None else np.random)
        return np.asarray(x, np.float32)


class Manifest:
    """A split's TSV rows with paths taken from ``audio_root``, and the
    split's source and target transforms. A comma-separated split names
    several TSVs (``train_fisher,train_mls``), whose rows are concatenated
    in that order, each keeping its own columns; ``corpora`` holds each
    TSV's rows (``S2STDatasetCreator.from_tsv``, s2st_dataset.py:346-364).
    The transforms are those of the whole name, as JAX looks them up."""

    def __init__(self, root: str, cfg: S2STDataConfig, split: str):
        self.corpora = []
        audio_root = Path(cfg.audio_root)
        for name in split.split(","):
            tsv = Path(root) / f"{name}.tsv"
            if not tsv.is_file():
                raise FileNotFoundError(f"Dataset not found: {tsv}")
            samples = load_tsv(tsv)
            for s in samples:
                for k in ("src_audio", "tgt_audio", "src_orig"):
                    if s.get(k) and not s[k].startswith("/"):
                        s[k] = (audio_root / s[k]).as_posix()
            self.corpora.append(samples)
        self.use_hubert = cfg.use_hubert
        self.set_samples([s for c in self.corpora for s in c])
        is_train = split.startswith("train")
        self.src_transforms = FeatureTransforms(
            cfg, cfg.transforms_for("src_transforms", split, is_train))
        self.tgt_transforms = FeatureTransforms(
            cfg, cfg.transforms_for("tgt_transforms", split, is_train))

    def set_samples(self, samples: List[Dict[str, str]]) -> None:
        self.samples = samples
        self.ids = [s["id"] for s in samples]
        self.src_n_frames = np.array([int(s["src_n_frames"])
                                      for s in samples])

    def source(self, index: int,
               rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        """One utterance's source: the (L,) waveform in [-1, 1) under
        ``use_hubert``, else (T, F) features through the source
        transforms (SpecAugment drawing from ``rng``)."""
        s = self.samples[index]
        if self.use_hubert:
            return np.asarray(get_features_or_waveform(
                s.get("src_orig") or s["src_audio"], need_waveform=True),
                np.float32)
        return self.src_transforms(get_features(s["src_audio"]), rng)


class GenerationSplit(Manifest):
    def __init__(self, root: str, cfg: S2STDataConfig, split: str,
                 n_frames_per_step: int = 1):
        super().__init__(root, cfg, split)
        self.n_frames_per_step = n_frames_per_step

    def batches(self, max_tokens: int, batch_size: Optional[int],
                required_batch_size_multiple: int = 1) -> List[List[int]]:
        """Longest first, in ``max_tokens`` and ``batch_size`` batches,
        unshuffled."""
        lengths = self.src_n_frames
        return [b.tolist() for b in batch_by_size(
            ordered_indices(lengths, False, 0, 0), lengths, max_tokens,
            batch_size, required_batch_size_multiple)]

    def collate(self, indices: List[int], with_target: bool = False,
                src_dict=None) -> Dict[str, object]:
        """Pad a batch; rows longest first. src_speech (B, T, F) fp32, or
        (B, L) waveforms padded to ``snap_len`` of the longest,
        src_speech_lens (B,); with_target adds tgt_speech,
        prev_output_tokens (zero first frame, shifted targets) and
        target_lengths, in packed frames; ``src_dict`` adds src_text, each
        row's source text in that dictionary's ids with EOS, PAD-padded to
        JAX's ``snap_len(longest, 8)`` columns (data/iterators.py:304),
        and src_text_len."""
        src = [self.source(i) for i in indices]
        order = np.argsort([-x.shape[0] for x in src], kind="stable")
        indices = [indices[i] for i in order]
        src = [src[i] for i in order]
        b, t = len(src), max(x.shape[0] for x in src)
        if self.use_hubert:
            t = snap_len(t)
        src_speech = np.zeros((b, t) + src[0].shape[1:], np.float32)
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
            full = np.zeros((b, tt, tgt[0].shape[1]), np.float32)
            prev = np.zeros_like(full)
            for i, x in enumerate(tgt):
                full[i, :x.shape[0]] = x
                prev[i, 1:x.shape[0]] = x[:-1]
            batch["tgt_speech"] = torch.from_numpy(full)
            batch["prev_output_tokens"] = torch.from_numpy(prev)
            batch["target_lengths"] = torch.tensor([x.shape[0] for x in tgt])
        if src_dict is not None:
            ids = [src_dict.encode_line(self.samples[i].get("src_text", ""))
                   for i in indices]
            text = np.full((b, snap_len(max(len(x) for x in ids), 8)),
                           src_dict.pad_index, np.int64)
            for i, x in enumerate(ids):
                text[i, :len(x)] = x
            batch["src_text"] = torch.from_numpy(text)
            batch["src_text_len"] = torch.tensor([len(x) for x in ids])
        return batch
