"""The wav2vec 2.0 pretraining task and its raw-audio dataset.

Counterpart of ``s2st_tpu/tasks/audio_pretraining.py`` (:36-243):
``--task audio_pretraining --arch wav2vec2 --criterion wav2vec``.

Data: the wav2vec manifest, ``<data>/<split>.tsv``, whose first line is
the corpus root and each further line ``rel/path.wav<TAB>num_samples``;
rows shorter than ``--min-sample-size`` are left out. A batch is cropped to
its shortest utterance (at most ``--max-sample-size``), the crop target
snapped DOWN to the geometric grid of ``_snap_down`` so that crops only
shrink; each utterance's offset comes from its own ``crop_seed``, drawn
from the item's ``RandomState`` (``data/iterators.py::item_seed``), so the
batches, their order and their crops are JAX's. ``--normalize``
layer-normalizes each cropped waveform. Pad rows (up to ``snap_len(rows,
8)``) carry length 0.

``wav2vec_v1`` (``--arch wav2vec``) is not ported: its arch raises
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.audio_utils import read_wav
from ..data.iterators import snap_len

logger = logging.getLogger(__name__)


def _snap_down(n: int, lo: int, ratio: float = 1.15) -> int:
    """The largest point <= n of the grid {lo * ratio^k} (n itself when
    n <= lo)."""
    if n <= lo:
        return int(n)
    k = int(math.floor(math.log(n / lo) / math.log(ratio)))
    return min(int(lo * ratio ** k), int(n))


def manifest_rows(manifest_path: str, min_sample_size: int):
    """(root, [(file, samples, original row)]) of a manifest, the rows
    below ``min_sample_size`` left out."""
    rows = []
    with open(manifest_path) as f:
        root = f.readline().strip()
        for i, line in enumerate(f):
            items = line.strip().split("\t")
            assert len(items) == 2, f"bad manifest line {i}: {line}"
            if int(items[1]) >= min_sample_size:
                rows.append((items[0], int(items[1]), i))
    return root, rows


def layer_normalized(wav: np.ndarray) -> np.ndarray:
    """``--normalize``: (wav - mean) / sqrt(var + 1e-5) in float32."""
    m, v = wav.mean(), wav.var()
    return (wav - m) / np.sqrt(v + 1e-5)


class RawAudioDataset:
    """``RawAudioDataset`` (:44-140): ``src_n_frames`` (the crop-capped
    lengths batches are formed from), ``item(index, rng)``,
    ``snap_kwargs`` and ``collate``, as ``data/iterators.py``'s
    ``EpochBatchIterator`` drives them."""

    def __init__(self, manifest_path: str, sample_rate: int = 16000,
                 max_sample_size: int = 250000,
                 min_sample_size: int = 32000, normalize: bool = False):
        self.sample_rate = sample_rate
        self.max_sample_size = max_sample_size
        self.min_sample_size = min_sample_size
        self.normalize = normalize
        self.root_dir, rows = manifest_rows(manifest_path, min_sample_size)
        self.fnames: List[str] = [r[0] for r in rows]
        self.sizes = np.asarray([r[1] for r in rows], np.int64)
        self.kept_rows = [r[2] for r in rows]
        self.src_n_frames = np.minimum(self.sizes, max_sample_size)
        logger.info(f"loaded {len(self.fnames)} samples from {manifest_path}")

    def __len__(self) -> int:
        return len(self.fnames)

    def item(self, index: int, rng: np.random.RandomState) -> Dict[str, Any]:
        path = os.path.join(self.root_dir, self.fnames[index])
        wav, sr = read_wav(path, normalization=True)
        assert sr == self.sample_rate, f"{path}: {sr} != {self.sample_rate}"
        return {"id": index, "wav": wav.astype(np.float32),
                "crop_seed": int(rng.randint(0, 2 ** 31 - 1))}

    def snap_kwargs(self, items: Sequence[Dict]) -> Dict[str, int]:
        target = min(min(len(it["wav"]) for it in items),
                     self.max_sample_size)
        return {"pad_batch": snap_len(len(items), 8),
                "target_size": _snap_down(target, self.min_sample_size)}

    def crop(self, item: Dict[str, Any], target: int,
             max_start: Optional[int] = None):
        """(the item's waveform cropped to ``target`` samples at its seeded
        offset, at most ``max_start``, normalized with ``--normalize``;
        the offset)."""
        wav, start = item["wav"], 0
        if len(wav) > target:
            r = np.random.RandomState(item["crop_seed"])
            start = int(r.randint(0, len(wav) - target + 1))
            if max_start is not None:
                start = min(start, max_start)
            wav = wav[start:start + target]
        if self.normalize:
            wav = layer_normalized(wav)
        return wav, start

    def collate(self, items: Sequence[Dict], pad_batch: Optional[int] = None,
                target_size: Optional[int] = None) -> Dict[str, Any]:
        """Crop-to-shortest (``collate``, :108-140): ``source`` (B, T)
        float32, ``source_lens``, ``id``, ``nsentences`` (the real rows)
        and ``ntokens`` (their samples)."""
        b = pad_batch or len(items)
        target = target_size if target_size is not None else min(
            min(len(it["wav"]) for it in items), self.max_sample_size)
        source = np.zeros((b, target), np.float32)
        lens = np.zeros((b,), np.int64)
        ids = np.zeros((b,), np.int64)
        for i, it in enumerate(items):
            wav, _ = self.crop(it, target)
            source[i, :len(wav)] = wav
            lens[i], ids[i] = len(wav), it["id"]
        return {"source": torch.from_numpy(source),
                "source_lens": torch.from_numpy(lens),
                "id": torch.from_numpy(ids), "nsentences": len(items),
                "ntokens": int(lens.sum())}


class AudioPretrainingTask:
    """``AudioPretrainingTask`` (:143-243): the wav2vec2 model of the
    flags with ``wav2vec_loss``."""

    def __init__(self, args):
        self.args = args

    def load_dataset(self, split: str) -> RawAudioDataset:
        a = self.args
        return RawAudioDataset(os.path.join(a.data, f"{split}.tsv"),
                               sample_rate=a.sample_rate,
                               max_sample_size=a.max_sample_size,
                               min_sample_size=a.min_sample_size,
                               normalize=a.normalize)

    def build_model_config(self):
        from ..models.config_from_args import wav2vec2_config
        return wav2vec2_config(self.args)

    def build_loss_config(self):
        from ..train.losses import Wav2VecLossConfig
        w = [float(x) for x in str(self.args.loss_weights).split(",")]
        if len(w) == 1:
            w = w * 2      # one weight serves both terms (:96-99)
        return Wav2VecLossConfig(prob_ppl_weight=w[0],
                                 features_pen_weight=w[1])

    def build_model_and_loss(self):
        """(config, model with seeded weights, loss function)."""
        from ..models.wav2vec2 import Wav2Vec2Model
        from ..train.losses import wav2vec_loss
        arch = str(self.args.arch)
        if arch == "wav2vec" or arch.startswith("wav2vec_v1"):
            raise NotImplementedError(
                f"arch {arch} (wav2vec 1.0) is not ported")
        cfg = self.build_model_config()
        return cfg, Wav2Vec2Model(cfg).init_weights(self.args.seed), \
            wav2vec_loss


__all__ = ["RawAudioDataset", "AudioPretrainingTask", "manifest_rows",
           "layer_normalized", "_snap_down"]
