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
collate to a (B, L) source, :260-275). Batches and their order come from
``data/iterators.py``, whose pads then count samples.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .audio_utils import get_features
from .data_cfg import S2STDataConfig
from .dictionary import Dictionary
from .manifest import Manifest, pack_frames

PAD = 1


class TrainSplit(Manifest):
    def __init__(self, root: str, cfg: S2STDataConfig, split: str,
                 src_dict: Dictionary, tgt_dict: Dictionary,
                 n_frames_per_step: int = 1):
        super().__init__(root, cfg, split)
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict
        self.n_frames_per_step = n_frames_per_step

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
        return {"index": index, "src_speech": src, "tgt_speech": tgt,
                "src_text": self.src_dict.encode_line(s.get("src_text", "")),
                "tgt_text": self.tgt_dict.encode_line(s.get("tgt_text", ""))}

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
    return batch


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The batch with its tensors on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}
