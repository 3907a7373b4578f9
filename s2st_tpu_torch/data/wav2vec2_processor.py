"""What ``Wav2Vec2Processor`` does for stage 8's transcriber, without HF.

The port's copy of the two halves of ``transformers``' processor that
``s2st_tpu/cli/evaluate_s2s_bleu.py::build_hf_transcriber`` (:36-52) calls,
read from an HF model directory's ``preprocessor_config.json``,
``tokenizer_config.json``, ``special_tokens_map.json`` and ``vocab.json``:

- ``features``: ``Wav2Vec2FeatureExtractor.__call__`` on one utterance. A
  sampling rate other than the config's raises, as HF's does. With
  ``do_normalize`` the utterance becomes ``(x - mean) / sqrt(var + 1e-7)``
  in float32 numpy (``zero_mean_unit_var_norm``); one utterance pads to
  itself, so its attention mask, when the config asks for one, covers it
  whole and changes nothing.
- ``decode``: ``Wav2Vec2CTCTokenizer.batch_decode`` of one row of argmax
  ids with its defaults (``skip_special_tokens`` False): ids to tokens
  (added tokens first, an unknown id to the unk token), repeats grouped,
  the pad token (CTC blank) dropped, the word delimiter replaced, the
  tokens joined and stripped, then ``do_lower_case`` and
  ``clean_up_tokenization_spaces``. ``<s>``, ``</s>`` and ``<unk>`` stay as
  literal text.

Defaults where a file leaves a field out are those of ``transformers``
4.57: ``clean_up_tokenization_spaces`` False, ``do_lower_case`` False,
``|`` the word delimiter, replaced by a space.
"""

from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

# PreTrainedTokenizerBase.clean_up_tokenization
_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
             (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
             (" 've", "'ve"), (" 're", "'re"))


def _token(value) -> str:
    """A special token as a config spells it: a string or an AddedToken
    record."""
    return value["content"] if isinstance(value, dict) else value


def _read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Wav2Vec2Processor:
    """Feature extraction and greedy CTC decoding of one utterance."""

    def __init__(self, model_dir: str):
        root = Path(model_dir)
        fe = _read_json(root / "preprocessor_config.json")
        self.sampling_rate = int(fe.get("sampling_rate", 16000))
        self.do_normalize = bool(fe.get("do_normalize", True))
        if int(fe.get("feature_size", 1)) != 1:
            raise ValueError("only mono waveforms (feature_size 1)")

        cfg = _read_json(root / "tokenizer_config.json")
        special = root / "special_tokens_map.json"
        if special.is_file():
            # from_pretrained lets the map override the config's tokens
            cfg.update(_read_json(special))
        vocab = _read_json(root / "vocab.json")
        if any(not isinstance(v, int) for v in vocab.values()):
            raise NotImplementedError("a multi-lingual vocab.json "
                                      "(target_lang) is not ported")
        self.decoder: Dict[int, str] = {i: t for t, i in vocab.items()}
        for i, rec in cfg.get("added_tokens_decoder", {}).items():
            self.decoder[int(i)] = _token(rec)
        self.pad_token = _token(cfg.get("pad_token", "<pad>"))
        self.unk_token = _token(cfg.get("unk_token", "<unk>"))
        self.word_delimiter_token = _token(cfg.get("word_delimiter_token",
                                                   "|"))
        self.replace_word_delimiter_char = cfg.get(
            "replace_word_delimiter_char", " ")
        self.do_lower_case = bool(cfg.get("do_lower_case", False))
        self.clean_up_tokenization_spaces = bool(
            cfg.get("clean_up_tokenization_spaces", False))

    def features(self, wave: np.ndarray, sampling_rate: int) -> np.ndarray:
        """(T,) float32 input values of one utterance."""
        if sampling_rate != self.sampling_rate:
            raise ValueError(
                f"The model corresponding to this feature extractor was "
                f"trained using a sampling rate of {self.sampling_rate}. "
                f"Please make sure that the provided `raw_speech` input was "
                f"sampled with {self.sampling_rate} and not "
                f"{sampling_rate}.")
        x = np.asarray(wave)
        if x.ndim != 1:
            raise ValueError(f"one mono waveform (T,), got {x.shape}")
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        if self.do_normalize:
            x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
        return np.asarray(x, dtype=np.float32)

    def decode(self, ids: Sequence[int]) -> str:
        """One row of argmax ids to text."""
        tokens: List[str] = [self.decoder.get(int(i), self.unk_token)
                             for i in ids]
        chars = [t for t, _ in itertools.groupby(tokens)]
        chars = [self.replace_word_delimiter_char
                 if c == self.word_delimiter_token else c
                 for c in chars if c != self.pad_token]
        text = "".join(chars).strip()
        if self.do_lower_case:
            text = text.lower()
        if self.clean_up_tokenization_spaces:
            for old, new in _CLEAN_UP:
                text = text.replace(old, new)
        return text


__all__ = ["Wav2Vec2Processor"]
