"""The text transformer's config: the part of
``s2st_tpu/models/transformer_text.py`` (:42-172) that the LightConv family
takes from it.

LightConv nests this config as its ``base`` and takes from the text
transformer's parameter tree only the token embeddings and the output
projection: ``encoder.embed`` (src_vocab, D); ``decoder.embed`` (tgt_vocab,
D), absent under ``share_all_embeddings`` (the decoder then reads the
encoder's table); and ``decoder.out_proj`` (D, tgt_vocab), absent when the
projection is tied to the decoder's embedding
(``share_decoder_input_output_embed`` or ``share_all_embeddings``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class TransformerTextConfig:
    src_vocab_size: int = 1000
    tgt_vocab_size: int = 1000
    encoder_layers: int = 6
    encoder_embed_dim: int = 512
    encoder_ffn_embed_dim: int = 2048
    encoder_attention_heads: int = 8
    encoder_normalize_before: bool = False
    decoder_layers: int = 6
    decoder_embed_dim: int = 512
    decoder_ffn_embed_dim: int = 2048
    decoder_attention_heads: int = 8
    decoder_normalize_before: bool = False
    dropout: float = 0.1
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    activation_fn: str = "relu"
    share_decoder_input_output_embed: bool = False
    share_all_embeddings: bool = False
    max_source_positions: int = 1024
    max_target_positions: int = 1024
    dtype: Any = torch.float32

    def replace(self, **kw) -> "TransformerTextConfig":
        return dataclasses.replace(self, **kw)

    @property
    def tied_output(self) -> bool:
        """The output projection is the decoder embedding's transpose."""
        return self.share_decoder_input_output_embed or \
            self.share_all_embeddings
