"""The text transformer's config and its learned-position decoder: the
parts of ``s2st_tpu/models/transformer_text.py`` (:42-172, :283-314) that
the LightConv family and the xm_transformer take from it.

``LearnedPositionDecoder`` is ``_decode_learned_pos`` (:283), the
BART/mBART decoder setting: token embeddings scaled by sqrt(dim) (unless
``no_scale_embedding``), learned pad-aware positions (the rows of
``embed_positions`` at cumsum(non-pad) + PAD, PAD's own row at pads),
``layernorm_embedding``, dropout, the decoder layers (pre- or post-norm,
causal self-attention, cross-attention over the encoder), the final norm
under ``decoder_normalize_before`` and a bias-free output projection.
fairseq names: ``embed_tokens``, ``embed_positions``,
``layernorm_embedding``, ``layers.N``, ``layer_norm``,
``output_projection``.

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
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import nn

from ..nn.core import dropout, layer_norm, linear, scaled
from ..nn.transformer import TransformerDecoderLayer

PAD = 1


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
    no_scale_embedding: bool = False
    layernorm_embedding: bool = False
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


class LearnedPositionDecoder(nn.Module):
    """``_decode_learned_pos`` of a ``TransformerTextConfig``: the target
    vocabulary, the decoder's depth, widths and norms, cross-attention
    over an encoder of ``encoder_embed_dim``, ``max_target_positions``
    learned positions."""

    def __init__(self, cfg: TransformerTextConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.decoder_embed_dim
        self.embed_tokens = nn.Embedding(cfg.tgt_vocab_size, dim,
                                         padding_idx=PAD)
        self.embed_positions = nn.Embedding(
            cfg.max_target_positions + PAD + 1, dim, padding_idx=PAD)
        self.layernorm_embedding = nn.LayerNorm(dim) \
            if cfg.layernorm_embedding else None
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(dim, cfg.decoder_ffn_embed_dim,
                                    cfg.decoder_attention_heads,
                                    kv_dim=cfg.encoder_embed_dim,
                                    normalize_before=cfg.decoder_normalize_before,
                                    activation=cfg.activation_fn,
                                    dropout_rate=cfg.dropout,
                                    attention_dropout=cfg.attention_dropout,
                                    activation_dropout=cfg.activation_dropout)
            for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(dim) \
            if cfg.decoder_normalize_before else None
        self.output_projection = nn.Linear(dim, cfg.tgt_vocab_size,
                                           bias=False)

    def forward(self, prev_tokens: torch.Tensor, enc_out: torch.Tensor,
                enc_padding_mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """prev_tokens (B, Tt) -> logits (B, Tt, V) in the compute dtype;
        dropout only with a generator."""
        cfg = self.cfg
        x = self.embed_tokens.weight.to(cfg.dtype)[prev_tokens]
        if not cfg.no_scale_embedding:
            x = scaled(x, math.sqrt(cfg.decoder_embed_dim))
        is_pad = prev_tokens == PAD
        pos_idx = torch.where(is_pad, PAD,
                              torch.cumsum((~is_pad).long(), dim=1) + PAD)
        x = x + self.embed_positions.weight.to(cfg.dtype)[pos_idx]
        if self.layernorm_embedding is not None:
            ln = self.layernorm_embedding
            x = layer_norm(x, ln.weight, ln.bias)
        x = dropout(x, cfg.dropout, generator)
        for layer in self.layers:
            x, _ = layer(x, enc_out, enc_padding_mask, is_pad,
                         generator=generator)
        if self.layer_norm is not None:
            x = layer_norm(x, self.layer_norm.weight, self.layer_norm.bias)
        return linear(x, self.output_projection.weight)
