"""ConvTransformer: the ESPnet-style speech-to-text model.

Counterpart of ``s2st_tpu/models/convtransformer.py``: two stride-2 3x3
Conv2d + ReLU blocks over the (1, T, F) feature image (``encode``,
:94-132), a linear layer from the flattened (channel, frequency) axis to
the embed dim, ``embed_scale`` sqrt(D), sinusoidal positions from the
subsampled lengths, which follow the reference's arithmetic (:112-115:
factor round(T / T'), ceil(length / factor), at most T'), dropout and the
encoder layers (no final norm, as in JAX); then the S2ST model's aux text
decoder (``AuxTextDecoder``, JAX's ``aux_decode``) over the encoder
output. ``forward`` takes the S2T model's arguments, so ``s2t_loss``
trains it. fairseq names: ``encoder.conv.{0,2}``, ``encoder.out``,
``encoder.transformer_layers.N``, ``decoder.*``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .jax_bridge import load_jax_variables
from .s2st_transformer import (PAD, AuxTextDecoder, S2STConfig, seeded_init)
from ..nn.core import (dropout, lengths_to_padding_mask, linear, scaled)
from ..nn.transformer import (TransformerEncoderLayer, positions_for_lengths,
                              sinusoidal_table)


@dataclass(frozen=True)
class ConvTransformerConfig:
    """``ConvTransformerConfig`` (:31-39) with the decoder's vocabulary:
    the source dictionary's for ``--test-type asr``, the target's for
    ``st``."""
    base: S2STConfig = dataclasses.field(default_factory=S2STConfig)
    conv_out_channels: int = 256
    decoder_layers: int = 6
    decoder_embed_dim: int = 256
    vocab_size: int = 100

    def replace(self, **kw) -> "ConvTransformerConfig":
        return dataclasses.replace(self, **kw)


def conv_out_len(t: int) -> int:
    """One 3x3, stride-2, padding-1 conv's output length (``_conv_out_len``,
    :48-50)."""
    return (t - 1) // 2 + 1


def subsampled_lengths(src_lens: torch.Tensor, t: int, t_out: int
                       ) -> torch.Tensor:
    """The encoder's lengths for a batch padded to ``t`` frames and
    subsampled to ``t_out``: ceil(length / round(t / t_out)), at most
    ``t_out`` (:112-115; the division in fp32, as JAX's)."""
    factor = int(t / t_out + 0.5)
    return torch.clamp(torch.ceil(src_lens.float() / factor).long(),
                       max=t_out)


@functools.lru_cache(maxsize=16)
def _table(n: int, dim: int) -> torch.Tensor:
    return sinusoidal_table(n, dim, PAD)


class ConvTransformerEncoder(nn.Module):
    def __init__(self, cfg: ConvTransformerConfig):
        super().__init__()
        self.cfg = cfg
        base = cfg.base
        c = cfg.conv_out_channels
        self.conv = nn.Sequential(
            nn.Conv2d(1, c, 3, stride=2, padding=1), nn.ReLU(),
            nn.Conv2d(c, c, 3, stride=2, padding=1), nn.ReLU())
        f_out = conv_out_len(conv_out_len(base.input_feat_per_channel))
        self.out = nn.Linear(c * f_out, base.encoder_embed_dim)
        self.transformer_layers = nn.ModuleList(
            TransformerEncoderLayer(base.encoder_embed_dim,
                                    base.encoder_ffn_embed_dim,
                                    base.encoder_attention_heads,
                                    base.encoder_normalize_before,
                                    base.activation_fn,
                                    **base.dropout_rates())
            for _ in range(base.encoder_layers))

    def forward(self, src_speech: torch.Tensor, src_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """src_speech (B, T, F) -> ``encoder_out`` (B, T', D), its padding
        mask and ``out_lengths``; dropout only with a generator."""
        base = self.cfg.base
        b, t, _ = src_speech.shape
        x = src_speech.to(base.dtype)[:, None]                # (B, 1, T, F)
        for conv in (self.conv[0], self.conv[2]):
            # the bias after the product, in the compute dtype, as JAX's
            x = F.relu(F.conv2d(x, conv.weight.to(x.dtype), None, stride=2,
                                padding=1)
                       + conv.bias.to(x.dtype)[None, :, None, None])
        t_out = x.shape[2]
        x = x.permute(0, 2, 1, 3).reshape(b, t_out, -1)      # (B, T', C*F')
        x = linear(x, self.out.weight, self.out.bias)
        x = scaled(x, math.sqrt(base.encoder_embed_dim))
        out_lens = subsampled_lengths(src_lens, t, t_out)
        table = _table(t_out + PAD + 1, base.encoder_embed_dim).to(x.device)
        x = x + positions_for_lengths(table, out_lens, t_out, PAD, x.dtype)
        x = dropout(x, base.dropout, generator)
        pad_mask = lengths_to_padding_mask(out_lens, t_out)
        for layer in self.transformer_layers:
            x = layer(x, pad_mask, generator)
        return {"encoder_out": x, "encoder_padding_mask": pad_mask,
                "out_lengths": out_lens}


class ConvTransformer(nn.Module):
    def __init__(self, cfg: ConvTransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConvTransformerEncoder(cfg)
        self.decoder = AuxTextDecoder(cfg.base, cfg.vocab_size,
                                      cfg.decoder_embed_dim,
                                      cfg.decoder_layers)

    def forward(self, batch: Dict[str, Any], prev_tokens: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None
                ) -> Dict[str, Any]:
        """Teacher-forced forward (``forward``, :135-159); dropout at every
        site with ``train`` and a generator; ``layer_keep`` is ignored (no
        LayerDrop in JAX's model)."""
        drop = generator if train else None
        enc = self.encoder(batch["src_speech"], batch["src_speech_lens"],
                           drop)
        logits = self.decoder(prev_tokens, enc["encoder_out"],
                              enc["encoder_padding_mask"], drop)
        return {"logits": logits, "encoder_out": enc["encoder_out"],
                "encoder_padding_mask": enc["encoder_padding_mask"],
                "encoder_out_lengths": enc["out_lengths"], "new_stats": {}}

    @torch.no_grad()
    def init_weights(self, seed: int) -> "ConvTransformer":
        """Seeded random init with ``init_convtransformer``'s distributions
        (:53-79): torch's default uniform over the fan-in for the convs,
        the S2ST model's for the rest."""
        g = torch.Generator().manual_seed(seed)
        seeded_init(self, g)
        for conv in (self.encoder.conv[0], self.encoder.conv[2]):
            bound = 1.0 / math.sqrt(conv.in_channels * 9)
            for t in (conv.weight, conv.bias):
                t.copy_(torch.rand(t.shape, generator=g) * (2 * bound)
                        - bound)
        return self


def from_jax_variables(cfg: ConvTransformerConfig, variables: Dict[str, Any]
                       ) -> ConvTransformer:
    """A model of ``cfg`` holding a JAX ConvTransformer ``{"params",
    "stats"}`` tree of numpy arrays (strict both ways)."""
    return load_jax_variables(ConvTransformer(cfg), variables)
