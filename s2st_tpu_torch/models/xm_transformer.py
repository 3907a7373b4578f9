"""xm_transformer: a HuBERT trunk, a Conv1d adaptor and an mBART decoder.

Counterpart of ``s2st_tpu/models/xm_transformer.py``: the trunk is the
port's HuBERT frontend (``models/hubert.py``, ``extract_features``; JAX's
``params::w2v``), run without a gradient under ``freeze_w2v`` (:153-154);
the ``Conv1dAdaptor`` (:117-136) takes its features to the decoder's width
through ``adaptor_n_layers`` stride-s GLU convs with padding k // 2
(lengths floor((l - 1) / s) + 1 a layer, no masking between layers) and an
optional LayerNorm after each; the decoder is the text transformer's
learned-position decoder (``transformer_text.LearnedPositionDecoder``, JAX's
``_decode_learned_pos``) over the adaptor's output. ``forward`` takes the
S2T model's arguments, so ``s2t_loss`` trains it. fairseq names (fairseq's
``XMTransformerModel``): ``encoder.w2v_model``,
``encoder.adaptor.layers.N``, ``encoder.adaptor.layernorms.N``,
``decoder.*``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from . import hubert as hub
from .jax_bridge import load_jax_variables
from .s2st_transformer import seeded_init
from .transformer_text import LearnedPositionDecoder, TransformerTextConfig
from ..nn.core import conv1d, glu, layer_norm, lengths_to_padding_mask


@dataclass(frozen=True)
class XMConfig:
    """``XMConfig`` (:30-50)."""
    trunk: hub.HubertConfig = dataclasses.field(
        default_factory=hub.HubertConfig)
    vocab_size: int = 1000
    decoder_layers: int = 12
    decoder_embed_dim: int = 1024
    decoder_ffn_embed_dim: int = 4096
    decoder_attention_heads: int = 16
    decoder_normalize_before: bool = True
    layernorm_embedding: bool = True
    adaptor_n_layers: int = 3
    adaptor_kernel_size: int = 3
    adaptor_stride: int = 2
    adaptor_layernorm: bool = False
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    activation_fn: str = "gelu"
    freeze_w2v: bool = True
    max_target_positions: int = 1024
    dtype: Any = torch.float32

    def replace(self, **kw) -> "XMConfig":
        return dataclasses.replace(self, **kw)

    def decoder_config(self) -> TransformerTextConfig:
        """The decoder's config (``_decoder_shim``, :52-69)."""
        return TransformerTextConfig(
            tgt_vocab_size=self.vocab_size,
            decoder_layers=self.decoder_layers,
            decoder_embed_dim=self.decoder_embed_dim,
            decoder_ffn_embed_dim=self.decoder_ffn_embed_dim,
            decoder_attention_heads=self.decoder_attention_heads,
            decoder_normalize_before=self.decoder_normalize_before,
            layernorm_embedding=self.layernorm_embedding,
            encoder_embed_dim=self.decoder_embed_dim,
            dropout=self.dropout, attention_dropout=self.attention_dropout,
            activation_dropout=self.activation_dropout,
            activation_fn=self.activation_fn,
            max_target_positions=self.max_target_positions, dtype=self.dtype)


class Conv1dAdaptor(nn.Module):
    def __init__(self, cfg: XMConfig):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.trunk.encoder_embed_dim] + \
            [cfg.decoder_embed_dim] * (cfg.adaptor_n_layers - 1)
        self.layers = nn.ModuleList(
            nn.Conv1d(d, 2 * cfg.decoder_embed_dim, cfg.adaptor_kernel_size,
                      stride=cfg.adaptor_stride,
                      padding=cfg.adaptor_kernel_size // 2)
            for d in dims)
        self.layernorms = nn.ModuleList(
            nn.LayerNorm(cfg.decoder_embed_dim) for _ in dims) \
            if cfg.adaptor_layernorm else None

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, C) -> (B, T', decoder_embed_dim) and the lengths
        (``adaptor_forward``, :117-136)."""
        cfg = self.cfg
        s, k = cfg.adaptor_stride, cfg.adaptor_kernel_size
        for i, conv in enumerate(self.layers):
            x = glu(conv1d(x, conv.weight, conv.bias, stride=s,
                           padding=k // 2))
            if self.layernorms is not None:
                ln = self.layernorms[i]
                x = layer_norm(x, ln.weight, ln.bias)
            lengths = torch.div(lengths - 1, s, rounding_mode="floor") + 1
        return x, lengths


class XMEncoder(nn.Module):
    def __init__(self, cfg: XMConfig):
        super().__init__()
        self.cfg = cfg
        self.w2v_model = hub.HubertModel(cfg.trunk)
        self.adaptor = Conv1dAdaptor(cfg)

    def forward(self, src_wave: torch.Tensor, src_lens: torch.Tensor
                ) -> Dict[str, Any]:
        """(B, L) waveform -> ``encoder_out`` (B, T', D) in the compute
        dtype, its padding mask and ``out_lengths`` (``encode``,
        :147-160)."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.cfg.freeze_w2v):
            feats, lens = self.w2v_model.extract_features(src_wave, src_lens)
        x, lens = self.adaptor(feats.to(self.cfg.dtype), lens)
        return {"encoder_out": x,
                "encoder_padding_mask": lengths_to_padding_mask(lens,
                                                                x.shape[1]),
                "out_lengths": lens}


class XMTransformer(nn.Module):
    def __init__(self, cfg: XMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = XMEncoder(cfg)
        self.decoder = LearnedPositionDecoder(cfg.decoder_config())

    def forward(self, batch: Dict[str, Any], prev_tokens: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None
                ) -> Dict[str, Any]:
        """Teacher-forced forward (``forward``, :163-172): the trunk and
        adaptor over ``src_speech`` (B, L), then the decoder over
        ``prev_tokens``. Dropout at every decoder site with ``train`` and a
        generator; ``layer_keep`` is ignored (no LayerDrop in JAX's
        model)."""
        enc = self.encoder(batch["src_speech"], batch["src_speech_lens"])
        logits = self.decoder(prev_tokens, enc["encoder_out"],
                              enc["encoder_padding_mask"],
                              generator if train else None)
        return {"logits": logits, "encoder_out": enc["encoder_out"],
                "encoder_padding_mask": enc["encoder_padding_mask"],
                "encoder_out_lengths": enc["out_lengths"], "new_stats": {}}

    @torch.no_grad()
    def init_weights(self, seed: int) -> "XMTransformer":
        """Seeded random init with ``init_xm``'s distributions (:84-114):
        the trunk's, torch's default uniform over the fan-in for the
        adaptor's convs, and the S2ST model's for the decoder."""
        g = torch.Generator().manual_seed(seed)
        seeded_init(self.decoder, g)
        w = self.decoder.output_projection.weight
        w.copy_(torch.randn(w.shape, generator=g) * w.shape[1] ** -0.5)
        for conv in self.encoder.adaptor.layers:
            bound = 1.0 / math.sqrt(conv.in_channels * conv.kernel_size[0])
            for t in (conv.weight, conv.bias):
                t.copy_(torch.rand(t.shape, generator=g) * (2 * bound)
                        - bound)
        if self.encoder.adaptor.layernorms is not None:
            for ln in self.encoder.adaptor.layernorms:
                ln.reset_parameters()
        self.encoder.w2v_model.init_weights(g)
        return self


def from_jax_variables(cfg: XMConfig, variables: Dict[str, Any]
                       ) -> XMTransformer:
    """A model of ``cfg`` holding a JAX xm_transformer ``{"params",
    "stats"}`` tree of numpy arrays (``params/{w2v,adaptor,decoder}``;
    strict both ways); the trunk first takes the pretraining leaves the
    tree carries."""
    model = XMTransformer(cfg)
    model.encoder.w2v_model.carry_pretraining(hub.pretraining_shapes(
        variables["params"].get("w2v", {})))
    return load_jax_variables(model, variables)
