"""Text-to-speech transformer: the paper's pseudo-label TTS.

Counterpart of ``s2st_tpu/models/t2s_transformer.py``: a text encoder
(``encode``, :84-142) of the token embedding (PAD row zero, no scaling), N
conv-BatchNorm-ReLU-dropout blocks at ``encoder_dropout``, ``prenet_proj``,
pad-aware sinusoidal positions scaled by the learned ``pos_emb_alpha``,
dropout, the transformer layers, the final norm and the optional speaker
concatenation through ``spk_emb_proj``; then the S2ST model's spectrogram
decoder, unchanged (``decode``). The decoder's and postnet's widths live
in the embedded S2ST config (``base``); this config adds the text
encoder's knobs.

In training (``train``) each BatchNorm normalises with the batch's
statistics over every (B, T) position, padded ones included, as JAX's
``nn/core.py::batch_norm`` (:203), and ``forward`` returns the running
statistics it would keep (``new_stats["encoder"]``, beside the postnet's)
without touching the buffers; ``load_stats`` writes them. fairseq names
(the fork's ``T2STransformerEncoder``): ``encoder.embed_tokens``,
``encoder.prenet.N.{0,1}`` (conv, BatchNorm), ``encoder.prenet_proj``,
``encoder.pos_emb_alpha``, ``encoder.transformer_layers.N``,
``encoder.layer_norm``, ``encoder.embed_speaker``,
``encoder.spk_emb_proj``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .jax_bridge import load_jax_variables
from .s2st_transformer import (PAD, S2STConfig, SpectrogramDecoder,
                               seeded_init)
from ..nn.core import (batch_norm_eval, batch_norm_train, conv1d, dropout,
                       layer_norm, linear)
from ..nn.transformer import TransformerEncoderLayer, sinusoidal_table


@dataclass(frozen=True)
class T2SConfig:
    """``T2SConfig`` (:36-46)."""
    base: S2STConfig = dataclasses.field(default_factory=S2STConfig)
    encoder_conv_layers: int = 3
    encoder_conv_kernel_size: int = 5
    encoder_dropout: float = 0.5
    encoder_transformer_layers: int = 6

    def replace(self, **kw) -> "T2SConfig":
        return dataclasses.replace(self, **kw)


class T2SEncoder(nn.Module):
    def __init__(self, cfg: T2SConfig):
        super().__init__()
        self.cfg = cfg
        base = cfg.base
        dim = base.encoder_embed_dim
        k = cfg.encoder_conv_kernel_size
        self.embed_tokens = nn.Embedding(base.src_vocab_size, dim,
                                         padding_idx=PAD)
        self.prenet = nn.ModuleList(
            nn.Sequential(nn.Conv1d(dim, dim, k, padding=(k - 1) // 2),
                          nn.BatchNorm1d(dim))
            for _ in range(cfg.encoder_conv_layers))
        self.prenet_proj = nn.Linear(dim, dim)
        self.pos_emb_alpha = nn.Parameter(torch.ones(1))
        self.transformer_layers = nn.ModuleList(
            TransformerEncoderLayer(dim, base.encoder_ffn_embed_dim,
                                    base.encoder_attention_heads,
                                    base.encoder_normalize_before,
                                    base.activation_fn,
                                    **base.dropout_rates())
            for _ in range(cfg.encoder_transformer_layers))
        self.layer_norm = nn.LayerNorm(dim) \
            if base.encoder_normalize_before else None
        self.embed_speaker = self.spk_emb_proj = None
        if base.num_speakers > 0:
            self.embed_speaker = nn.Embedding(base.num_speakers,
                                              base.speaker_embed_dim)
            self.spk_emb_proj = nn.Linear(dim + base.speaker_embed_dim, dim)
        self.register_buffer(
            "pos_table", sinusoidal_table(base.max_source_positions + PAD + 1,
                                          dim, PAD), persistent=False)

    def forward(self, src_tokens: torch.Tensor,
                speaker: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> Dict[str, Any]:
        """src_tokens (B, T) PAD-padded -> the encoder dict of the S2ST
        model (``encoder_out``, ``encoder_padding_mask``, no taps,
        ``out_lengths``) and ``new_stats`` (the BatchNorms' running
        statistics: updated with ``train``, the buffers' own otherwise).
        Dropout only with a generator."""
        cfg, base = self.cfg, self.cfg.base
        x = self.embed_tokens.weight.to(base.dtype)[src_tokens]
        new_stats = {}
        pad = (cfg.encoder_conv_kernel_size - 1) // 2
        for i, (conv, bn) in enumerate(self.prenet):
            x = conv1d(x, conv.weight, conv.bias, padding=pad)
            if train:
                x, mean, var = batch_norm_train(
                    x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                    bn.momentum, bn.eps)
                count = bn.num_batches_tracked + 1
            else:
                x = batch_norm_eval(x, bn.running_mean, bn.running_var,
                                    bn.weight, bn.bias, bn.eps)
                mean, var, count = (bn.running_mean, bn.running_var,
                                    bn.num_batches_tracked)
            new_stats[f"bn{i}"] = {"mean": mean, "var": var, "count": count}
            x = dropout(F.relu(x), cfg.encoder_dropout, generator)
        x = linear(x, self.prenet_proj.weight, self.prenet_proj.bias)
        padding_mask = src_tokens == PAD
        pos_idx = torch.where(padding_mask, PAD,
                              torch.cumsum((~padding_mask).long(), dim=1)
                              + PAD)
        x = x + self.pos_emb_alpha.to(x.dtype) * self.pos_table[pos_idx].to(
            x.dtype)
        x = dropout(x, base.dropout, generator)
        for layer in self.transformer_layers:
            x = layer(x, padding_mask, generator)
        if self.layer_norm is not None:
            x = layer_norm(x, self.layer_norm.weight, self.layer_norm.bias)
        if speaker is not None and self.embed_speaker is not None:
            b, t, _ = x.shape
            emb = self.embed_speaker.weight.to(x.dtype)[speaker.reshape(-1)]
            x = linear(torch.cat([x, emb[:, None, :].expand(b, t, -1)],
                                 dim=-1),
                       self.spk_emb_proj.weight, self.spk_emb_proj.bias)
        return {"encoder_out": x, "encoder_padding_mask": padding_mask,
                "out_middle_layers": [],
                "out_lengths": (~padding_mask).sum(dim=1),
                "new_stats": new_stats}


class T2STransformer(nn.Module):
    # JAX's T2S tree names the token table ``embed_tokens``, where the
    # other models' text embeddings are ``embed``
    jax_rules = ((r"^encoder\.embed_tokens$", "encoder::embed_tokens"),)

    def __init__(self, cfg: T2SConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = T2SEncoder(cfg)
        self.decoder = SpectrogramDecoder(cfg.base)

    def encode(self, src_tokens: torch.Tensor,
               speaker: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The inference encoder (``encode`` with ``deterministic``)."""
        return self.encoder(src_tokens, speaker)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None
                ) -> Dict[str, Any]:
        """Teacher-forced forward over ``src_text`` (``forward``,
        :145-168): the decoder's outputs, the encoder's padding mask and
        lengths, and ``new_stats`` {"encoder", "postnet"}. A generator
        turns on the prenet's dropout, and with ``train`` every other
        dropout site; ``train`` puts the BatchNorms on batch statistics.
        ``layer_keep`` is ignored: JAX's text encoder has no LayerDrop."""
        speaker = batch.get("speaker")
        drop = generator if train else None
        enc = self.encoder(batch["src_text"], speaker, drop, train)
        dec = self.decoder(batch["prev_output_tokens"],
                           batch["target_lengths"], enc, speaker, generator,
                           train)
        out = {k: dec[k] for k in ("feat_out", "post_feat_out", "eos_out",
                                   "attn")}
        out["encoder_padding_mask"] = enc["encoder_padding_mask"]
        out["encoder_out_lengths"] = enc["out_lengths"]
        if train:
            out["new_stats"] = {"encoder": enc["new_stats"],
                                "postnet": dec["new_stats"]["postnet"]}
        return out

    @torch.no_grad()
    def load_stats(self, new_stats: Dict[str, Any]) -> None:
        """Write a training forward's running statistics into the
        buffers: the text encoder's BatchNorms and the postnet's."""
        for i, (_, bn) in enumerate(self.encoder.prenet):
            st = new_stats["encoder"][f"bn{i}"]
            bn.running_mean.copy_(st["mean"])
            bn.running_var.copy_(st["var"])
            bn.num_batches_tracked.copy_(st["count"])
        self.decoder.postnet.load_stats(new_stats["postnet"])

    @torch.no_grad()
    def init_weights(self, seed: int) -> "T2STransformer":
        """Seeded random init with ``init_t2s``'s distributions (:49-81):
        the S2ST model's for the decoder and the shared kinds of module,
        and torch's default uniform over the fan-in for the prenet
        convs."""
        g = torch.Generator().manual_seed(seed)
        seeded_init(self, g, postnet=self.decoder.postnet)
        for conv, _ in self.encoder.prenet:
            bound = 1.0 / math.sqrt(conv.in_channels * conv.kernel_size[0])
            for t in (conv.weight, conv.bias):
                t.copy_(torch.rand(t.shape, generator=g) * (2 * bound)
                        - bound)
        self.encoder.pos_emb_alpha.fill_(1.0)
        self.decoder.pos_emb_alpha.fill_(1.0)
        return self


def from_jax_variables(cfg: T2SConfig, variables: Dict[str, Any]
                       ) -> T2STransformer:
    """A model of ``cfg`` holding a JAX T2S ``{"params", "stats"}`` tree of
    numpy arrays (``stats/{encoder,postnet}``; strict both ways)."""
    return load_jax_variables(T2STransformer(cfg), variables)

