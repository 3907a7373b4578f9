"""Berard's speech-to-text model (``--arch s2t_berard*``).

Counterpart of ``s2st_tpu/models/berard.py``: the encoder (``encode``,
:101-138) of a tanh input MLP over each frame's features, a stride-s
Conv2d pyramid (padding k // 2, no activation) over the (T, F) image,
whose lengths follow JAX's fp32 floor((L + 2 (k // 2) - k) / s + 1)
(:118-124), the (C, F) flatten C-major (:126-127), the biLSTM stack with
dropout between layers only, a final dropout and zeros at padded
positions; the MLP attention (``_mlp_attention``, :140-149: -inf at pads,
softmax in fp32); the LSTM decoder step (``decoder_step``, :152-175),
whose layer i reads the state of layer (i - 1) % L and whose attention
fires after layer 0, its context the input of the upper layers (the
reference's threading, kept); and the teacher-forced ``forward``
(:177-221: every layer's hidden state starts at the mean of the encoder
output over the padded time axis, the cells at 0; the deep output tanh(W
[h; ctx; emb]) then the vocabulary projection). ``forward`` takes the S2T
model's arguments, so ``s2t_loss`` trains it.

A pad row (length 0) has no key to attend to: its softmax over -inf is
NaN, as in JAX (ROADMAP §3).

Names (fairseq's ``BerardEncoder`` / ``LSTMDecoder`` where they exist):
``encoder.input_layers.N.0``, ``encoder.conv_layers.N``, ``encoder.blstm``
(one bidirectional ``nn.LSTM``), ``decoder.embed_tokens``,
``decoder.layers.N`` (``nn.LSTMCell``), ``decoder.attention.
{encoder,decoder}_proj``, ``decoder.attention.to_scores``,
``decoder.deep_output_layer``, ``decoder.output_projection``; the JAX
leaves ``encoder::input<i>``, ``conv<i>``, ``l<i>[_rev]`` and
``decoder::embed``, ``cell<i>``, ``attn_*``, ``deep_output``,
``out_proj`` (``jax_rules``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .jax_bridge import load_jax_variables
from .lstm import (bilstm_stack, cell_jax_names, cell_weights,
                   lstm_jax_names)
from ..nn.core import dropout, linear

PAD = 1


@dataclass(frozen=True)
class BerardConfig:
    """``BerardConfig`` (:28-45)."""
    vocab_size: int = 1000
    input_feat_per_channel: int = 80
    input_layers: Tuple[int, ...] = (256, 128)
    conv_layers: Tuple[Tuple[int, int, int], ...] = ((16, 3, 2), (16, 3, 2))
    num_blstm_layers: int = 3
    lstm_size: int = 256
    decoder_embed_dim: int = 128
    decoder_num_layers: int = 2
    decoder_hidden_dim: int = 512
    attention_dim: int = 512
    output_layer_dim: int = 128
    dropout: float = 0.2
    dtype: Any = torch.float32

    def replace(self, **kw) -> "BerardConfig":
        return dataclasses.replace(self, **kw)

    @property
    def context_dim(self) -> int:
        return 2 * self.lstm_size


def conv_lengths(cfg: BerardConfig, lens: torch.Tensor) -> torch.Tensor:
    """Each conv's output lengths in turn, in fp32 as JAX computes them."""
    for _, k, s in cfg.conv_layers:
        lens = torch.floor((lens.float() + 2 * (k // 2) - k) / s + 1).long()
    return lens


class BerardEncoder(nn.Module):
    def __init__(self, cfg: BerardConfig):
        super().__init__()
        self.cfg = cfg
        self.input_layers = nn.ModuleList()
        in_f = cfg.input_feat_per_channel
        for out_f in cfg.input_layers:
            self.input_layers.append(nn.Sequential(nn.Linear(in_f, out_f)))
            in_f = out_f
        self.conv_layers = nn.ModuleList()
        cin, lstm_in = 1, cfg.input_layers[-1]
        for cout, k, s in cfg.conv_layers:
            self.conv_layers.append(nn.Conv2d(cin, cout, k, stride=s,
                                              padding=k // 2))
            cin = cout
            lstm_in //= s
        lstm_in *= cfg.conv_layers[-1][0]
        self.blstm = nn.LSTM(lstm_in, cfg.lstm_size, cfg.num_blstm_layers,
                             batch_first=True, bidirectional=True)
        self.blstm.jax_names = lstm_jax_names(self.blstm)

    def forward(self, src_speech: torch.Tensor, src_lens: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """src_speech (B, T, F) -> ``encoder_out`` (B, T', 2 lstm_size),
        zero at pads, its padding mask and ``out_lengths``; dropout only
        with a generator."""
        cfg = self.cfg
        x = src_speech.to(cfg.dtype)[:, :, None, :]          # (B, T, 1, F)
        for layer in self.input_layers:
            fc = layer[0]
            x = dropout(torch.tanh(linear(x, fc.weight, fc.bias)),
                        cfg.dropout, generator)
        x = x.permute(0, 2, 1, 3)                            # (B, 1, T, F)
        for conv, (_, k, s) in zip(self.conv_layers, cfg.conv_layers):
            x = F.conv2d(x, conv.weight.to(x.dtype), None, stride=s,
                         padding=k // 2) \
                + conv.bias.to(x.dtype)[None, :, None, None]
        lens = conv_lengths(cfg, src_lens)
        b, _, t2, _ = x.shape
        x = x.permute(0, 2, 1, 3).reshape(b, t2, -1)         # (B, T', C*F')
        x = bilstm_stack(self.blstm, x, lens, lambda y: dropout(
            y, cfg.dropout, generator))
        x = dropout(x, cfg.dropout, generator)
        pad_mask = torch.arange(t2, device=x.device)[None, :] >= lens[:, None]
        x = x.masked_fill(pad_mask[:, :, None], 0.0)
        return {"encoder_out": x, "encoder_padding_mask": pad_mask,
                "out_lengths": lens}


class MLPAttention(nn.Module):
    def __init__(self, context_dim: int, hidden_dim: int, attention_dim: int):
        super().__init__()
        self.encoder_proj = nn.Linear(context_dim, attention_dim)
        self.decoder_proj = nn.Linear(hidden_dim, attention_dim)
        self.to_scores = nn.Linear(attention_dim, 1)

    def forward(self, hidden: torch.Tensor, enc_proj: torch.Tensor,
                enc_out: torch.Tensor, pad_mask: torch.Tensor
                ) -> torch.Tensor:
        """The context (B, C) for hidden (B, H) over enc_out (B, Ts, C),
        whose projection ``enc_proj`` (B, Ts, A) the caller computed once
        (JAX projects it again each step, the same product)."""
        dec = linear(hidden, self.decoder_proj.weight,
                     self.decoder_proj.bias)[:, None, :]
        scores = linear(torch.tanh(enc_proj + dec), self.to_scores.weight,
                        self.to_scores.bias)[:, :, 0]
        scores = scores.float().masked_fill(pad_mask, -math.inf)
        w = torch.softmax(scores, dim=1).to(enc_out.dtype)
        return torch.einsum("bt,btc->bc", w, enc_out)


class BerardDecoder(nn.Module):
    def __init__(self, cfg: BerardConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size,
                                         cfg.decoder_embed_dim,
                                         padding_idx=PAD)
        self.layers = nn.ModuleList(
            nn.LSTMCell(cfg.decoder_embed_dim if i == 0 else cfg.context_dim,
                        cfg.decoder_hidden_dim)
            for i in range(cfg.decoder_num_layers))
        for cell in self.layers:
            cell.jax_names = cell_jax_names()
        self.attention = MLPAttention(cfg.context_dim,
                                      cfg.decoder_hidden_dim,
                                      cfg.attention_dim)
        self.deep_output_layer = nn.Linear(
            cfg.decoder_hidden_dim + cfg.context_dim + cfg.decoder_embed_dim,
            cfg.output_layer_dim)
        self.output_projection = nn.Linear(cfg.output_layer_dim,
                                           cfg.vocab_size)

    def step(self, tok_embed: torch.Tensor, hiddens: List[torch.Tensor],
             cells: List[torch.Tensor], weights: List[List[torch.Tensor]],
             enc_proj: torch.Tensor, enc_out: torch.Tensor,
             pad_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step (``decoder_step``) with each layer's ``cell_weights``:
        updates ``hiddens`` and ``cells`` in place and returns (the top
        layer's hidden, the context)."""
        rate = self.cfg.dropout
        n = len(self.layers)
        inp, ctx = tok_embed, None
        for i, w in enumerate(weights):
            j = (i - 1) % n
            h, c = torch.lstm_cell(inp, (hiddens[j], cells[j]), *w)
            h = dropout(h, rate, generator)
            hiddens[i], cells[i] = h, c
            if ctx is None:
                ctx = dropout(self.attention(h, enc_proj, enc_out, pad_mask),
                              rate, generator)
            inp = ctx
        return h, ctx

    def forward(self, prev_tokens: torch.Tensor, enc_out: torch.Tensor,
                pad_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced logits (B, Tt, V) over ``prev_tokens``."""
        cfg = self.cfg
        rate = cfg.dropout
        emb = dropout(self.embed_tokens.weight.to(cfg.dtype)[prev_tokens],
                      rate, generator)
        att = self.attention
        enc_proj = linear(enc_out, att.encoder_proj.weight,
                          att.encoder_proj.bias)
        # the mean over the PADDED time axis, pads' zeros included
        mean_enc = enc_out.mean(dim=1)
        hiddens = [mean_enc] * cfg.decoder_num_layers
        cells = [enc_out.new_zeros((enc_out.shape[0],
                                    cfg.decoder_hidden_dim))] \
            * cfg.decoder_num_layers
        weights = [cell_weights(cell, cfg.dtype) for cell in self.layers]
        outs, ctxs = [], []
        for t in range(prev_tokens.shape[1]):
            h, ctx = self.step(emb[:, t], hiddens, cells, weights, enc_proj,
                               enc_out, pad_mask, generator)
            outs.append(h)
            ctxs.append(ctx)
        x = torch.cat([torch.stack(outs, 1), torch.stack(ctxs, 1), emb], -1)
        x = torch.tanh(linear(x, self.deep_output_layer.weight,
                              self.deep_output_layer.bias))
        x = dropout(x, rate, generator)
        return linear(x, self.output_projection.weight,
                      self.output_projection.bias)


class Berard(nn.Module):
    jax_rules = (
        (r"^encoder\.input_layers\.(\d+)\.0$", r"encoder::input\1"),
        (r"^encoder\.conv_layers\.(\d+)$", r"encoder::conv\1"),
        (r"^encoder\.blstm$", "encoder"),
        (r"^decoder\.layers\.(\d+)$", r"decoder::cell\1"),
        (r"^decoder\.attention\.(encoder_proj|decoder_proj|to_scores)$",
         r"decoder::attn_\1"),
        (r"^decoder\.deep_output_layer$", "decoder::deep_output"),
    )

    def __init__(self, cfg: BerardConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = BerardEncoder(cfg)
        self.decoder = BerardDecoder(cfg)

    def forward(self, batch: Dict[str, Any], prev_tokens: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None
                ) -> Dict[str, Any]:
        """Teacher-forced forward (``forward``, :177-221); dropout at every
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
    def init_weights(self, seed: int) -> "Berard":
        """Seeded random init with ``init_berard``'s distributions
        (:61-98): torch's default uniform over the fan-in for the linears
        and convs, U(-0.1, 0.1) for the LSTMs and the embedding (its PAD
        row 0)."""
        g = torch.Generator().manual_seed(seed)

        def uniform(t, bound):
            t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)

        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                fan_in = mod.weight[0].numel()
                uniform(mod.weight, 1.0 / math.sqrt(fan_in))
                uniform(mod.bias, 1.0 / math.sqrt(fan_in))
            elif isinstance(mod, (nn.LSTM, nn.LSTMCell)):
                for p in mod.parameters():
                    uniform(p, 0.1)
            elif isinstance(mod, nn.Embedding):
                uniform(mod.weight, 0.1)
                mod.weight[PAD] = 0.0
        return self


def from_jax_variables(cfg: BerardConfig, variables: Dict[str, Any]
                       ) -> Berard:
    """A model of ``cfg`` holding a JAX Berard ``{"params", "stats"}`` tree
    of numpy arrays (strict both ways)."""
    return load_jax_variables(Berard(cfg), variables)
