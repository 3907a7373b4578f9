"""Tacotron2 (``--arch tacotron_2``, ``tacotron2``).

Counterpart of ``s2st_tpu/models/tacotron2.py``:
- ``encode`` (:155-189): the token embedding (PAD row zero), N x (same-pad
  Conv1d, BatchNorm, ReLU, dropout at ``encoder_dropout``), the packed
  biLSTM of ``embed_dim / 2`` a direction (zeros past each length), then
  the optional speaker concat through ``spk_emb_proj``. In training each
  BatchNorm normalises with the batch's statistics over every (B, T)
  position, padded ones included, as JAX's does.
- ``_zoneout_cell`` (:191-205): in training with a generator each unit
  keeps its old state with probability ``zoneout`` (Bernoulli masks from
  the port's stream); otherwise the two states are interpolated.
- ``_location_attention`` (:207-224): a conv over the 1- or 2-channel
  attention-state image (the weights and, with ``attention_use_cumprob``,
  their running sum), tanh scores, -1e9 at pads, softmax(2 s) in fp32;
  the first context zero or the mean over valid positions
  (``init_attn_c``, :226-249).
- ``_decoder_step`` (:251-289) and the teacher-forced ``forward``
  (:291-348): the always-on prenet (on whenever a generator is given),
  the zoneout attention LSTM over [context; prenet], the attention, the
  zoneout LSTM stack over [context; lower hidden], the feature and EOS
  heads over [context; top hidden], and the postnet's residual (batch
  statistics and dropout in training).
- ``generate_features`` (:350-394), with both quirks of the reference:
  the context is re-initialised at every incremental step, and the
  postnet runs once over the finished sequence.

Names are fairseq's ``Tacotron2Encoder`` / ``Tacotron2Decoder``'s
(``encoder.convolutions.N.{0,1}``, ``encoder.lstm``, ``decoder.prenet``,
``decoder.attention_lstm.lstm_cell``, ``decoder.attention.{proj_enc,
proj_dec,proj_attn,conv,proj_out.1}``, ``decoder.lstm.N.lstm_cell``,
``decoder.{feat,eos}_proj``, ``decoder.postnet``), so a fairseq
state_dict loads as it is; the JAX leaves come from ``jax_rules``, the
encoder's BatchNorm statistics under ``stats::enc_bn<i>``. The
reference's never-applied ``ctc_proj`` is not built (JAX's docstring).
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
from ..nn.core import (batch_norm_eval, batch_norm_train, conv1d, dropout,
                       linear)
from ..nn.tacotron import Postnet, Prenet

PAD = 1


@dataclass(frozen=True)
class Tacotron2Config:
    """``Tacotron2Config`` (:57-89)."""
    vocab_size: int = 1000
    encoder_dropout: float = 0.5
    encoder_embed_dim: int = 512
    encoder_conv_layers: int = 3
    encoder_conv_kernel_size: int = 5
    encoder_lstm_layers: int = 1
    attention_dim: int = 128
    attention_conv_dim: int = 32
    attention_conv_kernel_size: int = 15
    prenet_dropout: float = 0.5
    prenet_layers: int = 2
    prenet_dim: int = 256
    postnet_dropout: float = 0.5
    postnet_layers: int = 5
    postnet_conv_dim: int = 512
    postnet_conv_kernel_size: int = 5
    init_attn_c: str = "zero"
    attention_use_cumprob: bool = True
    zoneout: float = 0.1
    decoder_lstm_layers: int = 2
    decoder_lstm_dim: int = 1024
    output_frame_dim: int = 80
    n_frames_per_step: int = 1
    num_speakers: int = 0
    speaker_embed_dim: int = 64
    dtype: Any = torch.float32

    def replace(self, **kw) -> "Tacotron2Config":
        return dataclasses.replace(self, **kw)

    @property
    def out_dim(self) -> int:
        return self.output_frame_dim * self.n_frames_per_step


class Tacotron2Encoder(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        self.cfg = cfg
        d, k = cfg.encoder_embed_dim, cfg.encoder_conv_kernel_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d, padding_idx=PAD)
        self.convolutions = nn.ModuleList(
            nn.Sequential(nn.Conv1d(d, d, k, padding=(k - 1) // 2),
                          nn.BatchNorm1d(d))
            for _ in range(cfg.encoder_conv_layers))
        for i, (_, bn) in enumerate(self.convolutions):
            bn.jax_names = {
                name: (f"stats::enc_bn{i}::{leaf}",
                       "count" if leaf == "count" else "same")
                for name, leaf in (("running_mean", "mean"),
                                   ("running_var", "var"),
                                   ("num_batches_tracked", "count"))}
        self.lstm = nn.LSTM(d, d // 2, cfg.encoder_lstm_layers,
                            batch_first=True, bidirectional=True)
        self.lstm.jax_names = lstm_jax_names(self.lstm)
        self.embed_speaker = self.spk_emb_proj = None
        if cfg.num_speakers > 0:
            self.embed_speaker = nn.Embedding(cfg.num_speakers,
                                              cfg.speaker_embed_dim)
            self.spk_emb_proj = nn.Linear(d + cfg.speaker_embed_dim, d)

    def forward(self, src_tokens: torch.Tensor, src_lens: torch.Tensor,
                speaker: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> Dict[str, Any]:
        """src_tokens (B, T) -> ``encoder_out`` (B, T, D), the padding mask
        (PAD tokens) and ``new_stats`` {"bnI": {"mean", "var", "count"}}
        (updated with ``train``, the buffers' own otherwise). Dropout only
        with a generator."""
        cfg = self.cfg
        x = self.embed_tokens.weight.to(cfg.dtype)[src_tokens]
        pad = (cfg.encoder_conv_kernel_size - 1) // 2
        new_stats = {}
        for i, (conv, bn) in enumerate(self.convolutions):
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
        x = bilstm_stack(self.lstm, x, src_lens)
        if self.embed_speaker is not None and speaker is not None:
            b, t, _ = x.shape
            emb = self.embed_speaker.weight.to(x.dtype)[speaker.reshape(-1)]
            x = linear(torch.cat([x, emb[:, None, :].expand(b, t, -1)], -1),
                       self.spk_emb_proj.weight, self.spk_emb_proj.bias)
        return {"encoder_out": x, "encoder_padding_mask": src_tokens == PAD,
                "new_stats": new_stats}


class ZoneoutLSTMCell(nn.Module):
    """fairseq's ``LSTMCellWithZoneOut``: an ``nn.LSTMCell`` under
    ``lstm_cell`` and the zoneout probability."""

    def __init__(self, prob: float, input_size: int, hidden_size: int):
        super().__init__()
        self.prob = prob
        self.lstm_cell = nn.LSTMCell(input_size, hidden_size)
        self.lstm_cell.jax_names = cell_jax_names()

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                weights: List[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_zoneout_cell`` with the cell's ``cell_weights``: each unit
        keeps its old state with probability ``prob`` when a generator is
        given; else the old and new states are interpolated."""
        h_new, c_new = torch.lstm_cell(x, (h, c), *weights)
        p = self.prob
        if p <= 0.0:
            return h_new, c_new
        if generator is None:
            return p * h + (1 - p) * h_new, p * c + (1 - p) * c_new
        keep_h = torch.rand(h.shape, generator=generator,
                            device=h.device) < p
        keep_c = torch.rand(c.shape, generator=generator,
                            device=c.device) < p
        return torch.where(keep_h, h, h_new), torch.where(keep_c, c, c_new)


class LocationAttention(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        d, a, k = (cfg.encoder_embed_dim, cfg.attention_dim,
                   cfg.attention_conv_kernel_size)
        self.kernel_size = k
        self.proj_enc = nn.Linear(d, a)
        self.proj_dec = nn.Linear(cfg.decoder_lstm_dim, a, bias=False)
        self.proj_attn = nn.Linear(cfg.attention_conv_dim, a, bias=False)
        self.conv = nn.Conv1d(2 if cfg.attention_use_cumprob else 1,
                              cfg.attention_conv_dim, 2 * k + 1, padding=k,
                              bias=False)
        self.proj_out = nn.Sequential(nn.Tanh(), nn.Linear(a, 1))

    def forward(self, enc_out: torch.Tensor, proj_enc: torch.Tensor,
                pad_mask: torch.Tensor, dec_h: torch.Tensor,
                attn_state: torch.Tensor, w: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context (B, D), weights (B, T)) for the attention LSTM's
        hidden ``dec_h`` and ``attn_state`` (B, K, T); ``w`` the decoder's
        ``step_weights``."""
        a = conv1d(attn_state.transpose(1, 2), w["attn_conv"],
                   padding=self.kernel_size)
        a = linear(a, w["proj_attn"])
        dec = linear(dec_h, w["proj_dec"])
        s = linear(torch.tanh(a + proj_enc + dec[:, None, :]),
                   *w["proj_out"])[:, :, 0]
        # -1e9, not -inf: a pad row (length 0) stays finite (JAX's note)
        s = s.float().masked_fill(pad_mask, -1e9)
        w = torch.softmax(2.0 * s, dim=1).to(enc_out.dtype)
        return torch.einsum("bt,btc->bc", w, enc_out), w


class Tacotron2Decoder(nn.Module):
    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.encoder_embed_dim, cfg.decoder_lstm_dim
        self.prenet = Prenet(cfg.out_dim, cfg.prenet_layers, cfg.prenet_dim)
        self.attention_lstm = ZoneoutLSTMCell(cfg.zoneout,
                                              cfg.prenet_dim + d, h)
        self.attention = LocationAttention(cfg)
        self.lstm = nn.ModuleList(ZoneoutLSTMCell(cfg.zoneout, d + h, h)
                                  for _ in range(cfg.decoder_lstm_layers))
        self.feat_proj = nn.Linear(d + h, cfg.out_dim)
        self.eos_proj = nn.Linear(d + h, 1)
        self.postnet = Postnet(cfg.out_dim, cfg.postnet_conv_dim,
                               cfg.postnet_conv_kernel_size,
                               cfg.postnet_layers)

    def init_state(self, enc_out: torch.Tensor) -> Dict[str, Any]:
        """The zero LSTM and attention state (``init_decoder_state``)."""
        b, t, _ = enc_out.shape
        h = self.cfg.decoder_lstm_dim
        zeros = enc_out.new_zeros
        return {"alstm_h": zeros((b, h)), "alstm_c": zeros((b, h)),
                "lstm_h": [zeros((b, h))] * self.cfg.decoder_lstm_layers,
                "lstm_c": [zeros((b, h))] * self.cfg.decoder_lstm_layers,
                "attn_w": zeros((b, t)), "attn_w_cum": zeros((b, t))}

    def init_context(self, enc_out: torch.Tensor, pad_mask: torch.Tensor
                     ) -> torch.Tensor:
        """``_init_attn_ctx`` (:226-249): zeros, or the mean over each
        row's valid positions (NaN for a pad row, as in JAX)."""
        if self.cfg.init_attn_c == "zero":
            return enc_out.new_zeros((enc_out.shape[0],
                                      self.cfg.encoder_embed_dim))
        w = (~pad_mask).to(enc_out.dtype)
        w = w / w.sum(dim=1, keepdim=True)
        return (enc_out * w[:, :, None]).sum(dim=1)

    def step_weights(self, dtype) -> Dict[str, Any]:
        """The weights a step reads, in ``dtype``, cast once a forward
        (``lstm.cell_weights``: a cast a step keeps a copy a step for the
        backward)."""
        att = self.attention
        out = att.proj_out[1]
        return {"attention_lstm": cell_weights(self.attention_lstm.lstm_cell,
                                               dtype),
                "lstm": [cell_weights(c.lstm_cell, dtype) for c in self.lstm],
                "attn_conv": att.conv.weight.to(dtype),
                "proj_attn": att.proj_attn.weight.to(dtype),
                "proj_dec": att.proj_dec.weight.to(dtype),
                "proj_out": (out.weight.to(dtype), out.bias.to(dtype)),
                "feat_proj": (self.feat_proj.weight.to(dtype),
                              self.feat_proj.bias.to(dtype)),
                "eos_proj": (self.eos_proj.weight.to(dtype),
                             self.eos_proj.bias.to(dtype))}

    def step(self, prenet_t: torch.Tensor, state: Dict[str, Any],
             ctx: torch.Tensor, enc_out: torch.Tensor,
             proj_enc: torch.Tensor, pad_mask: torch.Tensor,
             w: Dict[str, Any], generator: Optional[torch.Generator] = None):
        """One step (``_decoder_step``) with ``step_weights``: (feat (B,
        out_dim), eos logit (B,), weights (B, Ts), the new state, the new
        context); ``generator`` draws the zoneout masks."""
        cfg = self.cfg
        alstm_h, alstm_c = self.attention_lstm(
            torch.cat([ctx, prenet_t], dim=1), state["alstm_h"],
            state["alstm_c"], w["attention_lstm"], generator)
        if cfg.attention_use_cumprob:
            attn_state = torch.stack([state["attn_w"], state["attn_w_cum"]],
                                     dim=1)
        else:
            attn_state = state["attn_w"][:, None, :]
        ctx, attn = self.attention(enc_out, proj_enc, pad_mask, alstm_h,
                                   attn_state, w)
        hs, cs, lower = [], [], alstm_h
        for i, cell in enumerate(self.lstm):
            h_i, c_i = cell(torch.cat([ctx, lower], dim=1),
                            state["lstm_h"][i], state["lstm_c"][i],
                            w["lstm"][i], generator)
            hs.append(h_i)
            cs.append(c_i)
            lower = h_i
        proj_in = torch.cat([ctx, hs[-1]], dim=1)
        feat = linear(proj_in, *w["feat_proj"])
        eos = linear(proj_in, *w["eos_proj"])[:, 0]
        new_state = {"alstm_h": alstm_h, "alstm_c": alstm_c, "lstm_h": hs,
                     "lstm_c": cs, "attn_w": attn,
                     "attn_w_cum": state["attn_w_cum"] + attn}
        return feat, eos, attn, new_state, ctx


class Tacotron2(nn.Module):
    jax_rules = (
        (r"^encoder\.embed_tokens$", "encoder::embed_tokens"),
        (r"^encoder\.convolutions\.(\d+)\.0$", r"encoder::conv\1"),
        (r"^encoder\.convolutions\.(\d+)\.1$", r"encoder::bn\1"),
        (r"^encoder\.lstm$", "encoder"),
        (r"^encoder\.spk_emb_proj$", "encoder::spk_emb_proj"),
        (r"^decoder\.prenet\.layers\.(\d+)\.0$", r"decoder::prenet::fc\1"),
        (r"^decoder\.attention_lstm\.lstm_cell$", "decoder::attention_lstm"),
        (r"^decoder\.attention\.(proj_enc|proj_dec|proj_attn|conv)$",
         r"decoder::attn_\1"),
        (r"^decoder\.attention\.proj_out\.1$", "decoder::attn_proj_out"),
        (r"^decoder\.lstm\.(\d+)\.lstm_cell$", r"decoder::lstm\1"),
    )

    def __init__(self, cfg: Tacotron2Config):
        super().__init__()
        self.cfg = cfg
        self.encoder = Tacotron2Encoder(cfg)
        self.decoder = Tacotron2Decoder(cfg)

    def forward(self, batch: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None
                ) -> Dict[str, Any]:
        """Teacher-forced forward over ``prev_output_tokens`` (B, Tt,
        out_dim) from ``src_text`` / ``src_text_len`` (``forward``,
        :291-348): ``feat_out``, ``post_feat_out``, ``eos_out`` (B, Tt, 1),
        ``attn`` (B, Ts, Tt), the encoder's padding mask and lengths, and
        with ``train`` the ``new_stats`` {"encoder", "postnet"}. A
        generator turns on the prenet's dropout, and with ``train`` every
        other dropout site and the zoneout masks; ``train`` puts the
        BatchNorms on batch statistics. ``layer_keep`` is ignored."""
        cfg, dec = self.cfg, self.decoder
        drop = generator if train else None
        enc = self.encoder(batch["src_text"], batch["src_text_len"],
                           batch.get("speaker"), drop, train)
        enc_out, pad_mask = enc["encoder_out"], enc["encoder_padding_mask"]
        prev = batch["prev_output_tokens"].to(cfg.dtype)
        pre = dec.prenet(prev, cfg.prenet_dropout, generator)
        att = dec.attention
        proj_enc = linear(enc_out, att.proj_enc.weight, att.proj_enc.bias)
        state = dec.init_state(enc_out)
        ctx = dec.init_context(enc_out, pad_mask)
        weights = dec.step_weights(cfg.dtype)
        feats, eoss, ws = [], [], []
        for t in range(prev.shape[1]):
            feat, eos, w, state, ctx = dec.step(pre[:, t], state, ctx,
                                                enc_out, proj_enc, pad_mask,
                                                weights, drop)
            feats.append(feat)
            eoss.append(eos)
            ws.append(w)
        feat_out = torch.stack(feats, dim=1)
        out = {"feat_out": feat_out,
               "eos_out": torch.stack(eoss, dim=1)[:, :, None],
               "attn": torch.stack(ws, dim=2),
               "encoder_padding_mask": pad_mask,
               "encoder_out_lengths": batch["src_text_len"]}
        if train:
            post, post_stats = dec.postnet.train_forward(
                feat_out, cfg.postnet_dropout, drop)
            out["new_stats"] = {"encoder": enc["new_stats"],
                                "postnet": post_stats}
        else:
            post = dec.postnet(feat_out)
        out["post_feat_out"] = feat_out + post
        return out

    @torch.no_grad()
    def generate_features(self, src_tokens: torch.Tensor,
                          src_lens: torch.Tensor, max_iter: int = 600,
                          eos_prob_threshold: float = 0.5,
                          speaker: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Dict[str, torch.Tensor]:
        """Greedy AR decode (``generate_features``, :350-394): ``max_iter``
        steps, each fed the previous step's pre-postnet frame and the
        INITIAL context; the postnet once over the finished frames.
        ``generator`` draws the prenet's dropout. Returns ``feature`` (B,
        max_iter, out_dim), ``eos_prob`` (B, max_iter), ``attn`` (B, Ts,
        max_iter) and ``out_lens``: the first step whose EOS probability
        is above the threshold, plus one, or max_iter."""
        cfg, dec = self.cfg, self.decoder
        enc = self.encoder(src_tokens, src_lens, speaker)
        enc_out, pad_mask = enc["encoder_out"], enc["encoder_padding_mask"]
        b = enc_out.shape[0]
        att = dec.attention
        proj_enc = linear(enc_out, att.proj_enc.weight, att.proj_enc.bias)
        ctx0 = dec.init_context(enc_out, pad_mask)
        state = dec.init_state(enc_out)
        prev = enc_out.new_zeros((b, cfg.out_dim))
        finished = torch.zeros(b, dtype=torch.bool, device=enc_out.device)
        out_lens = torch.full((b,), max_iter, dtype=torch.long,
                              device=enc_out.device)
        weights = dec.step_weights(cfg.dtype)
        feats, eos_probs, ws = [], [], []
        for t in range(max_iter):
            pre = dec.prenet(prev, cfg.prenet_dropout, generator)
            prev, eos, w, state, _ = dec.step(pre, state, ctx0, enc_out,
                                              proj_enc, pad_mask, weights)
            eos_prob = torch.sigmoid(eos.float())
            done = eos_prob > eos_prob_threshold
            out_lens = torch.where(~finished & done, t + 1, out_lens)
            finished = finished | done
            feats.append(prev)
            eos_probs.append(eos_prob)
            ws.append(w)
        feat = torch.stack(feats, dim=1)
        return {"feature": feat + dec.postnet(feat),
                "eos_prob": torch.stack(eos_probs, dim=1),
                "attn": torch.stack(ws, dim=2), "out_lens": out_lens}

    @torch.no_grad()
    def load_stats(self, new_stats: Dict[str, Any]) -> None:
        """Write a training forward's running statistics into the
        buffers: the encoder's BatchNorms and the postnet's."""
        for i, (_, bn) in enumerate(self.encoder.convolutions):
            st = new_stats["encoder"][f"bn{i}"]
            bn.running_mean.copy_(st["mean"])
            bn.running_var.copy_(st["var"])
            bn.num_batches_tracked.copy_(st["count"])
        self.decoder.postnet.load_stats(new_stats["postnet"])

    @torch.no_grad()
    def init_weights(self, seed: int) -> "Tacotron2":
        """Seeded random init with ``init_tacotron2``'s distributions
        (:92-150): normal(0, D^-0.5) embeddings (PAD row 0), xavier convs
        (relu gain in the encoder, tanh in the attention's, tanh/linear in
        the postnet) with torch's uniform biases, U(-0.1, 0.1) LSTMs,
        torch's default uniform linears, BatchNorms at 1 and 0."""
        g = torch.Generator().manual_seed(seed)

        def uniform(t, bound):
            t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                uniform(mod.weight, bound)
                if mod.bias is not None:
                    uniform(mod.bias, bound)
            elif isinstance(mod, (nn.LSTM, nn.LSTMCell)):
                for p in mod.parameters():
                    uniform(p, 0.1)
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                                 * mod.embedding_dim ** -0.5)
                if mod.padding_idx is not None:
                    mod.weight[mod.padding_idx] = 0.0
            elif isinstance(mod, nn.BatchNorm1d):
                mod.reset_parameters()
        post = self.decoder.postnet.convolutions
        convs = [(blk[0], math.sqrt(2.0)) for blk in self.encoder.convolutions]
        convs += [(self.decoder.attention.conv, 5.0 / 3.0)]
        convs += [(blk[0], 5.0 / 3.0 if i < len(post) - 1 else 1.0)
                  for i, blk in enumerate(post)]
        for conv, gain in convs:
            cout, cin, k = conv.weight.shape
            uniform(conv.weight, gain * math.sqrt(6.0 / (cin * k + cout * k)))
            if conv.bias is not None:
                uniform(conv.bias, 1.0 / math.sqrt(cin * k))
        return self


def from_jax_variables(cfg: Tacotron2Config, variables: Dict[str, Any]
                       ) -> Tacotron2:
    """A model of ``cfg`` holding a JAX Tacotron2 ``{"params", "stats"}``
    tree of numpy arrays (``stats/{enc_bn<i>,postnet}``; strict both
    ways)."""
    return load_jax_variables(Tacotron2(cfg), variables)
