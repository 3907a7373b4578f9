"""FastSpeech2: non-autoregressive text to spectrogram (``--arch
fastspeech2``).

Counterpart of ``s2st_tpu/models/fastspeech2.py``:
- the FFT block ``_fft_layer`` (:169-184): post-LN self-attention (the
  port's ``MultiheadAttention``, so each call takes the attention kernel
  when no probability dropout is active: the arch's
  ``--attention-dropout 0``), then the post-LN conv FFN (two same-pad
  convs of ``fft_kernel_size``, ReLU between, dropout after);
- ``_var_predictor`` (:187-194): conv, ReLU, LayerNorm, dropout, then a
  second conv padded by 1 whatever the kernel size (the reference's
  quirk), ReLU, LayerNorm, dropout, a linear to one value a token;
- ``length_regulator`` (:197-214): output j takes the token whose
  cumulative duration first exceeds j, at a static ``max_out`` frames,
  zero at and past each row's sum of durations;
- ``bucketize`` (:217-223): ``searchsorted(side="left")`` against JAX's
  fp32 ``linspace(vmin, vmax, n_bins - 1)``, whose folded arithmetic
  ``bucket_boundaries`` repeats so that a value on a boundary lands in
  JAX's bin;
- ``forward`` (:226-337): the token embedding plus ``pos_emb_alpha`` times
  the pad-aware sinusoidal positions, dropout, the encoder FFT blocks, the
  optional speaker projection, the variance adaptor (durations
  clip(round((exp(log d) - 1) d_factor), 0), then ``min_duration``, 0 at
  pads; pitch and energy bucketed into their embeddings, from the batch's
  values when given, else the predictions times ``p_factor`` /
  ``e_factor``), the length regulator to ``max_out`` frames, the decoder's
  positions times ``dec_pos_emb_alpha``, the decoder FFT blocks, the
  output projection, the optional postnet's residual and the CTC head.

The decoder runs at JAX's static ``max_out`` (the batch's padded target
length in training, ``min(--max-iter, max_target_positions)`` in
serving): padded frames become non-zero after the first FFT layer and the
next layer's convs read them across each row's end, so a shorter buffer
would give other valid frames.

Names are fairseq's ``FastSpeech2Encoder``'s under ``encoder.``
(``embed_tokens``, ``pos_emb_alpha``, ``dec_pos_emb_alpha``,
``encoder_fft_layers.N.{self_attn,layer_norm,ffn.ffn.{0,2},
ffn.layer_norm}``, ``var_adaptor.{duration,pitch,energy}_predictor.
{conv1.0,ln1,conv2.0,ln2,proj}``, ``var_adaptor.embed_{pitch,energy}``,
``decoder_fft_layers.N``, ``out_proj``, ``postnet``, ``embed_speaker``,
``spk_emb_proj``) and a top-level ``ctc_proj``; the JAX tree is flat
(``embed``, ``pos_emb_alpha`` as a scalar, ``enc_layers::i``, ``dur_pred``,
``pitch_pred``, ``energy_pred``, ``embed_pitch``, ``embed_energy``,
``dec_layers::i``, ``out_proj``, ``postnet``, ``spk_proj``,
``ctc_proj``; ``jax_rules``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .jax_bridge import SEP, load_jax_variables
from .s2st_transformer import seeded_init
from ..nn.attention import MultiheadAttention
from ..nn.core import (conv1d, dropout, layer_norm, lengths_to_padding_mask,
                       linear)
from ..nn.tacotron import Postnet
from ..nn.transformer import positions_for_lengths, sinusoidal_table

PAD = 1


@dataclass(frozen=True)
class FS2Config:
    """``FS2Config`` (:33-73)."""
    vocab_size: int = 100
    output_frame_dim: int = 80
    n_frames_per_step: int = 1
    encoder_layers: int = 4
    encoder_embed_dim: int = 256
    encoder_attention_heads: int = 2
    decoder_layers: int = 4
    decoder_embed_dim: int = 256
    decoder_attention_heads: int = 2
    fft_hidden_dim: int = 1024
    fft_kernel_size: int = 9
    dropout: float = 0.2
    attention_dropout: float = 0.0
    var_pred_n_bins: int = 256
    var_pred_hidden_dim: int = 256
    var_pred_kernel_size: int = 3
    var_pred_dropout: float = 0.5
    pitch_min: float = 0.0
    pitch_max: float = 600.0
    energy_min: float = 0.0
    energy_max: float = 5.0
    add_postnet: bool = False
    postnet_layers: int = 5
    postnet_conv_dim: int = 512
    postnet_conv_kernel_size: int = 5
    postnet_dropout: float = 0.5
    num_speakers: int = 0
    speaker_embed_dim: int = 64
    max_source_positions: int = 1024
    max_target_positions: int = 2048
    ctc: bool = False
    dtype: Any = torch.float32

    @property
    def out_dim(self) -> int:
        return self.output_frame_dim * self.n_frames_per_step

    def replace(self, **kw) -> "FS2Config":
        return dataclasses.replace(self, **kw)


@functools.lru_cache(maxsize=8)
def bucket_boundaries(vmin: float, vmax: float, n: int) -> torch.Tensor:
    """The fp32 ``jnp.linspace(vmin, vmax, n)`` of JAX's jitted forward,
    which XLA folds to constants after rewriting vmin (1 - s) + vmax s,
    s = iota / (n - 1), into vmin (1 - iota r) + iota (vmax r) with r the
    fp32 reciprocal of n - 1; the last point is vmax. The textbook
    formula misses it by an ULP at about a third of the 255 pitch
    boundaries."""
    if n == 1:
        return torch.tensor([vmin], dtype=torch.float32)
    r = torch.tensor(1.0, dtype=torch.float32) / (n - 1)
    iota = torch.arange(n - 1, dtype=torch.float32)
    lo = torch.tensor(vmin, dtype=torch.float32)
    hi = torch.tensor(vmax, dtype=torch.float32)
    return torch.cat([lo * (1 - iota * r) + iota * (hi * r), hi[None]])


def bucketize(x: torch.Tensor, vmin: float, vmax: float, n_bins: int
              ) -> torch.Tensor:
    """``_bucketize``: the bin of each value among n_bins - 1 boundaries,
    a value on a boundary in the bin below it (side="left")."""
    bins = bucket_boundaries(float(vmin), float(vmax), n_bins - 1)
    return torch.bucketize(x.float(), bins.to(x.device), right=False)


def length_regulator(x: torch.Tensor, durations: torch.Tensor,
                     max_out_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C) expanded by integer durations (B, T) to (B, max_out_len,
    C), zero at and past each row's sum; returns (out, the sums)."""
    cum = torch.cumsum(durations.long(), dim=1)
    out_lens = cum[:, -1]
    j = torch.arange(max_out_len, device=x.device)
    idx = torch.searchsorted(cum, j.expand(x.shape[0], -1).contiguous(),
                             right=True).clamp(max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    out = out.masked_fill((j[None, :] >= out_lens[:, None])[:, :, None], 0.0)
    return out, out_lens


@functools.lru_cache(maxsize=8)
def _table(n: int, dim: int) -> torch.Tensor:
    return sinusoidal_table(n, dim, PAD)


class FeedForward(nn.Module):
    """fairseq's ``PositionwiseFeedForward``: ``ffn`` (conv, ReLU, conv)
    and ``layer_norm``."""

    def __init__(self, dim: int, hidden: int, k: int):
        super().__init__()
        self.ffn = nn.Sequential(nn.Conv1d(dim, hidden, k,
                                           padding=(k - 1) // 2),
                                 nn.ReLU(),
                                 nn.Conv1d(hidden, dim, k,
                                           padding=(k - 1) // 2))
        self.layer_norm = nn.LayerNorm(dim)


class FFTLayer(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, k: int):
        super().__init__()
        self.kernel_size = k
        self.self_attn = MultiheadAttention(dim, heads)
        self.layer_norm = nn.LayerNorm(dim)
        self.ffn = FeedForward(dim, hidden, k)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, rate: float,
                attn_rate: float, generator: Optional[torch.Generator]
                ) -> torch.Tensor:
        """``_fft_layer``: post-LN attention, then the post-LN conv FFN."""
        h, _ = self.self_attn(x, x, x, key_padding_mask=pad_mask,
                              dropout_rate=attn_rate, generator=generator)
        x = layer_norm(x + h, self.layer_norm.weight, self.layer_norm.bias)
        pad = (self.kernel_size - 1) // 2
        conv1, conv2 = self.ffn.ffn[0], self.ffn.ffn[2]
        h = F.relu(conv1d(x, conv1.weight, conv1.bias, padding=pad))
        h = dropout(conv1d(h, conv2.weight, conv2.bias, padding=pad), rate,
                    generator)
        ln = self.ffn.layer_norm
        return layer_norm(x + h, ln.weight, ln.bias)


class VariancePredictor(nn.Module):
    def __init__(self, dim: int, hidden: int, k: int):
        super().__init__()
        self.kernel_size = k
        self.conv1 = nn.Sequential(nn.Conv1d(dim, hidden, k,
                                             padding=(k - 1) // 2),
                                   nn.ReLU())
        self.ln1 = nn.LayerNorm(hidden)
        # padding 1 whatever the kernel (the reference's quirk)
        self.conv2 = nn.Sequential(nn.Conv1d(hidden, hidden, k, padding=1),
                                   nn.ReLU())
        self.ln2 = nn.LayerNorm(hidden)
        self.proj = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor, rate: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """(B, T, C) -> (B, T) (``_var_predictor``)."""
        c1, c2 = self.conv1[0], self.conv2[0]
        h = F.relu(conv1d(x, c1.weight, c1.bias,
                          padding=(self.kernel_size - 1) // 2))
        h = dropout(layer_norm(h, self.ln1.weight, self.ln1.bias), rate,
                    generator)
        h = F.relu(conv1d(h, c2.weight, c2.bias, padding=1))
        h = dropout(layer_norm(h, self.ln2.weight, self.ln2.bias), rate,
                    generator)
        return linear(h, self.proj.weight, self.proj.bias)[:, :, 0]


class VarianceAdaptor(nn.Module):
    def __init__(self, cfg: FS2Config):
        super().__init__()
        d, h, k = (cfg.encoder_embed_dim, cfg.var_pred_hidden_dim,
                   cfg.var_pred_kernel_size)
        self.duration_predictor = VariancePredictor(d, h, k)
        self.pitch_predictor = VariancePredictor(d, h, k)
        self.energy_predictor = VariancePredictor(d, h, k)
        self.embed_pitch = nn.Embedding(cfg.var_pred_n_bins, d)
        self.embed_energy = nn.Embedding(cfg.var_pred_n_bins, d)


class FastSpeech2Encoder(nn.Module):
    def __init__(self, cfg: FS2Config):
        super().__init__()
        self.cfg = cfg
        d = cfg.encoder_embed_dim
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d, padding_idx=PAD)
        self.pos_emb_alpha = nn.Parameter(torch.ones(1))
        self.dec_pos_emb_alpha = nn.Parameter(torch.ones(1))
        self.jax_names = {
            name: (SEP.join(["params", name]), "scalar")
            for name in ("pos_emb_alpha", "dec_pos_emb_alpha")}
        self.encoder_fft_layers = nn.ModuleList(
            FFTLayer(d, cfg.encoder_attention_heads, cfg.fft_hidden_dim,
                     cfg.fft_kernel_size)
            for _ in range(cfg.encoder_layers))
        self.var_adaptor = VarianceAdaptor(cfg)
        self.decoder_fft_layers = nn.ModuleList(
            FFTLayer(cfg.decoder_embed_dim, cfg.decoder_attention_heads,
                     cfg.fft_hidden_dim, cfg.fft_kernel_size)
            for _ in range(cfg.decoder_layers))
        self.out_proj = nn.Linear(cfg.decoder_embed_dim, cfg.out_dim)
        self.postnet = Postnet(cfg.out_dim, cfg.postnet_conv_dim,
                               cfg.postnet_conv_kernel_size,
                               cfg.postnet_layers) \
            if cfg.add_postnet else None
        self.embed_speaker = self.spk_emb_proj = None
        if cfg.num_speakers > 0:
            self.embed_speaker = nn.Embedding(cfg.num_speakers,
                                              cfg.speaker_embed_dim)
            self.spk_emb_proj = nn.Linear(d + cfg.speaker_embed_dim, d)


class FastSpeech2(nn.Module):
    jax_rules = [
        *((rf"^encoder\.{side}_fft_layers\.(\d+)\.{part}$",
           rf"{tree}::\1::{leaf}")
          for side, tree in (("encoder", "enc_layers"),
                             ("decoder", "dec_layers"))
          for part, leaf in ((r"layer_norm", "attn_ln"),
                             (r"ffn\.ffn\.0", "conv1"),
                             (r"ffn\.ffn\.2", "conv2"),
                             (r"ffn\.layer_norm", "ffn_ln"))),
        (r"^encoder\.encoder_fft_layers\.(\d+)\.", r"enc_layers::\1::"),
        (r"^encoder\.decoder_fft_layers\.(\d+)\.", r"dec_layers::\1::"),
        *((rf"^encoder\.var_adaptor\.{name}_predictor\.(conv\d)\.0$",
           rf"{short}_pred::\1")
          for name, short in (("duration", "dur"), ("pitch", "pitch"),
                              ("energy", "energy"))),
        *((rf"^encoder\.var_adaptor\.{name}_predictor\.",
           f"{short}_pred::")
          for name, short in (("duration", "dur"), ("pitch", "pitch"),
                              ("energy", "energy"))),
        (r"^encoder\.var_adaptor\.embed_(pitch|energy)$", r"embed_\1"),
        (r"^encoder\.embed_tokens$", "embed"),
        # ``out_proj`` reads ``out`` here: the shared renames come first
        (r"^encoder\.out$", "out_proj"),
        (r"^encoder\.postnet\.convolutions\.(\d+)\.0$", r"postnet::conv\1"),
        (r"^encoder\.postnet\.convolutions\.(\d+)\.1$", r"postnet::bn\1"),
        (r"^encoder\.spk_emb_proj$", "spk_proj"),
        (r"^encoder\.embed_speaker$", "embed_speaker"),
    ]

    def __init__(self, cfg: FS2Config):
        super().__init__()
        self.cfg = cfg
        self.encoder = FastSpeech2Encoder(cfg)
        self.ctc_proj = nn.Linear(cfg.out_dim, cfg.vocab_size) \
            if cfg.ctc else None

    def forward(self, src_tokens: torch.Tensor, src_lengths: torch.Tensor,
                speaker: Optional[torch.Tensor] = None,
                durations: Optional[torch.Tensor] = None,
                pitches: Optional[torch.Tensor] = None,
                energies: Optional[torch.Tensor] = None,
                max_out_len: Optional[int] = None, d_factor: float = 1.0,
                p_factor: float = 1.0, e_factor: float = 1.0,
                min_duration: int = 0, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        """One pass (``forward``): teacher-forced where durations, pitches
        and energies are given, free-running otherwise, at ``max_out_len``
        frames (``max_target_positions`` when not given). Dropout at every
        site with ``train`` and a generator. Returns ``feat_out``,
        ``post_feat_out``, ``out_lens``, ``log_dur_out``, ``pitch_out``,
        ``energy_out``, ``new_stats`` (the postnet's with ``train``) and,
        with the CTC head, ``ctc_logits``."""
        cfg, enc = self.cfg, self.encoder
        va = enc.var_adaptor
        drop = generator if train else None
        b, t = src_tokens.shape
        max_out = max_out_len or cfg.max_target_positions
        x = enc.embed_tokens.weight.to(cfg.dtype)[src_tokens]
        enc_pad = src_tokens == PAD
        table = _table(cfg.max_source_positions + PAD + 1,
                       cfg.encoder_embed_dim).to(x.device)
        x = x + enc.pos_emb_alpha.to(x.dtype) * positions_for_lengths(
            table, src_lengths, t, PAD, x.dtype)
        x = dropout(x, cfg.dropout, drop)
        for layer in enc.encoder_fft_layers:
            x = layer(x, enc_pad, cfg.dropout, cfg.attention_dropout, drop)
        if speaker is not None and enc.embed_speaker is not None:
            emb = enc.embed_speaker.weight.to(x.dtype)[speaker.reshape(-1)]
            x = linear(torch.cat([x, emb[:, None, :].expand(b, t, -1)], 2),
                       enc.spk_emb_proj.weight, enc.spk_emb_proj.bias)

        rate = cfg.var_pred_dropout
        log_dur_out = va.duration_predictor(x, rate, drop)
        dur_out = torch.clamp(torch.round((torch.exp(log_dur_out) - 1.0)
                                          * d_factor), min=0).long()
        dur_out = torch.clamp(dur_out, min=min_duration)
        dur_out = dur_out.masked_fill(enc_pad, 0)

        pitch_out = va.pitch_predictor(x, rate, drop)
        pitch_src = pitches if pitches is not None else pitch_out * p_factor
        x = x + va.embed_pitch.weight.to(x.dtype)[bucketize(
            pitch_src, cfg.pitch_min, cfg.pitch_max, cfg.var_pred_n_bins)]
        energy_out = va.energy_predictor(x, rate, drop)
        energy_src = energies if energies is not None \
            else energy_out * e_factor
        x = x + va.embed_energy.weight.to(x.dtype)[bucketize(
            energy_src, cfg.energy_min, cfg.energy_max, cfg.var_pred_n_bins)]

        x, out_lens = length_regulator(
            x, durations if durations is not None else dur_out, max_out)
        # free-running durations may sum past the buffer
        out_lens = out_lens.clamp(max=max_out)
        dec_pad = lengths_to_padding_mask(out_lens, max_out)
        dec_table = _table(cfg.max_target_positions + PAD + 1,
                           cfg.decoder_embed_dim).to(x.device)
        x = x + enc.dec_pos_emb_alpha.to(x.dtype) * positions_for_lengths(
            dec_table, out_lens, max_out, PAD, x.dtype)
        for layer in enc.decoder_fft_layers:
            x = layer(x, dec_pad, cfg.dropout, cfg.attention_dropout, drop)
        feat = linear(x, enc.out_proj.weight, enc.out_proj.bias)
        out: Dict[str, Any] = {
            "feat_out": feat, "post_feat_out": feat, "out_lens": out_lens,
            "log_dur_out": log_dur_out, "pitch_out": pitch_out,
            "energy_out": energy_out, "new_stats": {}}
        if enc.postnet is not None:
            if train:
                res, stats = enc.postnet.train_forward(
                    feat, cfg.postnet_dropout, drop)
                out["new_stats"] = {"postnet": stats}
            else:
                res = enc.postnet(feat)
            out["post_feat_out"] = feat + res
        if self.ctc_proj is not None:
            out["ctc_logits"] = linear(feat, self.ctc_proj.weight,
                                       self.ctc_proj.bias)
        return out

    @torch.no_grad()
    def load_stats(self, new_stats: Dict[str, Any]) -> None:
        """Write a training forward's postnet statistics into the
        buffers."""
        if new_stats.get("postnet"):
            self.encoder.postnet.load_stats(new_stats["postnet"])

    @torch.no_grad()
    def init_weights(self, seed: int) -> "FastSpeech2":
        """Seeded random init with ``init_fs2``'s distributions (:92-143):
        the S2ST model's for the linears, norms, embeddings, attention and
        postnet; xavier (relu gain) FFN and predictor convs with torch's
        uniform biases; both alphas 1."""
        g = torch.Generator().manual_seed(seed)
        seeded_init(self, g, postnet=self.encoder.postnet)
        enc = self.encoder
        convs = [c for layer in [*enc.encoder_fft_layers,
                                 *enc.decoder_fft_layers]
                 for c in (layer.ffn.ffn[0], layer.ffn.ffn[2])]
        va = enc.var_adaptor
        convs += [p.conv1[0] for p in (va.duration_predictor,
                                       va.pitch_predictor,
                                       va.energy_predictor)]
        convs += [p.conv2[0] for p in (va.duration_predictor,
                                       va.pitch_predictor,
                                       va.energy_predictor)]
        for conv in convs:
            cout, cin, k = conv.weight.shape
            a = math.sqrt(2.0) * math.sqrt(6.0 / (cin * k + cout * k))
            conv.weight.copy_(torch.rand(conv.weight.shape, generator=g)
                              * (2 * a) - a)
            bound = 1.0 / math.sqrt(cin * k)
            conv.bias.copy_(torch.rand(conv.bias.shape, generator=g)
                            * (2 * bound) - bound)
        enc.pos_emb_alpha.fill_(1.0)
        enc.dec_pos_emb_alpha.fill_(1.0)
        return self


def from_jax_variables(cfg: FS2Config, variables: Dict[str, Any]
                       ) -> FastSpeech2:
    """A model of ``cfg`` holding a JAX FastSpeech2 ``{"params", "stats"}``
    tree of numpy arrays (strict both ways; the layer lists by index)."""
    return load_jax_variables(FastSpeech2(cfg), variables)
