"""Direct speech-to-speech translation transformer.

Counterpart of ``s2st_tpu/models/s2st_transformer.py``: conv1d-GLU
subsampler, transformer encoder with middle-layer taps, the autoregressive
spectrogram decoder (prenet -> transformer -> feat/eos projections ->
postnet residual), the aux ASR/ST text decoders over encoder taps, the
CTC projection and, with ``use_hubert``, the frozen HuBERT frontend over the
raw waveform (``models/hubert.py``). The module tree carries fairseq
``state_dict`` names.
``forward`` is the teacher-forced training forward (:632-687); dropout runs
when a ``torch.Generator`` is given, and ``train`` puts the postnet on batch
statistics and the encoder on LayerDrop (:404-412). Activations are
(B, T, C).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import hubert as hub
from .jax_bridge import load_jax_variables
from ..nn.attention import MultiheadAttention
from ..nn.core import (conv1d, dropout, glu, layer_norm,
                       lengths_to_padding_mask, linear, scaled)
from ..nn.tacotron import Postnet, Prenet
from ..nn.transformer import (TransformerDecoderLayer,
                              TransformerEncoderLayer, positions_for_lengths,
                              sinusoidal_table)

PAD = 1  # fairseq Dictionary: bos=0 pad=1 eos=2 unk=3


@dataclass(frozen=True)
class S2STConfig:
    """The fields of ``s2st_tpu.models.s2st_transformer.S2STConfig``
    (:48-139) that the port reads."""
    src_vocab_size: int = 100
    tgt_vocab_size: int = 100
    input_feat_per_channel: int = 80
    input_channels: int = 1
    conv_kernel_sizes: Tuple[int, ...] = (5, 5)
    conv_channels: int = 1024
    encoder_layers: int = 12
    encoder_embed_dim: int = 512
    encoder_ffn_embed_dim: int = 2048
    encoder_attention_heads: int = 4
    encoder_normalize_before: bool = True
    middle_layers: Tuple[int, ...] = (6,)
    decoder_layers: int = 6
    decoder_embed_dim: int = 512
    decoder_ffn_embed_dim: int = 2048
    decoder_attention_heads: int = 4
    decoder_normalize_before: bool = True
    output_frame_dim: int = 80
    n_frames_per_step: int = 1
    prenet_layers: int = 2
    prenet_dim: int = 256
    prenet_dropout: float = 0.5
    postnet_layers: int = 5
    postnet_conv_dim: int = 512
    postnet_conv_kernel_size: int = 5
    postnet_dropout: float = 0.5
    ctc: bool = False
    aux_asr: bool = False
    aux_st: bool = False
    ctc_tgt: bool = False
    middle_layers_decoder: Tuple[int, ...] = ()
    asr_decoder_layers: int = 6
    asr_decoder_embed_dim: int = 256
    st_decoder_layers: int = 6
    st_decoder_embed_dim: int = 256
    num_speakers: int = 0
    speaker_embed_dim: int = 64
    speaker_embed_dim_dec: int = 64
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.01
    encoder_layerdrop: float = 0.0
    activation_fn: str = "relu"
    no_scale_embedding: bool = False
    max_source_positions: int = 3000
    max_target_positions: int = 2400
    # the frozen HuBERT frontend (hubert-base widths)
    use_hubert: bool = False
    hubert_hidden: int = 768
    hubert_layers: int = 12
    hubert_ffn: int = 3072
    hubert_heads: int = 12
    dtype: Any = torch.bfloat16

    @property
    def out_dim(self) -> int:
        return self.output_frame_dim * self.n_frames_per_step

    def replace(self, **kw) -> "S2STConfig":
        return dataclasses.replace(self, **kw)

    def dropout_rates(self) -> Dict[str, float]:
        """The transformer layers' dropout keyword arguments."""
        return {"dropout_rate": self.dropout,
                "attention_dropout": self.attention_dropout,
                "activation_dropout": self.activation_dropout}


class Conv1dSubsampler(nn.Module):
    def __init__(self, cfg: S2STConfig):
        super().__init__()
        in_ch = cfg.hubert_hidden if cfg.use_hubert \
            else cfg.input_feat_per_channel * cfg.input_channels
        n = len(cfg.conv_kernel_sizes)
        self.conv_layers = nn.ModuleList(
            nn.Conv1d(in_ch if i == 0 else cfg.conv_channels // 2,
                      cfg.conv_channels if i < n - 1
                      else cfg.encoder_embed_dim * 2,
                      k, stride=2, padding=k // 2)
            for i, k in enumerate(cfg.conv_kernel_sizes))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T, C) -> (B, ceil(T / 2^n), encoder_embed_dim); lengths
        become (L - 1) // 2 + 1 per layer, and frames past each valid
        length are zeroed after every conv (models/s2st_transformer.py:275)."""
        for conv in self.conv_layers:
            x = glu(conv1d(x, conv.weight, conv.bias, stride=2,
                           padding=conv.kernel_size[0] // 2), dim=-1)
            lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
            valid = torch.arange(x.shape[1], device=x.device)[None, :, None] \
                < lengths[:, None, None]
            x = x.masked_fill(~valid, 0.0)
        return x, lengths


class S2STEncoder(nn.Module):
    def __init__(self, cfg: S2STConfig):
        super().__init__()
        self.cfg = cfg
        # the frozen frontend: fairseq's encoder.hubert, JAX's
        # params["hubert"]
        self.hubert = hub.HubertModel(hub.frontend_config(cfg)) \
            if cfg.use_hubert else None
        self.subsample = Conv1dSubsampler(cfg)
        self.transformer_layers = nn.ModuleList(
            TransformerEncoderLayer(cfg.encoder_embed_dim,
                                    cfg.encoder_ffn_embed_dim,
                                    cfg.encoder_attention_heads,
                                    cfg.encoder_normalize_before,
                                    cfg.activation_fn, **cfg.dropout_rates())
            for _ in range(cfg.encoder_layers))
        dim = cfg.encoder_embed_dim
        self.layer_norm = nn.LayerNorm(dim) \
            if cfg.encoder_normalize_before else None
        self.aux_asr_norm = nn.LayerNorm(dim) if cfg.aux_asr else None
        self.aux_st_norm = nn.LayerNorm(dim) if cfg.aux_st else None
        self.embed_speaker = nn.Embedding(cfg.num_speakers,
                                          cfg.speaker_embed_dim) \
            if cfg.num_speakers > 0 else None
        self.register_buffer(
            "pos_table", sinusoidal_table(cfg.max_source_positions + PAD + 1,
                                          dim, PAD), persistent=False)

    def forward(self, src_feats: torch.Tensor, src_lengths: torch.Tensor,
                speaker: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None
                ) -> Dict[str, Any]:
        """models/s2st_transformer.py:305 (no pipeline); dropout only with
        a generator. ``layer_keep``: LayerDrop's decision for each layer,
        for the whole batch; a dropped layer passes its input on (and a
        middle-layer tap takes it). With the HuBERT frontend, src_feats is
        the (B, L) waveform and src_lengths its samples; the frontend runs
        without a gradient and keeps no activation for the backward
        (:319-334)."""
        cfg = self.cfg
        if self.hubert is not None:
            with torch.no_grad():
                src_feats, src_lengths = self.hubert.extract_features(
                    src_feats, src_lengths)
        x, out_lengths = self.subsample(src_feats.to(cfg.dtype), src_lengths)
        t_out = x.shape[1]
        if not cfg.no_scale_embedding:
            x = scaled(x, math.sqrt(cfg.encoder_embed_dim))
        padding_mask = lengths_to_padding_mask(out_lengths, t_out)
        x = x + positions_for_lengths(self.pos_table, out_lengths, t_out, PAD,
                                      x.dtype)
        if speaker is not None and self.embed_speaker is not None:
            spk = self.embed_speaker.weight.to(x.dtype)[
                speaker.reshape(-1)][:, None, :]
            if spk.shape[-1] != x.shape[-1]:
                # one --speaker-embed-dim sizes both tables (JAX's fault,
                # options.py:2490-2491): JAX's add raises TypeError
                raise TypeError(f"add got incompatible shapes for "
                                f"broadcasting: {tuple(x.shape)}, "
                                f"{tuple(spk.shape)}")
            x = x + spk
        x = dropout(x, cfg.dropout, generator)
        middle: List[torch.Tensor] = []
        for i, layer in enumerate(self.transformer_layers):
            if layer_keep is None or layer_keep[i]:
                x = layer(x, padding_mask, generator)
            if i in cfg.middle_layers:
                middle.append(x)
        if self.layer_norm is not None:
            x = layer_norm(x, self.layer_norm.weight, self.layer_norm.bias)
        if middle and self.aux_asr_norm is not None:
            middle[0] = layer_norm(middle[0], self.aux_asr_norm.weight,
                                   self.aux_asr_norm.bias)
        if len(middle) > 1 and self.aux_st_norm is not None:
            middle[1] = layer_norm(middle[1], self.aux_st_norm.weight,
                                   self.aux_st_norm.bias)
        return {"encoder_out": x, "encoder_padding_mask": padding_mask,
                "out_middle_layers": middle, "out_lengths": out_lengths}


class SpectrogramDecoder(nn.Module):
    def __init__(self, cfg: S2STConfig):
        super().__init__()
        self.cfg = cfg
        dim = cfg.decoder_embed_dim
        self.prenet = nn.Sequential(
            Prenet(cfg.out_dim, cfg.prenet_layers, cfg.prenet_dim),
            nn.Linear(cfg.prenet_dim, dim))
        self.pos_emb_alpha = nn.Parameter(torch.ones(1))
        self.transformer_layers = nn.ModuleList(
            TransformerDecoderLayer(dim, cfg.decoder_ffn_embed_dim,
                                    cfg.decoder_attention_heads,
                                    kv_dim=cfg.encoder_embed_dim,
                                    normalize_before=cfg.decoder_normalize_before,
                                    activation=cfg.activation_fn,
                                    **cfg.dropout_rates())
            for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(dim) \
            if cfg.decoder_normalize_before else None
        self.feat_proj = nn.Linear(dim, cfg.out_dim)
        self.eos_proj = nn.Linear(dim, 1)
        self.postnet = Postnet(cfg.out_dim, cfg.postnet_conv_dim,
                               cfg.postnet_conv_kernel_size,
                               cfg.postnet_layers)
        self.embed_speaker = nn.Embedding(cfg.num_speakers,
                                          cfg.speaker_embed_dim_dec) \
            if cfg.num_speakers > 0 else None
        self.ctc_proj = nn.Linear(cfg.encoder_embed_dim, cfg.src_vocab_size) \
            if cfg.ctc else None
        self.ctc_proj_tgt = nn.Linear(dim, cfg.tgt_vocab_size) \
            if cfg.ctc_tgt else None
        self.register_buffer(
            "pos_table", sinusoidal_table(cfg.max_target_positions + PAD + 1,
                                          dim, PAD), persistent=False)

    def prenet_in(self, prev: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
        """Prenet (dropout on when a generator is given) and its projection."""
        proj = self.prenet[1]
        x = self.prenet[0](prev, self.cfg.prenet_dropout, generator)
        return linear(x, proj.weight, proj.bias)

    def heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Final norm, then the feature and eos projections."""
        if self.layer_norm is not None:
            x = layer_norm(x, self.layer_norm.weight, self.layer_norm.bias)
        return (linear(x, self.feat_proj.weight, self.feat_proj.bias),
                linear(x, self.eos_proj.weight, self.eos_proj.bias))

    def forward(self, prev_output: torch.Tensor, tgt_lengths: torch.Tensor,
                encoder_out: Dict[str, Any],
                speaker: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                train: bool = False) -> Dict[str, Any]:
        """Teacher-forced decode (models/s2st_transformer.py:437).
        prev_output (B, Tt, out_dim) shifted targets. A generator turns on
        the prenet's dropout, and with ``train`` the other dropout sites
        too (JAX's rng and ``deterministic = not train``); ``train`` puts
        the postnet on batch statistics. Returns
        feat_out, post_feat_out (B, Tt, out_dim), eos_out (B, Tt, 1), attn
        (B, Tt, Ts), the last layer's head-averaged cross-attention,
        out_middle_layers_decoder, the outputs of the layers
        ``middle_layers_decoder`` names (the MTL taps, :538, :557), and,
        with ``train``, new_stats {"postnet": the postnet's running
        stats}."""
        cfg = self.cfg
        b, tt, _ = prev_output.shape
        x = prev_output.to(cfg.dtype)
        if speaker is not None and self.embed_speaker is not None:
            spk = self.embed_speaker.weight.to(cfg.dtype)[speaker.reshape(-1)]
            if spk.shape[-1] != x.shape[-1]:
                # the decoder's speaker frame replaces the first frame: as
                # JAX's concatenate, a width other than the frame's raises
                # TypeError
                raise TypeError(f"Cannot concatenate arrays with shapes that "
                                f"differ in dimensions other than the one "
                                f"being concatenated: {tuple(spk.shape)}, "
                                f"{tuple(x.shape)}")
            x = torch.cat([spk[:, None, :], x[:, 1:, :]], dim=1)
        x = self.prenet_in(x, generator)
        drop = generator if train else None
        pos = positions_for_lengths(self.pos_table, tgt_lengths, tt, PAD,
                                    x.dtype)
        x = x + self.pos_emb_alpha.to(x.dtype) * pos
        x = dropout(x, cfg.dropout, drop)
        self_pad = lengths_to_padding_mask(tgt_lengths, tt)
        enc = encoder_out["encoder_out"]
        enc_pad = encoder_out["encoder_padding_mask"]
        attn = None
        taps: List[torch.Tensor] = []
        last = len(self.transformer_layers) - 1
        for i, layer in enumerate(self.transformer_layers):
            x, w = layer(x, enc, enc_pad, self_pad, need_attn=(i == last),
                         generator=drop)
            if w is not None:
                attn = w.mean(dim=1)
            if i in cfg.middle_layers_decoder:
                taps.append(x)
        feat_out, eos_out = self.heads(x)
        out = {"feat_out": feat_out, "eos_out": eos_out, "attn": attn,
               "out_middle_layers_decoder": taps}
        if train:
            post, stats = self.postnet.train_forward(
                feat_out, cfg.postnet_dropout, drop)
            out["new_stats"] = {"postnet": stats}
        else:
            post = self.postnet(feat_out)
        out["post_feat_out"] = feat_out + post
        return out


AUX_MAX_POSITIONS = 1024  # aux_decode's max_positions default (:569)


class AuxTextDecoder(nn.Module):
    """An aux ASR/ST transformer text decoder over an encoder tap
    (models/s2st_transformer.py:164-179, ``aux_decode`` :566-619)."""

    def __init__(self, cfg: S2STConfig, vocab: int, dim: int, n_layers: int):
        super().__init__()
        self.cfg = cfg
        self.dim = dim
        self.embed_tokens = nn.Embedding(vocab, dim, padding_idx=PAD)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(dim, cfg.decoder_ffn_embed_dim,
                                    cfg.decoder_attention_heads,
                                    kv_dim=cfg.encoder_embed_dim,
                                    normalize_before=cfg.decoder_normalize_before,
                                    activation=cfg.activation_fn,
                                    **cfg.dropout_rates())
            for _ in range(n_layers))
        self.layer_norm = nn.LayerNorm(dim) \
            if cfg.decoder_normalize_before else None
        self.output_projection = nn.Linear(dim, vocab, bias=False)
        self.register_buffer(
            "pos_table", sinusoidal_table(AUX_MAX_POSITIONS + PAD + 1, dim,
                                          PAD), persistent=False)

    def forward(self, prev_tokens: torch.Tensor, enc_tap: torch.Tensor,
                enc_padding_mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prev_tokens (B, Tt) -> logits (B, Tt, V) in the compute dtype.
        The embedding is scaled by sqrt(dim); positions count non-pad
        tokens (fairseq's pad-aware positions); the output projection has
        no bias."""
        cfg = self.cfg
        x = self.embed_tokens.weight.to(cfg.dtype)[prev_tokens]
        if not cfg.no_scale_embedding:
            x = scaled(x, math.sqrt(self.dim))
        is_pad = prev_tokens == PAD
        pos_idx = torch.where(is_pad, PAD,
                              torch.cumsum((~is_pad).long(), dim=1) + PAD)
        x = x + self.pos_table[pos_idx].to(cfg.dtype)
        x = dropout(x, cfg.dropout, generator)
        for layer in self.layers:
            x, _ = layer(x, enc_tap, enc_padding_mask, is_pad,
                         generator=generator)
        if self.layer_norm is not None:
            x = layer_norm(x, self.layer_norm.weight, self.layer_norm.bias)
        return linear(x, self.output_projection.weight)


class S2STTransformer(nn.Module):
    def __init__(self, cfg: S2STConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = S2STEncoder(cfg)
        self.decoder = SpectrogramDecoder(cfg)
        self.aux_asr_decoder = AuxTextDecoder(
            cfg, cfg.src_vocab_size, cfg.asr_decoder_embed_dim,
            cfg.asr_decoder_layers) if cfg.aux_asr else None
        self.aux_st_decoder = AuxTextDecoder(
            cfg, cfg.tgt_vocab_size, cfg.st_decoder_embed_dim,
            cfg.st_decoder_layers) if cfg.aux_st else None

    def encode(self, src_feats, src_lengths, speaker=None) -> Dict[str, Any]:
        return self.encoder(src_feats, src_lengths, speaker)

    def decode(self, prev_output, tgt_lengths, encoder_out, speaker=None,
               generator=None) -> Dict[str, Any]:
        return self.decoder(prev_output, tgt_lengths, encoder_out, speaker,
                            generator)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None
                ) -> Dict[str, Any]:
        """Teacher-forced forward over a collated batch (:632-687): the
        spectrogram decoder's outputs, the encoder's padding mask and
        lengths, ``new_stats`` (with ``train``), and ``ctc_logits``,
        ``ctc_tgt_logits`` (the MTL target CTC over the first decoder tap,
        :668-671), ``asr_logits`` and ``st_logits`` where the config has
        those heads and the batch their inputs. A generator turns on the
        prenet's dropout, and with ``train`` every other dropout site and
        the encoder's LayerDrop, whose decisions the caller gives in
        ``layer_keep`` (``encoder_layer_keep``)."""
        cfg = self.cfg
        speaker = batch.get("speaker")
        drop = generator if train else None
        if drop is None:
            layer_keep = None
        enc = self.encoder(batch["src_speech"], batch["src_speech_lens"],
                           speaker, drop, layer_keep)
        dec = self.decoder(batch["prev_output_tokens"],
                           batch["target_lengths"], enc, speaker, generator,
                           train)
        out = dict(dec)
        dec_taps = out.pop("out_middle_layers_decoder")
        out["encoder_padding_mask"] = enc["encoder_padding_mask"]
        out["encoder_out_lengths"] = enc["out_lengths"]
        taps = enc["out_middle_layers"]
        pad = enc["encoder_padding_mask"]
        if cfg.ctc and taps:     # ctc_logits (:622) over tap 0
            proj = self.decoder.ctc_proj
            out["ctc_logits"] = linear(taps[0], proj.weight, proj.bias)
        if cfg.ctc_tgt and dec_taps:
            proj = self.decoder.ctc_proj_tgt
            out["ctc_tgt_logits"] = linear(dec_taps[0], proj.weight,
                                           proj.bias)
        if cfg.aux_asr and "prev_src_text_tokens" in batch:
            out["asr_logits"] = self.aux_asr_decoder(
                batch["prev_src_text_tokens"], taps[0], pad, drop)
        if cfg.aux_st and "prev_tgt_text_tokens" in batch:
            out["st_logits"] = self.aux_st_decoder(
                batch["prev_tgt_text_tokens"], taps[1 if len(taps) > 1 else 0],
                pad, drop)
        return out

    def load_stats(self, new_stats: Dict[str, Any]) -> None:
        """Write a training forward's running statistics into the
        buffers."""
        self.decoder.postnet.load_stats(new_stats["postnet"])

    def init_weights(self, seed: int) -> "S2STTransformer":
        """Seeded random init with the JAX package's distributions
        (models/s2st_transformer.py:149-257; ``seeded_init``)."""
        seeded_init(self, torch.Generator().manual_seed(seed), self.encoder,
                    self.decoder.postnet)
        with torch.no_grad():
            self.decoder.pos_emb_alpha.fill_(1.0)
        return self


@torch.no_grad()
def seeded_init(model: nn.Module, g: torch.Generator,
                encoder: Optional[S2STEncoder] = None,
                postnet: Optional[Postnet] = None) -> None:
    """Draw ``model``'s weights from ``g`` with the JAX package's
    distributions: torch-default uniform linears, xavier attention
    projections (gain 1/sqrt(2) for q/k/v), xavier convs (relu gain in the
    subsampler, tanh/linear gain in the postnet), normal(0, dim^-0.5)
    embeddings with a zero pad row and text output projections, then the
    HuBERT frontend's init."""
    def uniform(t, bound):
        t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)

    def xavier(w, fan_in, fan_out, gain):
        uniform(w, gain * math.sqrt(6.0 / (fan_in + fan_out)))

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            uniform(mod.weight, 1.0 / math.sqrt(mod.in_features))
            if mod.bias is not None:
                uniform(mod.bias, 1.0 / math.sqrt(mod.in_features))
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
            mod.reset_parameters()
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                             * mod.embedding_dim ** -0.5)
            if mod.padding_idx is not None:
                mod.weight[mod.padding_idx] = 0.0
    for mod in model.modules():
        if isinstance(mod, MultiheadAttention):
            for proj, gain in ((mod.q_proj, 2 ** -0.5),
                               (mod.k_proj, 2 ** -0.5),
                               (mod.v_proj, 2 ** -0.5),
                               (mod.out_proj, 1.0)):
                xavier(proj.weight, proj.in_features, proj.out_features,
                       gain)
        elif isinstance(mod, AuxTextDecoder):
            w = mod.output_projection.weight
            w.copy_(torch.randn(w.shape, generator=g) * w.shape[1] ** -0.5)
    convs = [(c, math.sqrt(2.0)) for c in encoder.subsample.conv_layers] \
        if encoder is not None else []
    if postnet is not None:
        post = postnet.convolutions
        convs += [(blk[0], 5.0 / 3.0 if i < len(post) - 1 else 1.0)
                  for i, blk in enumerate(post)]
    for conv, gain in convs:
        cout, cin, k = conv.weight.shape
        xavier(conv.weight, cin * k, cout * k, gain)
        uniform(conv.bias, 1.0 / math.sqrt(cin * k))
    if encoder is not None and encoder.hubert is not None:
        encoder.hubert.init_weights(g)


def from_jax_variables(cfg: S2STConfig, variables: Dict[str, Any]
                       ) -> S2STTransformer:
    """A model of ``cfg`` holding a JAX ``{"params", "stats"}`` tree of
    numpy arrays (strict both ways); a HuBERT frontend first takes the
    pretraining leaves the tree carries (``HubertModel.carry_pretraining``)."""
    model = S2STTransformer(cfg)
    if model.encoder.hubert is not None:
        model.encoder.hubert.carry_pretraining(hub.pretraining_shapes(
            variables["params"].get("hubert", {})))
    return load_jax_variables(model, variables)


def encoder_layer_keep(cfg: S2STConfig, generator: torch.Generator
                       ) -> Optional[List[bool]]:
    """LayerDrop's decisions for one microbatch: layer i is kept when a
    uniform draw is at least ``encoder_layerdrop`` (never at 1.0, always at
    0.0); None when LayerDrop is off."""
    if getattr(cfg, "encoder_layerdrop", 0.0) <= 0.0:
        return None
    draws = torch.rand(cfg.encoder_layers, generator=generator,
                       device=generator.device)
    return (draws >= cfg.encoder_layerdrop).tolist()


def cast_for_inference(model: S2STTransformer, dtype) -> S2STTransformer:
    """Cast matmul and conv weights to the compute dtype once; norm
    parameters, running stats and position tables stay fp32 (as the JAX
    decode loop pre-casts, generate/speech_generator.py:66-77). The HuBERT
    frontend keeps its fp32 weights: JAX computes it in fp32 past its
    GroupNorm (``models/hubert.py``)."""
    hubert = getattr(model.encoder, "hubert", None)
    frontend = set(hubert.modules()) if hubert is not None else set()
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Embedding)) \
                and mod not in frontend:
            mod.to(dtype)
    return model


def subsampled_length(cfg: S2STConfig, length: int) -> int:
    for _ in cfg.conv_kernel_sizes:
        length = (length - 1) // 2 + 1
    return length
