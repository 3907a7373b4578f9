"""LightConv / DynamicConv translation models (Wu et al. 2019) for serving.

Counterpart of ``s2st_tpu/models/lightconv_model.py`` (:35-290, :293-378):
``encode``, the teacher-forced ``decode``, ``forward`` and the incremental
beam step with its cache. Encoder layers replace self-attention with a
(GLU-gated) lightweight or dynamic convolution over the pad-zeroed input,
with symmetric padding K // 2; decoder layers run the causal convolution
(padding K - 1) and then attend to the encoder. The two full-sequence
convolutions go through ``kernels.conv`` (the hand-written kernels on a CUDA
tensor); the incremental step holds the last K conv inputs of each layer and
takes its conv as one weighted sum over them, as JAX does. Cross-attention
is the plain ``attend``, as JAX's ``mha`` without ``use_flash`` is; the step
projects the encoder's keys and values once per batch, which is the same
arithmetic as JAX's projection at every step. Inference only: dropout and
LightConv training are not ported.

Parameters keep fairseq's ``LightConv*Layer`` names (``linear1``, ``conv``,
``linear2``, ``fc1``, ``fc2``, ``layer_norms.0/1`` in the encoder;
``conv_layer_norm``, ``encoder_attn``, ``encoder_attn_layer_norm``,
``final_layer_norm`` in the decoder; ``decoder.embed_out``);
``models/jax_bridge.py`` maps them to the JAX tree.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.conv import dynamicconv, lightconv
from ..nn.attention import (MultiheadAttention, attend, cross_attn_precompute,
                            split_heads)
from ..nn.core import glu, layer_norm, linear, scaled
from ..nn.transformer import sinusoidal_table
from .transformer_text import TransformerTextConfig

PAD, EOS = 1, 2


@dataclass(frozen=True)
class LightConvConfig:
    base: TransformerTextConfig = dataclasses.field(
        default_factory=TransformerTextConfig)
    conv_type: str = "lightweight"          # "lightweight" | "dynamic"
    encoder_kernel_sizes: Tuple[int, ...] = (3, 7, 15, 31, 31, 31, 31)
    decoder_kernel_sizes: Tuple[int, ...] = (3, 7, 15, 31, 31, 31)
    encoder_conv_dim: int = 512
    decoder_conv_dim: int = 512
    encoder_glu: bool = True
    decoder_glu: bool = True
    weight_softmax: bool = True
    weight_dropout: float = 0.1
    input_dropout: float = 0.1
    relu_dropout: float = 0.0

    def replace(self, **kw) -> "LightConvConfig":
        return dataclasses.replace(self, **kw)


class LightweightConv(nn.Module):
    """fairseq LightweightConv1dTBC's parameter: ``weight`` (H, 1, K), raw;
    JAX keeps it as ``conv_weight`` (H, K)."""

    jax_names = {"weight": ("conv_weight", "heads_k")}

    def __init__(self, heads: int, kernel_size: int):
        super().__init__()
        self.heads = heads
        self.weight = nn.Parameter(torch.empty(heads, 1, kernel_size))

    def forward(self, x: torch.Tensor, padding_l: int) -> torch.Tensor:
        return lightconv(x, self.weight[:, 0, :], padding_l, self.heads)

    def step(self, buf: torch.Tensor) -> torch.Tensor:
        """Output at the newest position from the last K inputs (N, K, C):
        sum_k softmax(w)[h(c), k] buf[n, k, c] (lightconv_model.py:323-327)."""
        w = torch.softmax(self.weight[:, 0, :].float(), dim=-1)
        w_c = w.repeat_interleave(buf.shape[-1] // self.heads, dim=0)
        return torch.einsum("nkc,ck->nc", buf.float(), w_c).to(buf.dtype)


class DynamicConv(nn.Module):
    """fairseq DynamicConv1dTBC's parameter: ``weight_linear`` (H*K, C), no
    bias, which predicts each position's (H, K) weights from the input."""

    def __init__(self, dim: int, heads: int, kernel_size: int):
        super().__init__()
        self.heads, self.kernel_size = heads, kernel_size
        self.weight_linear = nn.Linear(dim, heads * kernel_size, bias=False)

    def forward(self, x: torch.Tensor, padding_l: int) -> torch.Tensor:
        b, t, _ = x.shape
        logits = linear(x, self.weight_linear.weight).view(
            b, t, self.heads, self.kernel_size)
        return dynamicconv(x, logits, padding_l, self.heads)

    def step(self, buf: torch.Tensor) -> torch.Tensor:
        """Output at the newest position (lightconv_model.py:328-335): the
        weights come from the newest input, softmaxed in fp32."""
        n, k, c = buf.shape
        logits = linear(buf[:, -1], self.weight_linear.weight).view(
            n, self.heads, k)
        w = torch.softmax(logits.float(), dim=-1)
        w_c = w.repeat_interleave(c // self.heads, dim=1)      # (N, C, K)
        return torch.einsum("nkc,nck->nc", buf.float(), w_c).to(buf.dtype)


def _make_conv(cfg: LightConvConfig, dim: int, heads: int, k: int):
    if cfg.conv_type == "lightweight":
        return LightweightConv(heads, k)
    if cfg.conv_type == "dynamic":
        return DynamicConv(dim, heads, k)
    raise ValueError(f"unknown conv type {cfg.conv_type!r}")


def _ln(mod: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, mod.weight, mod.bias)


def _lin(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return linear(x, mod.weight, mod.bias)


def _cross_attention(attn: MultiheadAttention, x: torch.Tensor,
                     kv: Dict[str, torch.Tensor],
                     key_padding_mask: torch.Tensor) -> torch.Tensor:
    """JAX ``mha`` with precomputed keys and values (the plain path)."""
    b, tq, c = x.shape
    q = split_heads(scaled(_lin(attn.q_proj, x), attn.scale),
                    attn.num_heads)
    out, _ = attend(q, kv["k"], kv["v"], key_padding_mask)
    return _lin(attn.out_proj, out.reshape(b, tq, c))


class _ConvBlock(nn.Module):
    """What both layers do before their conv: linear1, then GLU if on."""

    def _conv_in(self, x: torch.Tensor) -> torch.Tensor:
        h = _lin(self.linear1, x)
        return glu(h) if self.glu else h


class LightConvEncoderLayer(_ConvBlock):
    def __init__(self, cfg: LightConvConfig, k: int):
        super().__init__()
        b = cfg.base
        d, conv_dim = b.encoder_embed_dim, cfg.encoder_conv_dim
        if k % 2 == 0:
            raise NotImplementedError("even conv kernels (asymmetric "
                                      "padding)")
        self.kernel_size = k
        self.glu = cfg.encoder_glu
        self.normalize_before = b.encoder_normalize_before
        self.linear1 = nn.Linear(d, conv_dim * (2 if self.glu else 1))
        self.conv = _make_conv(cfg, conv_dim, b.encoder_attention_heads, k)
        self.linear2 = nn.Linear(conv_dim, d)
        self.fc1 = nn.Linear(d, b.encoder_ffn_embed_dim)
        self.fc2 = nn.Linear(b.encoder_ffn_embed_dim, d)
        self.layer_norms = nn.ModuleList([nn.LayerNorm(d), nn.LayerNorm(d)])

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor
                ) -> torch.Tensor:
        nb = self.normalize_before
        conv_ln, final_ln = self.layer_norms
        residual = x
        h = self._conv_in(_ln(conv_ln, x) if nb else x)
        h = h.masked_fill(pad_mask[:, :, None], 0.0)
        h = self.conv(h, self.kernel_size // 2)
        x = residual + _lin(self.linear2, h)
        if not nb:
            x = _ln(conv_ln, x)
        residual = x
        h = _ln(final_ln, x) if nb else x
        x = residual + _lin(self.fc2, F.relu(_lin(self.fc1, h)))
        return x if nb else _ln(final_ln, x)


class LightConvDecoderLayer(_ConvBlock):
    def __init__(self, cfg: LightConvConfig, k: int):
        super().__init__()
        b = cfg.base
        d, conv_dim = b.decoder_embed_dim, cfg.decoder_conv_dim
        self.kernel_size = k
        self.glu = cfg.decoder_glu
        self.normalize_before = b.decoder_normalize_before
        self.linear1 = nn.Linear(d, conv_dim * (2 if self.glu else 1))
        self.conv = _make_conv(cfg, conv_dim, b.decoder_attention_heads, k)
        self.linear2 = nn.Linear(conv_dim, d)
        self.conv_layer_norm = nn.LayerNorm(d)
        self.encoder_attn = MultiheadAttention(
            d, b.decoder_attention_heads, kdim=b.encoder_embed_dim,
            vdim=b.encoder_embed_dim)
        self.encoder_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, b.decoder_ffn_embed_dim)
        self.fc2 = nn.Linear(b.decoder_ffn_embed_dim, d)
        self.final_layer_norm = nn.LayerNorm(d)

    def forward(self, x: torch.Tensor, kv: Dict[str, torch.Tensor],
                enc_pad: torch.Tensor, conv: Callable) -> torch.Tensor:
        """``conv`` maps the conv input to its output: the causal kernel
        over the whole sequence, or the incremental step."""
        nb = self.normalize_before
        residual = x
        h = self._conv_in(_ln(self.conv_layer_norm, x) if nb else x)
        x = residual + _lin(self.linear2, conv(h))
        if not nb:
            x = _ln(self.conv_layer_norm, x)
        residual = x
        h = _ln(self.encoder_attn_layer_norm, x) if nb else x
        x = residual + _cross_attention(self.encoder_attn, h, kv, enc_pad)
        if not nb:
            x = _ln(self.encoder_attn_layer_norm, x)
        residual = x
        h = _ln(self.final_layer_norm, x) if nb else x
        x = residual + _lin(self.fc2, F.relu(_lin(self.fc1, h)))
        return x if nb else _ln(self.final_layer_norm, x)


def _embed_positions(table: torch.Tensor, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """Sinusoidal rows for left- or right-padded tokens: row PAD (zero) at
    pad, row PAD + n at the n-th real token."""
    is_pad = tokens == PAD
    cum = torch.cumsum((~is_pad).long(), dim=1)
    return table[torch.where(is_pad, torch.full_like(cum, PAD), cum + PAD)]


class LightConvEncoder(nn.Module):
    def __init__(self, cfg: LightConvConfig):
        super().__init__()
        b = cfg.base
        self.embed_tokens = nn.Embedding(b.src_vocab_size,
                                         b.encoder_embed_dim)
        self.layers = nn.ModuleList(LightConvEncoderLayer(cfg, k)
                                    for k in cfg.encoder_kernel_sizes)
        self.layer_norm = nn.LayerNorm(b.encoder_embed_dim) \
            if b.encoder_normalize_before else None
        self.register_buffer("positions", sinusoidal_table(
            b.max_source_positions + PAD + 1, b.encoder_embed_dim, PAD),
            persistent=False)


class LightConvDecoder(nn.Module):
    # the output projection is JAX's decoder.out_proj.w, (D, V)
    jax_names = {"embed_out": ("out_proj::w", "linear")}

    def __init__(self, cfg: LightConvConfig):
        super().__init__()
        b = cfg.base
        self.embed_tokens = None if b.share_all_embeddings else \
            nn.Embedding(b.tgt_vocab_size, b.decoder_embed_dim)
        self.layers = nn.ModuleList(LightConvDecoderLayer(cfg, k)
                                    for k in cfg.decoder_kernel_sizes)
        self.layer_norm = nn.LayerNorm(b.decoder_embed_dim) \
            if b.decoder_normalize_before else None
        self.embed_out = None if b.tied_output else nn.Parameter(
            torch.empty(b.tgt_vocab_size, b.decoder_embed_dim))
        # rows for every teacher-forced position and every beam step
        self.register_buffer("positions", sinusoidal_table(
            b.max_target_positions + PAD + 8, b.decoder_embed_dim, PAD),
            persistent=False)


class LightConvModel(nn.Module):
    def __init__(self, cfg: LightConvConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = LightConvEncoder(cfg)
        self.decoder = LightConvDecoder(cfg)

    # -- weights shared across the two sides ---------------------------------
    def _decoder_embed(self) -> torch.Tensor:
        mod = self.decoder.embed_tokens
        return (self.encoder.embed_tokens if mod is None else mod).weight

    def _output_weight(self) -> torch.Tensor:
        """(V, D): embed_out, or the decoder embedding when tied."""
        if self.decoder.embed_out is not None:
            return self.decoder.embed_out
        return self._decoder_embed()

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of the compute-type features and output weights."""
        w = self._output_weight().to(x.dtype)
        return F.linear(x.float(), w.float())

    def _embed(self, weight: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
        dt = self.cfg.base.dtype
        return scaled(F.embedding(tokens, weight.to(dt)),
                      weight.shape[1] ** 0.5)

    # -- full sequences ------------------------------------------------------
    def encode(self, src_tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        """src_tokens (B, Ts), left-padded -> encoder_out (B, Ts, D) and
        encoder_padding_mask (B, Ts), True at pad."""
        enc = self.encoder
        x = self._embed(enc.embed_tokens.weight, src_tokens)
        x = x + _embed_positions(enc.positions, src_tokens).to(x.dtype)
        is_pad = src_tokens == PAD
        for layer in enc.layers:
            x = layer(x, is_pad)
        if enc.layer_norm is not None:
            x = _ln(enc.layer_norm, x)
        return {"encoder_out": x, "encoder_padding_mask": is_pad}

    def _cross_kvs(self, enc_out: torch.Tensor):
        return [cross_attn_precompute(layer.encoder_attn, enc_out)
                for layer in self.decoder.layers]

    def decode(self, prev_output_tokens: torch.Tensor, enc_out: torch.Tensor,
               enc_pad: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder: (B, Tt) -> fp32 logits (B, Tt, V)."""
        dec = self.decoder
        x = self._embed(self._decoder_embed(), prev_output_tokens)
        x = x + _embed_positions(dec.positions,
                                 prev_output_tokens).to(x.dtype)
        for layer, kv in zip(dec.layers, self._cross_kvs(enc_out)):
            k = layer.kernel_size
            x = layer(x, kv, enc_pad,
                      lambda h, layer=layer, k=k: layer.conv(h, k - 1))
        if dec.layer_norm is not None:
            x = _ln(dec.layer_norm, x)
        return self._logits(x)

    def forward(self, src_tokens: torch.Tensor,
                prev_output_tokens: torch.Tensor) -> torch.Tensor:
        enc = self.encode(src_tokens)
        return self.decode(prev_output_tokens, enc["encoder_out"],
                           enc["encoder_padding_mask"])

    # -- incremental decoding ------------------------------------------------
    def init_beam_cache(self, n: int, device=None) -> Dict[str, torch.Tensor]:
        """Per layer, the last K conv inputs of each of n hypotheses."""
        cfg = self.cfg
        return {f"conv{i}": torch.zeros((n, k, cfg.decoder_conv_dim),
                                        dtype=cfg.base.dtype, device=device)
                for i, k in enumerate(cfg.decoder_kernel_sizes)}

    def make_beam_step(self, enc_out: torch.Tensor, enc_pad: torch.Tensor):
        """step(tokens (N, 1), step, cache) -> (log-probs fp32 (N, V), new
        cache), over encoder states already repeated to N rows."""
        dec = self.decoder
        kvs = self._cross_kvs(enc_out)
        embed = self._decoder_embed()

        def step_fn(tokens_t: torch.Tensor, step: int,
                    cache: Dict[str, torch.Tensor]):
            x = self._embed(embed, tokens_t)
            x = x + dec.positions[step + PAD + 1].to(x.dtype)
            new_cache = {}
            for i, (layer, kv) in enumerate(zip(dec.layers, kvs)):
                def conv(h, i=i, layer=layer):
                    buf = torch.cat([cache[f"conv{i}"][:, 1:], h], dim=1)
                    new_cache[f"conv{i}"] = buf
                    return layer.conv.step(buf)[:, None, :]
                x = layer(x, kv, enc_pad, conv)
            if dec.layer_norm is not None:
                x = _ln(dec.layer_norm, x)
            return torch.log_softmax(self._logits(x[:, 0]), dim=-1), \
                new_cache

        return step_fn

    # -- weights -------------------------------------------------------------
    @torch.no_grad()
    def init_weights(self, seed: int) -> "LightConvModel":
        """Seeded random init with the JAX package's distributions
        (lightconv_model.py:58-131): xavier-uniform linears with zero bias,
        xavier-uniform (H, K) conv weights, xavier attention projections
        (gain 1/sqrt(2) for q/k/v), normal(0, D^-0.5) embeddings with a zero
        pad row and output projection, unit layer norms."""
        g = torch.Generator().manual_seed(seed)

        def xavier(t, fan_in, fan_out, gain=1.0):
            bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
            t.copy_(torch.rand(t.shape, generator=g) * (2 * bound) - bound)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                xavier(mod.weight, mod.in_features, mod.out_features)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.reset_parameters()
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                                 * mod.embedding_dim ** -0.5)
                mod.weight[PAD] = 0.0
            elif isinstance(mod, LightweightConv):
                h, _, k = mod.weight.shape
                xavier(mod.weight, h, k)
            elif isinstance(mod, MultiheadAttention):
                for proj in (mod.q_proj, mod.k_proj, mod.v_proj):
                    xavier(proj.weight, proj.in_features, proj.out_features,
                           2 ** -0.5)
        if self.decoder.embed_out is not None:
            w = self.decoder.embed_out
            w.copy_(torch.randn(w.shape, generator=g) * w.shape[1] ** -0.5)
        return self


def cast_for_inference(model: LightConvModel, dtype) -> LightConvModel:
    """Cast matmul and embedding weights (and embed_out) to the compute
    type once; layer norms and the (H, K) conv weights stay fp32, as the
    JAX functions read them."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            mod.to(dtype)
    if model.decoder.embed_out is not None:
        model.decoder.embed_out.data = model.decoder.embed_out.data.to(dtype)
    return model
