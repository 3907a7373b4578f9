"""Transformer encoder/decoder layers and sinusoidal positions.

Counterpart of ``s2st_tpu/nn/transformer.py``, with fairseq parameter
names (``self_attn``, ``self_attn_layer_norm``, ``encoder_attn``,
``encoder_attn_layer_norm``, ``fc1``, ``fc2``, ``final_layer_norm``).
Activations are (B, T, C). Dropout runs at JAX's sites and rates
(``encoder_layer`` :79-109, ``decoder_layer`` :130-188) when a
``torch.Generator`` is given, and not at all without one (inference).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from .attention import MultiheadAttention, attend, split_heads
from .core import dropout, get_activation, layer_norm, linear, scaled


def sinusoidal_table(num_positions: int, dim: int, padding_idx: int = 1
                     ) -> torch.Tensor:
    """fairseq SinusoidalPositionalEmbedding table (nn/transformer.py:31):
    row p is [sin(p f) | cos(p f)], f_i = exp(-i log(1e4) / max(half-1, 1));
    the padding_idx row is zero."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32)
                     * -(math.log(10000.0) / max(half - 1, 1)))
    pos = torch.arange(num_positions, dtype=torch.float32)[:, None] \
        * freq[None, :]
    table = torch.cat([torch.sin(pos), torch.cos(pos)], dim=1)
    if dim % 2 == 1:
        table = torch.cat([table, torch.zeros(num_positions, 1)], dim=1)
    table[padding_idx] = 0.0
    return table


def positions_for_lengths(table: torch.Tensor, lengths: torch.Tensor,
                          max_len: int, padding_idx: int = 1,
                          dtype=torch.float32) -> torch.Tensor:
    """(B, T, C) positional embeddings; pad positions take the zero row."""
    t = torch.arange(max_len, device=lengths.device)
    valid = t[None, :] < lengths[:, None]
    idx = torch.where(valid, t[None, :] + padding_idx + 1,
                      torch.full_like(valid, padding_idx, dtype=torch.long))
    return table[idx].to(dtype)


def position_at_step(table: torch.Tensor, step: int, padding_idx: int = 1,
                     dtype=torch.float32) -> torch.Tensor:
    """(C,) positional embedding at decode step ``step`` (0-based)."""
    return table[step + padding_idx + 1].to(dtype)


class _Sublayers(nn.Module):
    """normalize_before puts each sublayer's layer norm on its input
    (pre-LN) or on the residual sum (post-LN). Dropout rates: ``dropout_rate``
    after each sublayer, ``attention_dropout`` on the attention
    probabilities, ``activation_dropout`` after the FFN activation."""

    def _set_dropout(self, dropout_rate: float, attention_dropout: float,
                     activation_dropout: float):
        self.dropout_rate = dropout_rate
        self.attention_dropout = attention_dropout
        self.activation_dropout = activation_dropout

    def _norm(self, ln: nn.LayerNorm, x: torch.Tensor, before: bool):
        return layer_norm(x, ln.weight, ln.bias) \
            if self.normalize_before == before else x

    def _attn(self, attn, ln, x, memory, generator, **kw):
        """Residual attention sublayer; returns (x, weights or None)."""
        h = self._norm(ln, x, True)
        mem = h if memory is None else memory
        h, w = attn(h, mem, mem, dropout_rate=self.attention_dropout,
                    generator=generator, **kw)
        h = dropout(h, self.dropout_rate, generator)
        return self._norm(ln, x + h, False), w

    def _ffn(self, x: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        act = get_activation(self.activation)
        h = self._norm(self.final_layer_norm, x, True)
        h = act(linear(h, self.fc1.weight, self.fc1.bias))
        h = dropout(h, self.activation_dropout, generator)
        h = linear(h, self.fc2.weight, self.fc2.bias)
        h = dropout(h, self.dropout_rate, generator)
        return self._norm(self.final_layer_norm, x + h, False)


class TransformerEncoderLayer(_Sublayers):
    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 normalize_before: bool = True, activation: str = "relu",
                 dropout_rate: float = 0.0, attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0):
        super().__init__()
        self.normalize_before = normalize_before
        self.activation = activation
        self._set_dropout(dropout_rate, attention_dropout, activation_dropout)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """nn/transformer.py:79; dropout only with a generator."""
        x, _ = self._attn(self.self_attn, self.self_attn_layer_norm, x, None,
                          generator, key_padding_mask=padding_mask)
        return self._ffn(x, generator)


class TransformerDecoderLayer(_Sublayers):
    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 kv_dim: Optional[int] = None, normalize_before: bool = False,
                 activation: str = "relu", dropout_rate: float = 0.0,
                 attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0):
        super().__init__()
        self.normalize_before = normalize_before
        self.activation = activation
        self._set_dropout(dropout_rate, attention_dropout, activation_dropout)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(dim)
        self.encoder_attn = MultiheadAttention(dim, num_heads, kdim=kv_dim,
                                               vdim=kv_dim)
        self.encoder_attn_layer_norm = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, enc_out: Optional[torch.Tensor],
                enc_padding_mask: Optional[torch.Tensor],
                self_attn_padding_mask: Optional[torch.Tensor],
                need_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced layer with causal self-attention
        (nn/transformer.py:130); dropout only with a generator. Returns
        (x, cross-attention weights fp32 (B, H, Tq, Tk) when need_attn else
        None)."""
        x, _ = self._attn(self.self_attn, self.self_attn_layer_norm, x, None,
                          generator, key_padding_mask=self_attn_padding_mask,
                          causal=True)
        attn_w = None
        if enc_out is not None:
            x, attn_w = self._attn(self.encoder_attn,
                                   self.encoder_attn_layer_norm, x, enc_out,
                                   generator,
                                   key_padding_mask=enc_padding_mask,
                                   need_weights=need_attn)
        return self._ffn(x, generator), attn_w


def fuse_decoder_layer_params(layer: TransformerDecoderLayer
                              ) -> Dict[str, torch.Tensor]:
    """One decoder layer's tensors for the fused decode step: the
    self-attention q/k/v projections become one (3C, C) matmul
    (nn/transformer.py:228). Done once per generate call."""
    sa, ca = layer.self_attn, layer.encoder_attn
    return {
        "qkv_w": torch.cat([sa.q_proj.weight, sa.k_proj.weight,
                            sa.v_proj.weight], dim=0),
        "qkv_b": torch.cat([sa.q_proj.bias, sa.k_proj.bias, sa.v_proj.bias]),
        "self_out_w": sa.out_proj.weight, "self_out_b": sa.out_proj.bias,
        "cross_q_w": ca.q_proj.weight, "cross_q_b": ca.q_proj.bias,
        "cross_out_w": ca.out_proj.weight, "cross_out_b": ca.out_proj.bias,
        "fc1_w": layer.fc1.weight, "fc1_b": layer.fc1.bias,
        "fc2_w": layer.fc2.weight, "fc2_b": layer.fc2.bias,
        "self_ln_w": layer.self_attn_layer_norm.weight,
        "self_ln_b": layer.self_attn_layer_norm.bias,
        "cross_ln_w": layer.encoder_attn_layer_norm.weight,
        "cross_ln_b": layer.encoder_attn_layer_norm.bias,
        "final_ln_w": layer.final_layer_norm.weight,
        "final_ln_b": layer.final_layer_norm.bias,
    }


def decoder_layer_step_fused(lp: Dict[str, torch.Tensor], x_step: torch.Tensor,
                             cache: Dict[str, torch.Tensor], step: int,
                             cross_kv: Dict[str, torch.Tensor],
                             enc_padding_mask: Optional[torch.Tensor],
                             num_heads: int, *, normalize_before: bool = False,
                             activation: str = "relu", need_attn: bool = False):
    """One-token decode step (nn/transformer.py:263). x_step (B, 1, C);
    cache {"k", "v"} (B, Tmax, H, D) is written IN PLACE at ``step`` (JAX
    returns a new cache; here the buffer is reused to save a copy a step);
    cache positions after ``step`` are masked. Returns (x_step, cache,
    cross-attention weights (B, H, 1, Tk) fp32 or None)."""
    act = get_activation(activation)
    b, _, c = x_step.shape
    scale = (c // num_heads) ** -0.5
    max_len = cache["k"].shape[1]
    invalid = (torch.arange(max_len, device=x_step.device) > step
               )[None, :].expand(b, max_len)

    def norm(name, x, before):
        if normalize_before != before:
            return x
        return layer_norm(x, lp[name + "_w"], lp[name + "_b"])

    residual = x_step
    h = norm("self_ln", x_step, True)
    q, k_new, v_new = linear(h, lp["qkv_w"], lp["qkv_b"]).chunk(3, dim=-1)
    q = split_heads(scaled(q, scale), num_heads)
    cache["k"][:, step] = split_heads(k_new, num_heads)[:, 0].to(
        cache["k"].dtype)
    cache["v"][:, step] = split_heads(v_new, num_heads)[:, 0].to(
        cache["v"].dtype)
    out, _ = attend(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                    key_padding_mask=invalid)
    x = residual + linear(out.reshape(b, 1, c), lp["self_out_w"],
                          lp["self_out_b"])
    x = norm("self_ln", x, False)

    residual = x
    h = norm("cross_ln", x, True)
    q = split_heads(
        scaled(linear(h, lp["cross_q_w"], lp["cross_q_b"]), scale), num_heads)
    out, w = attend(q, cross_kv["k"], cross_kv["v"],
                    key_padding_mask=enc_padding_mask)
    x = residual + linear(out.reshape(b, 1, c), lp["cross_out_w"],
                          lp["cross_out_b"])
    x = norm("cross_ln", x, False)

    residual = x
    h = norm("final_ln", x, True)
    x = residual + linear(act(linear(h, lp["fc1_w"], lp["fc1_b"])),
                          lp["fc2_w"], lp["fc2_b"])
    x = norm("final_ln", x, False)
    return x, cache, (w if need_attn else None)
