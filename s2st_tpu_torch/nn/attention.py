"""Multi-head attention with fairseq parameter names and a preallocated KV
cache for step-by-step decoding.

Counterpart of ``s2st_tpu/nn/attention.py``. Heads are (B, T, H, D). Every
full-sequence call that needs neither the weights nor an additive mask other
than the causal one, has no attention-probability dropout active and has a
head_dim the kernels take (``kernels.attention.takes_head_dim``: a multiple
of 8 up to 128) goes to ``kernels.attention.flash_attention`` (the gate of
``mha``, :137-140); the rest, and the one-query decode steps, use ``attend``
(plain PyTorch, as JAX leaves them to XLA).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.attention import NEG_INF, flash_attention, takes_head_dim
from .core import dropout, linear, scaled


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.view(b, t, num_heads, c // num_heads)


def causal_mask(t: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(T, T) additive mask, NEG_INF strictly above the diagonal."""
    return torch.triu(torch.full((t, t), NEG_INF, dtype=dtype, device=device),
                      diagonal=1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           key_padding_mask: Optional[torch.Tensor] = None,
           attn_mask: Optional[torch.Tensor] = None,
           dropout_rate: float = 0.0,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled dot-product attention (nn/attention.py:91). q (B, Tq, H, D)
    pre-scaled; k, v (B, Tk, H, D); key_padding_mask (B, Tk) True at pad,
    whose scores are REPLACED by NEG_INF; attn_mask (Tq, Tk) ADDED.
    Dropout (with a generator) drops fp32 probabilities before the value
    product. Returns (out (B, Tq, H, D), weights fp32 (B, H, Tq, Tk), the
    probabilities before dropout)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                    NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    probs = dropout(weights, dropout_rate, generator)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out, weights


class MultiheadAttention(nn.Module):
    """fairseq MultiheadAttention parameters: q_proj, k_proj, v_proj,
    out_proj, all with bias; kdim/vdim for cross-attention."""

    def __init__(self, embed_dim: int, num_heads: int,
                 kdim: Optional[int] = None, vdim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(kdim or embed_dim, embed_dim)
        self.v_proj = nn.Linear(vdim or embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                causal: bool = False, need_weights: bool = False,
                dropout_rate: float = 0.0,
                generator: Optional[torch.Generator] = None):
        """Full-sequence attention (nn/attention.py:115). (B, T, C) in and
        out; q is scaled after its projection bias. Probability dropout at
        ``dropout_rate`` is active when a generator is given, and then the
        call takes ``attend``, as does a head_dim the kernels do not take
        (4 for a 64-d aux decoder with 16 heads, 256 for a 512-d encoder
        with 2). Returns (out, weights (B, H, Tq, Tk) fp32 or
        None)."""
        b, tq, c = query.shape
        q = split_heads(scaled(linear(query, self.q_proj.weight,
                                      self.q_proj.bias), self.scale),
                        self.num_heads)
        k = split_heads(linear(key, self.k_proj.weight, self.k_proj.bias),
                        self.num_heads)
        v = split_heads(linear(value, self.v_proj.weight, self.v_proj.bias),
                        self.num_heads)
        w = None
        prob_dropout = generator is not None and dropout_rate > 0.0
        if not need_weights and attn_mask is None and not prob_dropout \
                and takes_head_dim(self.head_dim):
            out = flash_attention(q, k, v, key_padding_mask, causal=causal)
        else:
            if causal and attn_mask is None:
                attn_mask = causal_mask(tq, query.device)
            out, w = attend(q, k, v, key_padding_mask, attn_mask,
                            dropout_rate, generator)
        out = linear(out.reshape(b, tq, c), self.out_proj.weight,
                     self.out_proj.bias)
        return out, (w if need_weights else None)


def self_attn_cache_init(batch: int, max_len: int, num_heads: int,
                         head_dim: int, dtype, device) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, max_len, num_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, num_heads, head_dim), dtype=dtype,
                         device=device),
    }


def cross_attn_precompute(attn: MultiheadAttention, enc_out: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
    """Project the encoder K/V once per utterance (nn/attention.py:234)."""
    return {
        "k": split_heads(linear(enc_out, attn.k_proj.weight, attn.k_proj.bias),
                         attn.num_heads),
        "v": split_heads(linear(enc_out, attn.v_proj.weight, attn.v_proj.bias),
                         attn.num_heads),
    }
