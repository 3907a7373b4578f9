"""Fused attention forward and backward: the Hopper kernels and their plain
PyTorch version.

``flash_attention`` replaces the Pallas TPU kernel behind
``s2st_tpu/nn/attention.py::attend_flash`` (:44-88) and its ``custom_vjp``
backward. On a CUDA tensor it launches ``csrc/flash_attention.cu``, and its
gradient launches ``csrc/flash_attention_bwd.cu`` (each built for ``sm_90a``
on first use and loaded with ctypes); on a CPU tensor it runs
``flash_attention_reference``, whose gradient is plain autograd. There is no
other path: a CUDA call the kernels cannot take raises.

Each kernel has two designs, chosen by the input type (``DESIGNS``): bf16
runs on the tensor cores (mma.sync), fp32 on the CUDA cores' fp32 FMAs
from register tiles, which keep fp32 exact to its rounding. Every kernel
streams its tiles with 16-byte cp.async, so every (b, t, h) row of q, k,
v, o and dO must start 16-byte aligned, in either type: ``misalignment``
says why a tensor does not, and the wrapper raises on it.

Semantics (those of ``s2st_tpu/nn/attention.py::attend``): q is pre-scaled;
a causal mask of -1e9 is added strictly above the diagonal; key padding
replaces the score with -1e9, so a row with no valid key averages every
value and a padded key's score gets no gradient; softmax and accumulation
run in fp32 and the outputs have the input type.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import nvcc

NEG_INF = -1e9

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_ROW_ALIGN = 16     # bytes: one cp.async of the kernels
DESIGNS = {"bfloat16": "tensor cores (mma.sync m16n8k16, cp.async ring)",
           "float32": "CUDA-core fp32 FMAs from register tiles, cp.async "
                      "ring, head_dim 16/64/128 compiled in; forward in 64- "
                      "or 32-query blocks; backward in two launches (dQ "
                      "with D, then dK/dV), no atomics"}


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              key_padding_mask: Optional[torch.Tensor] = None,
                              causal: bool = False) -> torch.Tensor:
    """Plain version: einsum + masked fp32 softmax. q (B, Tq, H, D)
    pre-scaled, k/v (B, Tk, H, D), key_padding_mask (B, Tk) True at pad.
    Returns (B, Tq, H, D) in v's dtype. Its autograd is the plain version
    of the backward kernel."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if causal:
        tq, tk = logits.shape[-2:]
        logits = logits + torch.triu(
            torch.full((tq, tk), NEG_INF, device=q.device), diagonal=1)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                    NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


def misalignment(t: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot copy the (b, t, h) rows of a (B, T, H, D)
    tensor with 16-byte cp.async, or None: the data pointer, and the batch,
    time and head strides of every dimension longer than 1, must be
    multiples of 16 bytes."""
    if t.data_ptr() % _ROW_ALIGN:
        return f"data pointer {t.data_ptr():#x} is not {_ROW_ALIGN}-byte " \
               f"aligned"
    for name, n, stride in zip(("batch", "time", "head"), t.shape[:3],
                               t.stride()[:3]):
        if n > 1 and (stride * t.element_size()) % _ROW_ALIGN:
            return f"its {name} stride of {stride} elements is not a " \
                   f"multiple of {_ROW_ALIGN} bytes"
    return None


def _check_aligned(**tensors):
    for name, t in tensors.items():
        why = misalignment(t)
        if why:
            raise ValueError(f"{name} cannot be read by the kernels' "
                             f"{_ROW_ALIGN}-byte copies: {why}")


def takes_head_dim(d: int) -> bool:
    """The kernels' head_dim contract: a multiple of 8 up to
    ``_MAX_HEAD_DIM``. ``_check`` raises outside it, and
    ``nn.attention.MultiheadAttention`` routes other head dims to the plain
    ``attend``, as JAX's ``mha`` takes its plain path without
    ``use_flash_attention``."""
    return d % 8 == 0 and d <= _MAX_HEAD_DIM


def _check(q, k, v, key_padding_mask):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got "
                             f"{t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, T, H, D), got {t.shape}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride over head_dim")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not takes_head_dim(d):
        raise ValueError(f"head_dim must be a multiple of 8 up to "
                         f"{_MAX_HEAD_DIM}, got {d}")
    if key_padding_mask is not None:
        if key_padding_mask.dtype != torch.bool:
            raise TypeError("key_padding_mask must be bool")
        if key_padding_mask.shape != (b, k.shape[1]):
            raise ValueError(f"key_padding_mask must be {(b, k.shape[1])}, "
                             f"got {tuple(key_padding_mask.shape)}")
        if key_padding_mask.device != q.device:
            raise ValueError("key_padding_mask must lie on q's device")
        if key_padding_mask.stride(-1) != 1:
            raise ValueError("key_padding_mask must have unit stride over "
                             "time")
    _check_aligned(q=q, k=k, v=v)


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def flash_attention_forward(q, k, v, kpm=None, causal: bool = False,
                            stats: bool = False):
    """One forward kernel launch on CUDA tensors. Returns (out, row_max,
    row_logsum); the two (B, H, Tq) fp32 row statistics, which the backward
    kernel reads, only when ``stats``."""
    _check(q, k, v, kpm)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    row_max = row_logsum = None
    if stats:
        row_max = torch.empty((b, h, tq), dtype=torch.float32,
                              device=q.device)
        row_logsum = torch.empty_like(row_max)
    if out.numel() == 0:
        return out, row_max, row_logsum
    if tk == 0:
        raise ValueError("attention over zero keys")
    launch = nvcc.function("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kpm.data_ptr() if kpm is not None else None,
            row_max.data_ptr() if stats else None,
            row_logsum.data_ptr() if stats else None,
            *_strides(q, k, v, out),
            kpm.stride(0) if kpm is not None else 0,
            b, h, tq, tk, d, int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, row_max, row_logsum


def flash_attention_backward(q, k, v, out, row_max, row_logsum, grad_out,
                             key_padding_mask=None, causal: bool = False):
    """dq, dk, dv of ``flash_attention`` from the forward's inputs, output
    and row statistics: one call of csrc/flash_attention_bwd.cu (two
    launches on the current stream, dQ and D first, then dK and dV),
    counted in ``flash_attention.bwd_launches``."""
    _check(q, k, v, key_padding_mask)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    grad_out = grad_out.contiguous()
    if grad_out.shape != out.shape or grad_out.dtype != q.dtype or \
            out.dtype != q.dtype:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} "
                         f"{grad_out.dtype} does not match the output "
                         f"{tuple(out.shape)} {out.dtype}")
    _check_aligned(out=out, grad_out=grad_out)
    for name, s in (("row_max", row_max), ("row_logsum", row_logsum)):
        if s is None or s.dtype != torch.float32 or s.shape != (b, h, tq) \
                or not s.is_contiguous() or s.device != q.device:
            raise ValueError(f"{name} must be contiguous fp32 {(b, h, tq)} "
                             f"on q's device")
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    rowdot = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *_strides(q, k, v, out, grad_out, dq, dk, dv))
    kpm = key_padding_mask
    launch = nvcc.function("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            grad_out.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            kpm.data_ptr() if kpm is not None else None,
            kpm.stride(0) if kpm is not None else 0,
            row_max.data_ptr(), row_logsum.data_ptr(), rowdot.data_ptr(),
            ctypes.addressof(strides), b, h, tq, tk, d, int(causal),
            _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    flash_attention.bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, causal):
        out, row_max, row_logsum = flash_attention_forward(
            q, k, v, key_padding_mask, causal, stats=True)
        ctx.save_for_backward(q, k, v, out, row_max, row_logsum,
                              key_padding_mask)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, row_max, row_logsum, kpm = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, row_max,
                                              row_logsum, grad_out, kpm,
                                              ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """q (B, Tq, H, D) pre-scaled; k/v (B, Tk, H, D); key_padding_mask
    (B, Tk) True at pad. Returns (B, Tq, H, D) in q's dtype.

    A CPU tensor takes ``flash_attention_reference``; a CUDA tensor takes
    the forward kernel (one launch, counted in ``flash_attention.launches``)
    and, when a gradient is wanted, keeps the row statistics for the
    backward kernel (``flash_attention_backward``)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, key_padding_mask, causal)
    return flash_attention_forward(q, k, v, key_padding_mask, causal,
                                   stats=False)[0]


flash_attention.launches = 0
flash_attention.bwd_launches = 0
