"""Fused attention forward: the Hopper kernel and its plain PyTorch version.

``flash_attention`` replaces the Pallas TPU kernel behind
``s2st_tpu/nn/attention.py::attend_flash`` (:44-88). On a CUDA tensor it
launches ``csrc/flash_attention.cu`` (built for ``sm_90a`` on first use and
loaded with ctypes); on a CPU tensor it runs ``flash_attention_reference``.
There is no other path: a CUDA call the kernel cannot take raises.

Semantics (those of ``s2st_tpu/nn/attention.py::attend``): q is pre-scaled;
a causal mask of -1e9 is added strictly above the diagonal; key padding
replaces the score with -1e9, so a row with no valid key averages every
value; softmax and accumulation run in fp32 and the output has the input
type.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1e9

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              key_padding_mask: Optional[torch.Tensor] = None,
                              causal: bool = False) -> torch.Tensor:
    """Plain version: einsum + masked fp32 softmax. q (B, Tq, H, D)
    pre-scaled, k/v (B, Tk, H, D), key_padding_mask (B, Tk) True at pad.
    Returns (B, Tq, H, D) in v's dtype."""
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


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{_SOURCE.name}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    lib_path = _BUILD_DIR / f"libflash_attention_{tag}.so"
    if not lib_path.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        build_log = (res.stdout + res.stderr).strip()
        (_BUILD_DIR / f"{lib_path.stem}.ptxas.txt").write_text(build_log)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.s2st_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 13
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def build() -> Path:
    """Build and load the kernel now; returns the library path."""
    return Path(_library()._name)


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
    if d % 8 != 0 or d > _MAX_HEAD_DIM:
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_padding_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """q (B, Tq, H, D) pre-scaled; k/v (B, Tk, H, D); key_padding_mask
    (B, Tk) True at pad. Returns (B, Tq, H, D) in q's dtype.

    A CPU tensor takes ``flash_attention_reference``; a CUDA tensor takes
    the kernel (one launch, counted in ``flash_attention.launches``)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, key_padding_mask, causal)
    _check(q, k, v, key_padding_mask)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if tk == 0:
        raise ValueError("attention over zero keys")
    lib = _library()
    kpm = key_padding_mask
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.s2st_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kpm.data_ptr() if kpm is not None else None,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            kpm.stride(0) if kpm is not None else 0,
            b, h, tq, tk, d, int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
