"""Lightweight and dynamic convolutions: the Hopper kernels and their plain
PyTorch versions.

Counterpart of ``s2st_tpu/ops/conv_kernels.py``. Both are depthwise K-tap
convolutions over time with softmax-normalised weights shared by the C/H
channels of each head (h(c) = c // (C/H)):

  lightconv:    y[b,t,c] = sum_k softmax(w)[h(c),k]       * x[b, t+k-pad, c]
  dynamicconv:  y[b,t,c] = sum_k softmax(w)[b,t,h(c),k]   * x[b, t+k-pad, c]

with x read as 0 outside [0, T) and pad = ``padding_l`` in [0, K-1] (K // 2
in the LightConv encoder, K - 1 in its causal decoder). The softmax runs in
fp32, the taps accumulate in fp32 and the output has x's type, as in the TPU
kernels.

On a CUDA tensor ``lightconv`` launches ``csrc/lightconv.cu`` and
``dynamicconv`` launches ``csrc/dynamicconv.cu`` (built for ``sm_90a`` on
first use, loaded with ctypes; each launch counted in ``.launches``); a call
the kernels cannot take raises. ``launch_plan`` chooses each launch's block
shape and load width (``DESIGNS`` says what the kernels do with them). On a
CPU tensor they run the plain versions ``lightconv_reference`` /
``dynamicconv_reference``. When a gradient is wanted they go through a
``torch.autograd.Function`` whose backward is the autograd of the plain
version, as the TPU functions' ``custom_vjp`` backward is the VJP of their
XLA references (``conv_kernels.py:110-126,190-206``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import nvcc

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Z = 65535
# the kernels' block shape (csrc/conv_common.cuh): LANES channels a block,
# one a lane; ROWS consecutive outputs a thread; up to 4 warps over time
LANES, ROWS, MAX_WARPS = 32, 16, 4
TEMPLATED_K = (3, 7, 15, 31)   # compiled in: lightconv_iwslt_de_en's sizes
_MAX_SMEM = 227 * 1024
DESIGNS = {
    "lightconv": "32 channels x 64 steps a block, 16 outputs a thread; "
                 "softmax once a block, weights in registers (K = 3, 7, 15, "
                 "31 compiled in); x tile in shared memory by 16-byte loads",
    "dynamicconv": "32 channels x 64 steps a block, 16 outputs a thread; "
                   "logits staged, one softmax a (b, t, head) a thread, in "
                   "shared memory; x window in registers (K = 3, 7, 15, 31 "
                   "compiled in); x tile by 16-byte loads",
}


def _check_shapes(x: torch.Tensor, weight: torch.Tensor, padding_l: int,
                  heads: int, kernel_size: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, C), got {tuple(x.shape)}")
    if heads <= 0 or x.shape[2] % heads != 0:
        raise ValueError(f"C={x.shape[2]} is not a multiple of heads={heads}")
    if kernel_size <= 0 or not 0 <= padding_l <= kernel_size - 1:
        raise ValueError(f"padding_l={padding_l} outside [0, K-1] for "
                         f"K={kernel_size}")
    if weight.device != x.device:
        raise ValueError(f"weight on {weight.device}, x on {x.device}")


def _taps(x: torch.Tensor, w_c: torch.Tensor, padding_l: int
          ) -> torch.Tensor:
    """sum_k w_c[..., k] * x[:, t+k-padding_l, :] in fp32, tap by tap;
    w_c broadcasts against (B, T, C) and has K on its last axis."""
    k, t = w_c.shape[-1], x.shape[1]
    xp = F.pad(x.float(), (0, 0, padding_l, k - 1 - padding_l))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for ki in range(k):
        out = out + xp[:, ki:ki + t, :] * w_c[..., ki]
    return out.to(x.dtype)


def lightconv_reference(x: torch.Tensor, weight: torch.Tensor,
                        padding_l: int, heads: int) -> torch.Tensor:
    """Plain version. x (B, T, C); weight (H, K) raw. Returns (B, T, C)."""
    _check_shapes(x, weight, padding_l, heads, weight.shape[-1])
    c = x.shape[2]
    w_c = torch.softmax(weight.float(), dim=-1).repeat_interleave(
        c // heads, dim=0)                                   # (C, K)
    return _taps(x, w_c, padding_l)


def dynamicconv_reference(x: torch.Tensor, weight: torch.Tensor,
                          padding_l: int, heads: int) -> torch.Tensor:
    """Plain version. x (B, T, C); weight (B, T, H, K) raw logits. Returns
    (B, T, C)."""
    _check_shapes(x, weight, padding_l, heads, weight.shape[-1])
    c = x.shape[2]
    w_c = torch.softmax(weight.float(), dim=-1).repeat_interleave(
        c // heads, dim=2)                                   # (B, T, C, K)
    return _taps(x, w_c, padding_l)


def _check_cuda(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the conv kernels take CUDA tensors, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if weight.dtype not in _DTYPES:
        raise TypeError(f"weight must be float32 or bfloat16, got "
                        f"{weight.dtype}")
    if x.shape[0] > _MAX_GRID_Z:
        raise ValueError(f"batch {x.shape[0]} above {_MAX_GRID_Z}")


def max_heads_in_chunk(c: int, heads: int) -> int:
    """The most heads that one block's LANES channels span."""
    per_head = c // heads
    return max((min(c0 + LANES, c) - 1) // per_head - c0 // per_head + 1
               for c0 in range(0, c, LANES))


def smem_bytes(kind: str, c: int, heads: int, k: int, warps: int) -> int:
    """Shared memory of one block (the launchers' own sum): the softmaxed
    weights (lightconv: the heads of the chunk, padded to 4 words;
    dynamicconv: each of the tile's steps times those heads, each row
    padded to an odd count of 4 words), then x's tile of warps x ROWS steps
    and its K-1 halo rows, all fp32."""
    nh = max_heads_in_chunk(c, heads)
    if kind == "lightconv":
        weights = -(-nh * k // 4) * 4
    else:       # rows of an odd count of 16-byte groups
        groups = -(-k // 4)
        weights = warps * ROWS * nh * 4 * (groups + 1 - groups % 2)
    return 4 * (weights + (warps * ROWS + k - 1) * LANES)


def launch_plan(kind: str, t: int, c: int, heads: int, k: int,
                dtype: torch.dtype, data_ptr: int = 0) -> dict:
    """How the kernel is launched for x (B, t, c) at kernel size k: the
    block's warps over time (4 down to the fewest that cover t, halved
    further while its shared memory would pass the card's 227 KiB), whether
    x is staged with 16-byte loads (c a multiple of 16 bytes' elements and
    x's data pointer 16-byte aligned; else one element a thread), and
    whether k is compiled in. Raises where even one warp does not fit."""
    warps = MAX_WARPS
    while warps > 1 and (warps // 2) * ROWS >= t:
        warps //= 2
    while warps > 1 and smem_bytes(kind, c, heads, k, warps) > _MAX_SMEM:
        warps //= 2
    smem = smem_bytes(kind, c, heads, k, warps)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"{kind}: K={k} over {max_heads_in_chunk(c, heads)} heads a "
            f"{LANES}-channel block needs {smem} bytes of shared memory, "
            f"above {_MAX_SMEM}")
    per_vec = 16 // torch.empty((), dtype=dtype).element_size()
    return {"warps": warps,
            "vector": c % per_vec == 0 and data_ptr % 16 == 0,
            "templated_k": k in TEMPLATED_K, "smem_bytes": smem}


def _launch(name: str, x: torch.Tensor, weight: torch.Tensor, out,
            padding_l: int, heads: int, *dtypes: int) -> None:
    b, t, c = x.shape
    k = weight.shape[-1]
    plan = launch_plan(name, t, c, heads, k, x.dtype, x.data_ptr())
    launch = nvcc.function(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), weight.data_ptr(), out.data_ptr(), b, t, c,
                     heads, k, padding_l, *dtypes, plan["warps"],
                     int(plan["vector"]), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def lightconv_forward(x: torch.Tensor, weight: torch.Tensor, padding_l: int,
                      heads: int) -> torch.Tensor:
    """One launch of csrc/lightconv.cu on CUDA tensors (counted in
    ``lightconv.launches``); inputs are made contiguous, the weights fp32."""
    _check_shapes(x, weight, padding_l, heads, weight.shape[-1])
    _check_cuda(x, weight)
    if weight.shape != (heads, weight.shape[-1]):
        raise ValueError(f"weight must be (H={heads}, K), got "
                         f"{tuple(weight.shape)}")
    x = x.contiguous()
    weight = weight.float().contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _launch("lightconv", x, weight, out, padding_l, heads, _DTYPES[x.dtype])
    lightconv.launches += 1
    return out


def dynamicconv_forward(x: torch.Tensor, weight: torch.Tensor,
                        padding_l: int, heads: int) -> torch.Tensor:
    """One launch of csrc/dynamicconv.cu on CUDA tensors (counted in
    ``dynamicconv.launches``); inputs are made contiguous. The logits may be
    fp32 or bf16 whatever x's type is."""
    _check_shapes(x, weight, padding_l, heads, weight.shape[-1])
    _check_cuda(x, weight)
    b, t, _ = x.shape
    if weight.shape[:3] != (b, t, heads):
        raise ValueError(f"weight must be (B={b}, T={t}, H={heads}, K), got "
                         f"{tuple(weight.shape)}")
    x = x.contiguous()
    weight = weight.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _launch("dynamicconv", x, weight, out, padding_l, heads,
            _DTYPES[x.dtype], _DTYPES[weight.dtype])
    dynamicconv.launches += 1
    return out


_FORWARD = {"lightconv": (lightconv_forward, lightconv_reference),
            "dynamicconv": (dynamicconv_forward, dynamicconv_reference)}


def _forward(name: str, x, weight, padding_l, heads):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    kernel, plain = _FORWARD[name]
    if x.device.type == "cpu":
        return plain(x, weight, padding_l, heads)
    return kernel(x, weight, padding_l, heads)


class _Conv(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU). Backward: autograd
    of the plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, name, x, weight, padding_l, heads):
        ctx.save_for_backward(x, weight)
        ctx.args = (name, padding_l, heads)
        return _forward(name, x, weight, padding_l, heads)

    @staticmethod
    def backward(ctx, grad_out):
        name, padding_l, heads = ctx.args
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(ctx.needs_input_grad[1])
            ww = weight.detach().requires_grad_(ctx.needs_input_grad[2])
            leaves = [t for t in (xx, ww) if t.requires_grad]
            y = _FORWARD[name][1](xx, ww, padding_l, heads)
            grads = iter(torch.autograd.grad(y, leaves, grad_out))
        gx = next(grads) if xx.requires_grad else None
        gw = next(grads) if ww.requires_grad else None
        return None, gx, gw, None, None


def _apply(name: str, x, weight, padding_l: int, heads: int):
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _Conv.apply(name, x, weight, padding_l, heads)
    return _forward(name, x, weight, padding_l, heads)


def lightconv(x: torch.Tensor, weight: torch.Tensor, padding_l: int,
              heads: int) -> torch.Tensor:
    """x (B, T, C); weight (H, K) raw, softmaxed inside. Returns (B, T, C)
    in x's type."""
    return _apply("lightconv", x, weight, padding_l, heads)


def dynamicconv(x: torch.Tensor, weight: torch.Tensor, padding_l: int,
                heads: int) -> torch.Tensor:
    """x (B, T, C); weight (B, T, H, K) raw logits, softmaxed inside.
    Returns (B, T, C) in x's type."""
    return _apply("dynamicconv", x, weight, padding_l, heads)


lightconv.launches = 0
dynamicconv.launches = 0
