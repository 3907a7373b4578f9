"""Core layers as plain functions on (B, T, C) tensors.

Counterpart of ``s2st_tpu/nn/core.py``. Modules keep their parameters in
fairseq ``state_dict`` layout (``nn.Linear`` (out, in), ``nn.Conv1d``
(out, in, K)); these functions take those tensors and the JAX package's
(B, T, C) activation layout. Matmul weights are cast to the activation's
dtype (a no-op once a model is cast for inference); layer and batch norm
run in fp32 and cast back, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is wanted and absent; never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def disable_tf32() -> None:
    """Run fp32 matmuls and cuDNN convolutions in full fp32. PyTorch runs
    cuDNN's fp32 convolutions in TF32 by default, which keeps about three
    decimal digits and cannot hold the port's fp32 agreement with JAX.
    Every CLI calls this before it builds a model."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def scaled(x: torch.Tensor, value: float) -> torch.Tensor:
    """x times ``value`` rounded to x's dtype first, as JAX multiplies: by
    ``jnp.asarray(scale, x.dtype)`` or by a weakly typed Python scalar,
    which takes the array's dtype. PyTorch applies a Python float to a bf16
    tensor in fp32, so sqrt(512) would be 22.627 where JAX's bf16 constant
    is 22.625 (128 ** -0.5: 0.0883883 against 0.0883789), and a few percent
    of the bf16 products would round the other way. In fp32 the two agree
    already: the rounding to fp32 is PyTorch's own."""
    return x * _rounded(float(value), x.dtype)


def _as(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return t if t is None or t.dtype == dtype else t.to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(x, _as(weight, x.dtype), _as(bias, x.dtype))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32 statistics and affine, cast back (nn/core.py:180-187)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def batch_norm_eval(x: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm over (B, T, C) with running stats
    (nn/core.py:220-224), fp32 and cast back."""
    xf = x.float()
    y = (xf - running_mean.float()) * torch.rsqrt(running_var.float() + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def batch_norm_train(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, momentum: float = 0.1,
                     eps: float = 1e-5):
    """Training batch norm over (B, T, C) (nn/core.py:203-224): statistics
    over every (B, T) frame, padding included; normalised with the biased
    variance. Returns (y, new running mean, new running var); the running
    var takes the unbiased variance, n / (n - 1), at ``momentum``."""
    xf = x.float()
    mean = xf.mean(dim=(0, 1))
    var = xf.var(dim=(0, 1), unbiased=False)
    n = x.shape[0] * x.shape[1]
    unbiased = var.detach() * (n / max(n - 1, 1))
    new_mean = (1 - momentum) * running_mean.float() + momentum * mean.detach()
    new_var = (1 - momentum) * running_var.float() + momentum * unbiased
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype), new_mean, new_var


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """1D convolution over time. x (B, T, Cin), weight (Cout, Cin, K)
    -> (B, T', Cout)."""
    y = F.conv1d(x.transpose(1, 2), _as(weight, x.dtype), None,
                 stride=stride, padding=padding).transpose(1, 2)
    if bias is not None:
        y = y + _as(bias, x.dtype)
    return y


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def get_activation(name: str):
    """fairseq names; "gelu" is the exact-erf form (nn/core.py:295-304)."""
    return {"relu": F.relu,
            "gelu": F.gelu,
            "gelu_fast": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_accurate": lambda x: F.gelu(x, approximate="tanh"),
            "tanh": torch.tanh,
            "swish": F.silu,
            "linear": lambda x: x}[name]


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int
                            ) -> torch.Tensor:
    """(B, max_len) True at pad positions."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos >= lengths[:, None]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with the JAX package's 8-bit threshold mask
    (nn/core.py:269-287): keep probability quantised to 1/256 and the
    rescale by the quantised keep. No-op without a generator."""
    if generator is None or rate <= 0.0:
        return x
    thresh = int(round(rate * 256.0))
    if thresh <= 0:
        return x
    keep = (256 - thresh) / 256.0
    bits = torch.randint(0, 256, x.shape, generator=generator,
                         device=x.device, dtype=torch.int32)
    return torch.where(bits >= thresh, x / keep, torch.zeros_like(x))
