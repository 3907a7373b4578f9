"""Adam and the inverse-sqrt learning-rate schedule.

Counterpart of ``s2st_tpu/train/optim.py``: ``inverse_sqrt_schedule``
(:23-36) and ``adam`` (:269-281): ``optax.scale_by_adam``, or
``scale_by_adam_dtyped`` (:227-265) with the moments stored in bf16 under
``--adam-bf16-stats``, chained with ``optax.add_decayed_weights`` under
``--weight-decay``. The learning rate is applied as the JAX trainer does:
``p -= lr * (mu_hat / (sqrt(nu_hat) + eps) + wd * p)``, with optax's bias
corrections (the same as ``torch.optim.Adam``'s).
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch


def inverse_sqrt_schedule(lr: float, warmup_updates: int = 4000,
                          warmup_init_lr: float = -1.0
                          ) -> Callable[[int], float]:
    """num_updates (1-based) -> lr: a linear warmup from ``warmup_init_lr``
    to ``lr`` over ``warmup_updates``, then lr * sqrt(warmup / n)."""
    if warmup_init_lr < 0:
        warmup_init_lr = 0.0 if warmup_updates > 0 else lr
    lr_step = (lr - warmup_init_lr) / max(warmup_updates, 1)
    decay_factor = lr * warmup_updates ** 0.5 if warmup_updates > 0 else lr

    def sched(num_updates: int) -> float:
        if num_updates < warmup_updates:
            return warmup_init_lr + num_updates * lr_step
        return decay_factor / math.sqrt(max(num_updates, 1))
    return sched


def schedule_from_args(args) -> Callable[[int], float]:
    """The schedule as the JAX training CLI builds it (cli/train.py:107-123):
    a negative ``--warmup-init-lr`` (the default) becomes ``--lr`` itself,
    so the warmup holds the lr flat where fairseq ramps it from 0."""
    if args.lr_scheduler != "inverse_sqrt":
        raise NotImplementedError(
            f"--lr-scheduler {args.lr_scheduler} is not ported")
    lr = float(str(args.lr).split(",")[0])
    warmup_init = args.warmup_init_lr if args.warmup_init_lr >= 0 else lr
    return inverse_sqrt_schedule(lr, args.warmup_updates, warmup_init)


class Adam:
    """Adam over a list of tensors, updated in place (the port's params are
    the model's own). ``step(grads, lr)`` is one optax ``scale_by_adam``
    update, plus ``weight_decay * p``, followed by ``p -= lr * u``;
    ``count`` is the number of updates taken. With ``stats_dtype`` the
    moments are stored in that dtype and the update uses their fp32 values
    before rounding, as ``scale_by_adam_dtyped`` does."""

    def __init__(self, params: Sequence[torch.Tensor],
                 betas: Tuple[float, float] = (0.9, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, stats_dtype=None):
        self.params: List[torch.Tensor] = list(params)
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.stats_dtype = stats_dtype
        self.mu = [torch.zeros_like(p, dtype=stats_dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=stats_dtype)
                   for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        b1, b2 = self.betas
        self.count += 1
        if self.stats_dtype is None:
            mu, nu = self.mu, self.nu
        else:
            mu = [m.float() for m in self.mu]
            nu = [v.float() for v in self.nu]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        bc1 = 1.0 - b1 ** self.count
        bc2 = 1.0 - b2 ** self.count
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        if self.weight_decay:
            torch._foreach_add_(self.params, self.params,
                                alpha=-lr * self.weight_decay)
        torch._foreach_addcdiv_(self.params, mu, denom, value=-lr / bc1)
        if self.stats_dtype is not None:
            torch._foreach_copy_(self.mu, mu)
            torch._foreach_copy_(self.nu, nu)
