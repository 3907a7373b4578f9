"""Exponential moving average of the parameters.

Counterpart of ``s2st_tpu/train/ema.py`` (:22-52): an fp32 shadow of the
parameters, seeded from them; after each update, ``e = d * e + (1 - d) *
p`` with d = 0 before ``ema_start_update`` (the shadow tracks the
parameters exactly) and ``ema_decay`` after, on the updates that
``ema_update_freq`` divides (d = 1, no change, on the others). The step is
the trainer's, counted after the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch


@dataclass(frozen=True)
class EMAConfig:
    ema_decay: float = 0.9999
    ema_start_update: int = 0
    ema_update_freq: int = 1


def init_ema(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [p.detach().float().clone() for p in params]


@torch.no_grad()
def ema_step(cfg: EMAConfig, ema: List[torch.Tensor],
             params: Sequence[torch.Tensor], step: int) -> None:
    """One update of the shadow ``ema`` in place."""
    decay = cfg.ema_decay if step >= cfg.ema_start_update else 0.0
    if step % cfg.ema_update_freq != 0:
        decay = 1.0
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p.float() for p in params], alpha=1.0 - decay)
