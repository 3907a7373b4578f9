"""One training update with update_freq 1.

Counterpart of the fused step of ``s2st_tpu/train/trainer.py`` (:216-279):
forward and loss, backward; the gradients multiplied by
``1 / max(sample_size, 1)`` (as JAX does, although the composite loss is
already a mean); their global norm; the clip factor
``min(1, clip / (gnorm + 1e-6))``; ``lr = schedule(step + 1)``; Adam. A
non-finite norm changes nothing: not the parameters, not Adam's moments or
count, not the step. The postnet's running statistics come from the step
either way, as in JAX. The step's metrics reach the host in one transfer.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from .losses import LossConfig, s2st_loss
from .optim import Adam


class Trainer:
    def __init__(self, model, lcfg: LossConfig,
                 lr_schedule: Callable[[int], float], clip_norm: float = 0.0,
                 betas=(0.9, 0.98), eps: float = 1e-8,
                 generator: Optional[torch.Generator] = None):
        """generator: the dropout stream; None trains without dropout."""
        self.model = model
        self.lcfg = lcfg
        self.lr_schedule = lr_schedule
        self.clip_norm = clip_norm
        self.generator = generator
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = Adam(self.params, betas, eps)

    @property
    def step(self) -> int:
        """Updates taken (skipped ones not counted)."""
        return self.optimizer.count

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One update on a collated batch on the model's device. Returns
        the loss's logging values, ``gnorm`` (before clipping) and ``lr``
        as host floats."""
        for p in self.params:
            p.grad = None
        loss, extras = s2st_loss(self.model, self.lcfg, batch, train=True,
                                 generator=self.generator)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p in self.params:
            p.grad = None
        scale = 1.0 / extras["sample_size"].float().clamp(min=1.0)
        torch._foreach_mul_(grads, scale)
        gnorm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        self.model.decoder.postnet.load_stats(extras["new_stats"]["postnet"])

        logging = extras["logging"]
        keys = list(logging)
        host = torch.stack([torch.as_tensor(logging[k], device=gnorm.device)
                            .float() for k in keys] + [gnorm]).cpu().tolist()
        metrics = dict(zip(keys, host[:-1]))
        metrics["gnorm"] = host[-1]
        metrics["lr"] = self.lr_schedule(self.step + 1)
        if math.isfinite(metrics["gnorm"]):
            if self.clip_norm > 0:
                torch._foreach_mul_(grads, torch.clamp(
                    self.clip_norm / (gnorm + 1e-6), max=1.0))
            self.optimizer.step(grads, metrics["lr"])
        return metrics
