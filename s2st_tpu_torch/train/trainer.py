"""One training update over one or more microbatches.

Counterpart of ``s2st_tpu/train/trainer.py``: the fused step (:254-279)
and, for ``--update-freq`` > 1, the microbatch path of ``train_step``
(:499-535). Each microbatch's forward and backward run at the update's
parameters; the gradients sum over the microbatches, and the running
statistics of the model's BatchNorms (the postnet's, and the T2S text
encoder's) pass from one microbatch to the next (the model's
``load_stats``). Then one apply
(``apply_grads``, :216-240): the summed gradients multiplied by
``1 / max(sample_size, 1)`` over the summed sample size (as JAX does,
although the composite loss is already a mean); their global norm; the
clip factor ``min(1, clip / (gnorm + 1e-6))``; ``lr = schedule(step + 1)``;
the optimizer's step (``train/optim.py``: Adam by default, or any of JAX's
registry by name, with ``p -= lr * u``). A non-finite norm changes
nothing: not the parameters, not the optimizer's state or count, not the
step (JAX's ``jnp.where``). The statistics come from the microbatches
either way, as in JAX. The logging values are summed over
the microbatches and the loss's means divided by their number; they reach
the host in one transfer. ``lr_scale`` multiplies the schedule's rate (the
plateau shrink, :231-232). ``valid_step`` (:537-543) is the loss of one
batch in eval mode, without a gradient. The loss is ``s2st_loss`` unless
``loss_fn`` names another of ``train/losses.py`` (``t2s_loss`` for the T2S
model, ``s2t_loss`` for the text-output models, whose ``new_stats`` are
empty); the ``mean_keys`` it returns are the logging values averaged over
microbatches.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from .checkpoint import _param_entries
from .losses import LossConfig, s2st_loss
from .optim import build_optimizer

Batch = Dict[str, Any]


class Trainer:
    def __init__(self, model, lcfg: LossConfig,
                 lr_schedule: Callable[[int], float], clip_norm: float = 0.0,
                 betas=(0.9, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, stats_dtype=None,
                 loss_fn: Callable = s2st_loss, optimizer: str = "adam",
                 optimizer_kw: Optional[Dict[str, Any]] = None):
        """optimizer: a name of ``train/optim.py::OPTIMIZER_REGISTRY``,
        built with ``optimizer_kw``; Adam without them takes ``betas``,
        ``eps``, ``weight_decay`` and ``stats_dtype``."""
        self.model = model
        self.lcfg = lcfg
        self.loss_fn = loss_fn
        self.lr_schedule = lr_schedule
        self.clip_norm = clip_norm
        self.params = [p for p in model.parameters() if p.requires_grad]
        if optimizer == "adam" and optimizer_kw is None:
            optimizer_kw = dict(betas=betas, eps=eps,
                                weight_decay=weight_decay,
                                stats_dtype=stats_dtype)
        # each parameter's layout in JAX (adafactor's statistics follow it)
        kinds = [kind for _, _, kind in _param_entries(model)]
        self.optimizer = build_optimizer(optimizer, self.params, kinds,
                                         **(optimizer_kw or {}))
        self.step = 0   # updates taken (skipped ones not counted)

    def train_step(self, microbatches: Union[Batch, Sequence[Batch]],
                   generators: Optional[Sequence[torch.Generator]] = None,
                   layer_keeps: Optional[Sequence[Optional[Sequence[bool]]]]
                   = None, lr_scale: float = 1.0) -> Dict[str, float]:
        """One update on collated batches on the model's device (one batch
        or a list). generators: one dropout stream per microbatch (None
        trains without dropout); layer_keeps: the encoder's LayerDrop
        decisions for each microbatch, drawn for each as JAX's encoder
        draws them from the microbatch's key
        (``s2st_tpu/train/trainer.py:509``). Returns the loss's
        logging values, ``gnorm`` (before clipping), ``lr`` and
        ``sample_size`` as host floats; ``lr`` is the schedule's times
        ``lr_scale``."""
        if isinstance(microbatches, dict):
            microbatches = [microbatches]
        for p in self.params:
            p.grad = None
        sums: Dict[str, torch.Tensor] = {}
        sample_size = None
        for i, batch in enumerate(microbatches):
            loss, extras = self.loss_fn(
                self.model, self.lcfg, batch, train=True,
                generator=generators[i] if generators else None,
                layer_keep=layer_keeps[i] if layer_keeps else None)
            loss.backward()
            if extras["new_stats"]:
                self.model.load_stats(extras["new_stats"])
            ss = extras["sample_size"]
            sample_size = ss if sample_size is None else sample_size + ss
            for k, v in extras["logging"].items():
                v = torch.as_tensor(v, device=ss.device).float()
                sums[k] = v if k not in sums else sums[k] + v
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p in self.params:
            p.grad = None
        scale = 1.0 / sample_size.float().clamp(min=1.0)
        torch._foreach_mul_(grads, scale)
        gnorm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))

        sums["sample_size"] = sample_size.float()
        keys = list(sums)
        host = torch.stack([sums[k] for k in keys] + [gnorm]).cpu().tolist()
        metrics = dict(zip(keys, host[:-1]))
        for k in extras["mean_keys"]:
            if k in metrics:
                metrics[k] /= len(microbatches)
        metrics["gnorm"] = host[-1]
        metrics["lr"] = self.lr_schedule(self.step + 1) * lr_scale
        if math.isfinite(metrics["gnorm"]):
            if self.clip_norm > 0:
                torch._foreach_mul_(grads, torch.clamp(
                    self.clip_norm / (gnorm + 1e-6), max=1.0))
            self.optimizer.step(grads, metrics["lr"])
            self.step += 1
        return metrics

    @torch.no_grad()
    def valid_step(self, batch: Batch,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, float]:
        """The loss's logging values of one batch (sorted by name, as
        JAX's device_get returns them) as host floats: the postnet on its
        running statistics, dropout off but for the prenet's, which
        ``generator`` draws (JAX passes its valid step a key). On a CUDA
        tensor every attention of the forward takes the kernel."""
        _, extras = self.loss_fn(self.model, self.lcfg, batch, train=False,
                                 generator=generator)
        logging = extras["logging"]
        keys = sorted(logging)
        dev = extras["sample_size"].device
        host = torch.stack([torch.as_tensor(logging[k], device=dev).float()
                            for k in keys]).cpu().tolist()
        return dict(zip(keys, host))
