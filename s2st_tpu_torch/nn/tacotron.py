"""Tacotron2 Prenet and Postnet (counterpart of ``s2st_tpu/nn/tacotron.py``).

fairseq names: ``Prenet.layers.{i}.0`` linear layers;
``Postnet.convolutions.{i}.0`` conv and ``.1`` BatchNorm1d with running
stats. The prenet's dropout is on at inference too (the Tacotron2
bottleneck): it runs whenever a generator is given. In training the postnet
normalises with batch statistics and drops out after every conv
(``postnet`` :67-82, ``train=True``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .core import (batch_norm_eval, batch_norm_train, conv1d, dropout,
                   linear)


class Prenet(nn.Module):
    def __init__(self, in_dim: int, n_layers: int, n_units: int):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Sequential(nn.Linear(in_dim if i == 0 else n_units, n_units))
            for i in range(n_layers))

    def forward(self, x: torch.Tensor, dropout_rate: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """nn/tacotron.py:35: relu(linear) then dropout, per layer."""
        for layer in self.layers:
            fc = layer[0]
            x = dropout(F.relu(linear(x, fc.weight, fc.bias)), dropout_rate,
                        generator)
        return x


class Postnet(nn.Module):
    def __init__(self, in_dim: int, n_channels: int, kernel_size: int,
                 n_layers: int):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"postnet kernel size must be odd, got "
                             f"{kernel_size}")
        self.kernel_size = kernel_size
        self.convolutions = nn.ModuleList()
        for i in range(n_layers):
            cin = in_dim if i == 0 else n_channels
            cout = n_channels if i < n_layers - 1 else in_dim
            self.convolutions.append(nn.Sequential(
                nn.Conv1d(cin, cout, kernel_size,
                          padding=(kernel_size - 1) // 2),
                nn.BatchNorm1d(cout)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C_in) -> residual (B, T, C_in); eval (nn/tacotron.py:67)."""
        pad = (self.kernel_size - 1) // 2
        last = len(self.convolutions) - 1
        for i, block in enumerate(self.convolutions):
            conv, bn = block[0], block[1]
            x = conv1d(x, conv.weight, conv.bias, padding=pad)
            x = batch_norm_eval(x, bn.running_mean, bn.running_var, bn.weight,
                                bn.bias, bn.eps)
            if i < last:
                x = torch.tanh(x)
        return x

    def train_forward(self, x: torch.Tensor, dropout_rate: float,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, Dict[str, Dict]]:
        """Training postnet (nn/tacotron.py:67, train=True): batch
        statistics, dropout after every conv when a generator is given.
        Returns (residual, new running stats {"bnI": {"mean", "var",
        "count"}}, the layout of the JAX ``stats["postnet"]`` tree); the
        module's buffers are left as they are."""
        pad = (self.kernel_size - 1) // 2
        last = len(self.convolutions) - 1
        new_stats = {}
        for i, block in enumerate(self.convolutions):
            conv, bn = block[0], block[1]
            x = conv1d(x, conv.weight, conv.bias, padding=pad)
            x, mean, var = batch_norm_train(x, bn.running_mean, bn.running_var,
                                            bn.weight, bn.bias, bn.momentum,
                                            bn.eps)
            new_stats[f"bn{i}"] = {"mean": mean, "var": var,
                                   "count": bn.num_batches_tracked + 1}
            if i < last:
                x = torch.tanh(x)
            x = dropout(x, dropout_rate, generator)
        return x, new_stats

    @torch.no_grad()
    def load_stats(self, new_stats: Dict[str, Dict[str, torch.Tensor]]):
        """Write ``train_forward``'s running stats into the buffers."""
        for i, block in enumerate(self.convolutions):
            bn, st = block[1], new_stats[f"bn{i}"]
            bn.running_mean.copy_(st["mean"])
            bn.running_var.copy_(st["var"])
            bn.num_batches_tracked.copy_(st["count"])
