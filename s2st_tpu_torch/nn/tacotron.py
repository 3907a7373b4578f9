"""Tacotron2 Prenet and Postnet (counterpart of ``s2st_tpu/nn/tacotron.py``).

fairseq names: ``Prenet.layers.{i}.0`` linear layers;
``Postnet.convolutions.{i}.0`` conv and ``.1`` BatchNorm1d with running
stats. The prenet's dropout is on at inference too (the Tacotron2
bottleneck): it runs whenever a generator is given.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .core import batch_norm_eval, conv1d, dropout, linear


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
