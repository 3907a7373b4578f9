"""The LSTM pieces that Berard and Tacotron2 share.

Counterpart of ``s2st_tpu/models/lstm.py``'s ``lstm_cell`` (:217-226),
``_run_lstm`` (:228-262) and ``_lstm_params`` (:72-78): a cell with
torch's gate order ``[i, f, g, o]`` and both biases, and the packed
(bi)LSTM layer over a padded batch, whose outputs are zero past each row's
length, whose final ``(h, c)`` is the state at the row's last real step and
whose reverse direction reads only the row's valid region, reversed. The
LSTM text model of that file is not ported.

JAX computes both in plain XLA (a ``lax.scan`` of cells under a validity
mask). The port runs a layer as one ``torch.lstm`` call over a
``PackedSequence`` (cuDNN's RNN on the card, in fp32 or bf16) with the fp32
weights cast at the call, and a decoder step as ``torch.lstm_cell`` (two
GEMMs and one fused cell) with weights its decoder cast once a forward,
in the compute dtype. A row of length 0 (a batch's pad row) runs one step,
whose output and state are then zeroed: its outputs are zero and its
final state is the zero initial state, as in JAX.

Parameters keep torch's names, ``weight_ih_l{k}[_reverse]`` of an
``nn.LSTM`` and ``weight_ih`` of an ``nn.LSTMCell``, each (4H, in) or (4H,
H) as JAX keeps them; ``lstm_jax_names`` and ``cell_jax_names`` give the
JAX leaves (``l{k}::w_ih``, ``l{k}_rev::w_ih``; ``w_ih``) for the bridge.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)

_LEAVES = (("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"),
           ("bias_hh", "b_hh"))


def lstm_jax_names(lstm: nn.LSTM) -> Dict[str, Tuple[str, str]]:
    """{entry: (JAX leaf, kind)} of a bidirectional ``nn.LSTM``'s
    parameters: layer k's forward direction under ``l{k}``, its reverse
    under ``l{k}_rev``."""
    names = {}
    for k in range(lstm.num_layers):
        for sfx, node in (("", f"l{k}"), ("_reverse", f"l{k}_rev")):
            for torch_name, leaf in _LEAVES:
                names[f"{torch_name}_l{k}{sfx}"] = (f"{node}::{leaf}", "same")
    return names


def cell_jax_names() -> Dict[str, Tuple[str, str]]:
    """{entry: (JAX leaf, kind)} of an ``nn.LSTMCell``."""
    return {torch_name: (leaf, "same") for torch_name, leaf in _LEAVES}


def layer_weights(lstm: nn.LSTM, k: int, reverse: bool = False
                  ) -> List[torch.Tensor]:
    """[w_ih, w_hh, b_ih, b_hh] of layer k's forward or reverse direction."""
    sfx = "_reverse" if reverse else ""
    return [getattr(lstm, f"{n}_l{k}{sfx}") for n, _ in _LEAVES]


def cell_weights(cell: nn.LSTMCell, dtype) -> List[torch.Tensor]:
    """[w_ih, w_hh, b_ih, b_hh] of ``cell`` in ``dtype``, for
    ``torch.lstm_cell`` (``lstm_cell``, :217-226). A decoder casts
    them once a forward: a cast at every step would keep a copy a step for
    the backward (63 MB a step for Tacotron2's three 1024-d cells in
    bf16)."""
    return [getattr(cell, n).to(dtype) for n, _ in _LEAVES]


def lstm_layer(x: torch.Tensor, lens: torch.Tensor,
               weights: List[torch.Tensor],
               reverse_weights: Optional[List[torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One LSTM layer over x (B, T, C) with row lengths ``lens`` (B,):
    forward with ``weights``, and reverse with ``reverse_weights`` when
    given (``_run_lstm`` of each direction, :228-262). Returns (outputs
    (B, T, H or 2H), the forward direction first, zero past each length;
    (h, c) each (directions, B, H), the state at each row's last real
    step)."""
    b, t, _ = x.shape
    bidirectional = reverse_weights is not None
    flat = [w.to(x.dtype) for w in
            weights + (reverse_weights if bidirectional else [])]
    hdim = weights[1].shape[1]
    packed = pack_padded_sequence(x, lens.clamp(min=1).cpu(),
                                  batch_first=True, enforce_sorted=False)
    h0 = x.new_zeros((2 if bidirectional else 1, b, hdim))
    with warnings.catch_warnings():
        # cuDNN copies the cast weights into one buffer a call, as meant
        warnings.filterwarnings("ignore", message="RNN module weights")
        out, h, c = torch.lstm(packed.data, packed.batch_sizes, (h0, h0),
                               flat, True, 1, 0.0, torch.is_grad_enabled(),
                               bidirectional)
    out, _ = pad_packed_sequence(
        PackedSequence(out, packed.batch_sizes, packed.sorted_indices,
                       packed.unsorted_indices),
        batch_first=True, total_length=t)
    real = (lens > 0).to(x.dtype)
    h = h.index_select(1, packed.unsorted_indices) * real[None, :, None]
    c = c.index_select(1, packed.unsorted_indices) * real[None, :, None]
    return out * real[:, None, None], (h, c)


def bilstm_stack(lstm: nn.LSTM, x: torch.Tensor, lens: torch.Tensor,
                 between: Optional[Callable[[torch.Tensor], torch.Tensor]]
                 = None) -> torch.Tensor:
    """Every layer of a bidirectional ``nn.LSTM`` over x (B, T, C), each
    layer's two directions concatenated, ``between`` applied between
    layers (not after the last). Returns (B, T, 2H), zero past each
    length."""
    for k in range(lstm.num_layers):
        x, _ = lstm_layer(x, lens, layer_weights(lstm, k),
                          layer_weights(lstm, k, reverse=True))
        if between is not None and k < lstm.num_layers - 1:
            x = between(x)
    return x


__all__ = ["cell_weights", "lstm_layer", "bilstm_stack", "layer_weights",
           "lstm_jax_names", "cell_jax_names"]
