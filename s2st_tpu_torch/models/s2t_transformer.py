"""Speech-to-text transformer: the ASR/ST pretraining model of the paper's
mix-tuning and prompt-tuning recipes.

Counterpart of ``s2st_tpu/models/s2t_transformer.py``: the S2ST model's
speech encoder (the optional frozen HuBERT frontend, the conv1d-GLU
subsampler and the transformer layers, without aux heads or middle-layer
taps; ``init_s2t``, :42-56) and a text decoder built as the S2ST model's
aux decoders are (``_aux_decoder_init`` / ``aux_decode``,
models/s2st_transformer.py:164-180, :566-619) of ``decoder_layers`` x
``decoder_embed_dim`` with the base config's FFN width and heads, over the
final encoder output (``forward``, :59-85). The modules are named
``encoder`` and ``decoder``, so the JAX bridge maps them to JAX's
``params::encoder`` / ``params::decoder`` (and the frontend to
``params::hubert``), the layout in which an S2T encoder warm-starts the
S2ST model's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from . import hubert as hub
from .jax_bridge import load_jax_variables
from .s2st_transformer import (AuxTextDecoder, S2STConfig, S2STEncoder,
                               seeded_init)


@dataclass(frozen=True)
class S2TConfig:
    """``S2TConfig`` (:31-39) with the decoder's vocabulary: the source
    dictionary's for ``--test-type asr``, the target's for ``st``."""
    base: S2STConfig = dataclasses.field(default_factory=S2STConfig)
    decoder_layers: int = 6
    decoder_embed_dim: int = 256
    vocab_size: int = 100


class S2TTransformer(nn.Module):
    def __init__(self, cfg: S2TConfig):
        super().__init__()
        self.cfg = cfg
        base = cfg.base.replace(aux_asr=False, aux_st=False, ctc=False,
                                middle_layers=())
        self.encoder = S2STEncoder(base)
        self.decoder = AuxTextDecoder(base, cfg.vocab_size,
                                      cfg.decoder_embed_dim,
                                      cfg.decoder_layers)

    def forward(self, batch: Dict[str, Any], prev_tokens: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None
                ) -> Dict[str, Any]:
        """Teacher-forced forward: the encoder over ``src_speech`` (and
        ``speaker`` where the batch has it), then the decoder over
        ``prev_tokens`` (B, Tt). With ``train`` and a generator every
        dropout site is on and ``layer_keep`` gives the encoder's LayerDrop
        decisions. Returns logits (B, Tt, V) in the compute dtype, the
        encoder's padding mask and output lengths, and an empty
        ``new_stats``."""
        drop = generator if train else None
        enc = self.encoder(batch["src_speech"], batch["src_speech_lens"],
                           batch.get("speaker"), drop,
                           layer_keep if drop is not None else None)
        logits = self.decoder(prev_tokens, enc["encoder_out"],
                              enc["encoder_padding_mask"], drop)
        return {"logits": logits, "encoder_out": enc["encoder_out"],
                "encoder_padding_mask": enc["encoder_padding_mask"],
                "encoder_out_lengths": enc["out_lengths"], "new_stats": {}}

    def init_weights(self, seed: int) -> "S2TTransformer":
        """Seeded random init with the JAX package's distributions
        (``s2st_transformer.seeded_init``)."""
        seeded_init(self, torch.Generator().manual_seed(seed), self.encoder)
        return self


def from_jax_variables(cfg: S2TConfig, variables: Dict[str, Any]
                       ) -> S2TTransformer:
    """A model of ``cfg`` holding a JAX S2T ``{"params", "stats"}`` tree of
    numpy arrays (``params/{encoder,decoder,hubert}``; strict both ways)."""
    model = S2TTransformer(cfg)
    if model.encoder.hubert is not None:
        model.encoder.hubert.carry_pretraining(hub.pretraining_shapes(
            variables["params"].get("hubert", {})))
    return load_jax_variables(model, variables)

