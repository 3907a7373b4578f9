"""CTC ASR fine-tuning of an SSL speech trunk (wav2vec 2.0 / HuBERT).

Counterpart of ``s2st_tpu/models/ctc_asr.py`` (:38-239): the HuBERT trunk
(``models/hubert.py``) with ``mask_emb``, then ``final_dropout`` and a
projection to the vocabulary. The module tree carries fairseq's
``Wav2VecCtc`` / ``HubertCtc`` names (``w2v_encoder.w2v_model.<trunk>``,
``w2v_encoder.proj``), JAX's ``params::w2v`` and ``params::proj``, and the
``stats::num_updates`` counter that the freeze reads.

- ``forward_ctc`` (:119-133): the trunk, frozen while the update count is
  below ``freeze_finetune_updates`` (run without a graph: its parameters
  get no gradient, which the trainer counts as zeros, so that Adam's
  count and moments follow JAX's ``stop_gradient``), the fine-tune span
  mask and channel mask under ``apply_mask`` in training
  (``_trunk_encode``, :66-116; given values replace the draws), then
  ``final_dropout`` and ``proj``.
- ``get_ctc_logits`` (:136-155): blank weight added or set, padded frames
  forced to the blank.
- ``greedy_ctc_decode`` (:158-178): argmax, repeats and blanks dropped,
  left-packed at the logits' static width.
- ``load_torch_ctc_asr`` (:181-196) reads a fine-tuned fairseq checkpoint;
  ``load_w2v_trunk`` (:203-239) is ``--w2v-path``: a fairseq ``.pt``
  through the HuBERT reader or a JAX-layout ``.npz``, whose leaves are
  merged by JAX's top-level keys into the trunk. A wav2vec2 ``.npz`` keeps
  its trunk under ``params::trunk``, so from it only ``mask_emb`` is
  taken, as in JAX (ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.core import dropout, lengths_to_padding_mask, linear
from . import hubert as hub
from .jax_bridge import SEP, _to_torch, jax_layout, trunk_jax_rules


@dataclass(frozen=True)
class CtcAsrConfig:
    """``CtcAsrConfig`` (:38-51)."""
    trunk: hub.HubertConfig = dataclasses.field(
        default_factory=hub.HubertConfig)
    vocab_size: int = 32
    final_dropout: float = 0.0
    apply_mask: bool = False
    mask_channel_prob: float = 0.0
    mask_channel_length: int = 10
    freeze_finetune_updates: int = 0
    blank_weight: float = 0.0
    blank_mode: str = "add"
    dtype: Any = torch.float32


class CtcAsrModel(nn.Module):
    jax_rules = trunk_jax_rules("w2v", "w2v_encoder.w2v_model") + [
        (r"^w2v_encoder\.proj$", "proj")]

    def __init__(self, cfg: CtcAsrConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.trunk.encoder_embed_dim
        self.w2v_encoder = nn.Module()
        self.w2v_encoder.w2v_model = hub.HubertModel(cfg.trunk)
        self.w2v_encoder.w2v_model.carry_pretraining({"mask_emb": (d,)})
        self.w2v_encoder.proj = nn.Linear(d, cfg.vocab_size)
        self.stats = hub.Counter()

    @property
    def trunk(self) -> hub.HubertModel:
        return self.w2v_encoder.w2v_model

    def load_stats(self, new_stats: Dict[str, Any]) -> None:
        self.stats.num_updates.copy_(new_stats["num_updates"])

    @torch.no_grad()
    def init_weights(self, seed) -> "CtcAsrModel":
        """Seeded random init with ``init_ctc_asr``'s distributions: the
        trunk's, ``mask_emb`` uniform in [0, 1), ``proj`` N(0, d^-0.5)
        with a zero bias."""
        g = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(seed)
        self.trunk.init_weights(g)
        self.trunk.mask_emb.copy_(torch.rand(self.trunk.mask_emb.shape,
                                             generator=g))
        w = self.w2v_encoder.proj.weight
        w.copy_(torch.randn(w.shape, generator=g) * w.shape[1] ** -0.5)
        self.w2v_encoder.proj.bias.zero_()
        return self

    def trunk_encode(self, source: torch.Tensor, lengths: torch.Tensor,
                     train: bool,
                     generator: Optional[torch.Generator] = None,
                     mask: Optional[torch.Tensor] = None,
                     channel_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_trunk_encode`` (:66-116): (x (B, T', D), padding mask)."""
        from .wav2vec2 import compute_span_mask
        cfg, t = self.cfg, self.cfg.trunk
        trunk = self.trunk
        gen = generator if train else None
        feats = trunk.features(source, t.feature_grad_mult)
        t_out = feats.shape[1]
        out_lengths = t.output_length(lengths).clamp(0, t_out)
        padding_mask = lengths_to_padding_mask(out_lengths, t_out)
        x = dropout(trunk.post_extract(feats), t.dropout_input, gen)
        if cfg.apply_mask and train:
            if t.mask_prob > 0:
                if mask is None:
                    mask = compute_span_mask(out_lengths, t_out, t.mask_prob,
                                             t.mask_length, 2, generator)
                x = torch.where(mask[:, :, None],
                                trunk.mask_emb.to(x.dtype)[None, None, :], x)
            if cfg.mask_channel_prob > 0:
                c_dim = x.shape[2]
                if channel_mask is None:
                    channel_mask = compute_span_mask(
                        torch.full((x.shape[0],), c_dim, dtype=torch.long,
                                   device=x.device), c_dim,
                        cfg.mask_channel_prob, cfg.mask_channel_length, 0,
                        generator)
                x = x.masked_fill(channel_mask[:, None, :], 0.0)
        return trunk.encode(x, padding_mask, gen, input_dropout=t.dropout), \
            padding_mask

    def forward_ctc(self, source: torch.Tensor, lengths: torch.Tensor,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None,
                    mask: Optional[torch.Tensor] = None,
                    channel_mask: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
        """``forward_ctc`` (:119-133): batch-major logits (B, T', V) and
        the padding mask. The trunk runs without a graph while
        ``stats.num_updates`` < ``freeze_finetune_updates``."""
        cfg = self.cfg
        thawed = int(self.stats.num_updates) >= cfg.freeze_finetune_updates
        with torch.set_grad_enabled(torch.is_grad_enabled() and thawed):
            x, padding_mask = self.trunk_encode(source, lengths, train,
                                                generator, mask, channel_mask)
        x = dropout(x, cfg.final_dropout, generator if train else None)
        proj = self.w2v_encoder.proj
        return {"logits": linear(x, proj.weight, proj.bias),
                "padding_mask": padding_mask}


def blank_weighted(logits: torch.Tensor, cfg: CtcAsrConfig,
                   blank: int = 0) -> torch.Tensor:
    """fp32 logits with ``blank_weight`` added to (``add``) or set as
    (``set``) the blank's column."""
    logits = logits.float()
    if cfg.blank_weight == 0:
        return logits
    if cfg.blank_mode not in ("add", "set"):
        raise ValueError(f"invalid blank mode {cfg.blank_mode}")
    col = torch.arange(logits.shape[-1], device=logits.device) == blank
    value = logits + cfg.blank_weight if cfg.blank_mode == "add" \
        else torch.full_like(logits, cfg.blank_weight)
    return torch.where(col, value, logits)


def get_ctc_logits(net: Dict[str, torch.Tensor], cfg: CtcAsrConfig,
                   normalize: bool = False) -> torch.Tensor:
    """``get_ctc_logits`` (:136-155): the blank weight on column 0, padded
    frames +inf on the blank and -inf elsewhere, log-softmax with
    ``normalize``."""
    logits = blank_weighted(net["logits"], cfg)
    pad = net["padding_mask"][:, :, None]
    col = torch.arange(logits.shape[-1], device=logits.device) == 0
    logits = logits.masked_fill(pad & col, float("inf"))
    logits = logits.masked_fill(pad & ~col, float("-inf"))
    if normalize:
        logits = torch.log_softmax(logits, dim=-1)
    return logits


def greedy_ctc_decode(logits: torch.Tensor, out_lengths: torch.Tensor,
                      blank: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``greedy_ctc_decode`` (:158-178): (tokens (B, T) left-packed and
    padded with ``blank``, their counts (B,))."""
    pred = logits.argmax(dim=-1)
    b, t = pred.shape
    t_idx = torch.arange(t, device=pred.device)[None, :]
    prev = torch.cat([torch.full_like(pred[:, :1], -1), pred[:, :-1]], dim=1)
    keep = (t_idx < out_lengths[:, None]) & (pred != prev) & (pred != blank)
    pos = keep.long().cumsum(dim=1) - 1
    n = keep.sum(dim=1)
    out = torch.full_like(pred, blank)
    out.scatter_(1, torch.where(keep, pos, torch.full_like(pos, t - 1)),
                 torch.where(keep, pred, torch.full_like(pred, blank)))
    return torch.where(t_idx < n[:, None], out, torch.full_like(out, blank)), n


def load_torch_ctc_asr(path: str, cfg: CtcAsrConfig) -> CtcAsrModel:
    """A fine-tuned fairseq ``Wav2VecCtc`` / ``HubertCtc`` checkpoint
    (``w2v_encoder.w2v_model.<trunk>`` + ``w2v_encoder.proj``; :181-196)
    -> a ``CtcAsrModel`` of ``cfg`` on the CPU, loaded strictly with
    ``pos_conv``'s weight norm folded and a zero update count. No JAX CLI
    serves a CTC model: this is for callers that ask for it."""
    sd = hub.read_torch_checkpoint(path)
    sd = sd["model"] if "model" in sd else sd
    sd = {k: torch.as_tensor(v).detach().float() for k, v in sd.items()}
    pos = "w2v_encoder.w2v_model.encoder.pos_conv.0."
    if pos + "weight_g" in sd:
        sd[pos + "weight"] = hub.fold_weight_norm(sd.pop(pos + "weight_g"),
                                                  sd.pop(pos + "weight_v"))
    model = CtcAsrModel(cfg)
    names = model.state_dict()
    missing = [k for k in names if k not in sd and k != "stats.num_updates"]
    if missing:
        raise KeyError(f"{path} lacks {missing[:4]}")
    sd = {k: sd[k].contiguous() for k in names if k != "stats.num_updates"}
    sd["stats.num_updates"] = torch.zeros((), dtype=torch.int32)
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def load_w2v_trunk(model: CtcAsrModel, path: str) -> CtcAsrModel:
    """``--w2v-path`` (``load_w2v_trunk``, :203-239): every leaf of the
    trunk (``params::w2v``) that the file holds under the same path below
    its top level is copied; a ``.pt`` is read by ``load_torch_hubert``
    (its pretraining ``final_proj`` and ``label_embs_concat`` dropped), an
    ``.npz`` by its ``params::`` keys. A shape that differs raises."""
    prefix = "params" + SEP + "w2v" + SEP
    entries = [(name, key[len(prefix):], kind)
               for name, key, kind in jax_layout(model)
               if key.startswith(prefix)]
    current = model.state_dict()
    if path.endswith((".pt", ".bin")):
        sd, _ = hub.load_torch_hubert(path, model.cfg.trunk)
        pre = "w2v_encoder.w2v_model."
        loaded = {name: sd[name[len(pre):]] for name, _, _ in entries
                  if name[len(pre):] in sd}
    else:
        with np.load(path, allow_pickle=False) as z:
            flat = {k[len("params" + SEP):]: z[k] for k in z.files
                    if k.startswith("params" + SEP)}
        loaded = {name: _to_torch(flat[rel], kind)
                  for name, rel, kind in entries if rel in flat}
    for name, t in loaded.items():
        if tuple(t.shape) != tuple(current[name].shape):
            raise AssertionError((name, tuple(t.shape),
                                  tuple(current[name].shape)))
        current[name].copy_(t.to(current[name].dtype))
    return model


__all__ = ["CtcAsrConfig", "CtcAsrModel", "blank_weighted",
           "get_ctc_logits", "greedy_ctc_decode", "load_torch_ctc_asr",
           "load_w2v_trunk"]
