"""``Wav2Vec2ForCTC``'s inference path: stage 8's ASR in the port.

JAX's stage 8 (``s2st_tpu/cli/evaluate_s2s_bleu.py::build_hf_transcriber``,
:36-52) transcribes each waveform with ``transformers``' ``Wav2Vec2ForCTC``
(by default ``facebook/wav2vec2-large-960h-lv60-self``), one utterance at a
time, in fp32, with no attention mask. This module computes the same
function from the same files with no HF package
(``models/hf_checkpoint.py`` reads them, ``data/wav2vec2_processor.py``
prepares the input and decodes), for both layouts ``modeling_wav2vec2.py``
defines:

- ``feat_extract_norm="group"``, post-LN (``do_stable_layer_norm`` False;
  base-960h): conv layers without bias, GroupNorm(C, C) after the first
  (``group_norm_over_time``, shared with the HuBERT frontend), exact GELU;
  ``encoder.layer_norm`` on the sum of the input and ``pos_conv`` before
  post-LN layers (``Wav2Vec2Encoder``).
- ``feat_extract_norm="layer"`` with ``conv_bias``, stable LN (lv60-self):
  every conv layer is conv, LayerNorm over channels, GELU
  (``Wav2Vec2LayerNormConvLayer``, :284); pre-LN layers
  (``Wav2Vec2EncoderLayerStableLayerNorm``, :636) and ``encoder.layer_norm``
  after them (``Wav2Vec2EncoderStableLayerNorm``, :776).

Both: ``feature_projection`` (LayerNorm, Linear),
the grouped weight-normed ``pos_conv`` with its even kernel's trailing frame
trimmed (``Wav2Vec2SamePadLayer``), then ``lm_head``. Each layer is the
port's ``TransformerEncoderLayer``, so its self-attention is
``nn.attention.MultiheadAttention``: on a CUDA tensor the fp32 attention
kernel (``csrc/flash_attention.cu``) at head_dim 64 for the large model.

Names: the module tree carries HF's ``state_dict`` names
(``wav2vec2.feature_extractor.conv_layers.{i}.conv``, ``.layer_norm``,
``wav2vec2.feature_projection.*``, ``wav2vec2.encoder.pos_conv_embed.conv``,
``wav2vec2.encoder.layer_norm``, ``lm_head``, ``wav2vec2.masked_spec_embed``
where the config keeps one) down to each layer; inside a layer the port's
names stand for HF's (``port_key``). ``load`` folds ``pos_conv``'s weight
norm (hub ``weight_g``/``weight_v`` or ``parametrizations.weight.
original0/1``) and loads ``strict=True``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.wav2vec2_processor import Wav2Vec2Processor
from ..nn.core import get_activation, layer_norm, linear
from ..nn.transformer import TransformerEncoderLayer
from .hf_checkpoint import read_config, read_state_dict, resolve_model_dir
from .hubert import fold_weight_norm, group_norm_over_time

# HF's sublayer names inside encoder.layers.{i} -> the port's
_LAYER_NAMES = (("attention.", "self_attn."),
                ("layer_norm.", "self_attn_layer_norm."),
                ("feed_forward.intermediate_dense.", "fc1."),
                ("feed_forward.output_dense.", "fc2."))
_POS_CONV = "wav2vec2.encoder.pos_conv_embed.conv."
_WEIGHT_NORM = (("weight_g", "weight_v"),
                ("parametrizations.weight.original0",
                 "parametrizations.weight.original1"))


@dataclass(frozen=True)
class Wav2Vec2CTCConfig:
    """The inference fields of HF's ``Wav2Vec2Config``, with its
    defaults."""
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"
    feat_extract_activation: str = "gelu"
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    vocab_size: int = 32
    masked_spec_embed: bool = True

    @classmethod
    def from_hf(cls, cfg: dict) -> "Wav2Vec2CTCConfig":
        """From a ``config.json``; refuses what inference here does not
        compute (adapters)."""
        if cfg.get("add_adapter") or cfg.get("adapter_attn_dim"):
            raise NotImplementedError("wav2vec2 adapters are not ported")
        if cfg.get("layer_norm_eps", 1e-5) != 1e-5:
            raise NotImplementedError("a layer_norm_eps other than 1e-5 is "
                                      "not ported")
        if cfg.get("feat_extract_norm", "group") not in ("group", "layer"):
            raise ValueError(f"feat_extract_norm "
                             f"{cfg['feat_extract_norm']!r}")
        kw = {name: cfg[name] for name in cls.__dataclass_fields__
              if name in cfg}
        for name in ("conv_dim", "conv_kernel", "conv_stride"):
            if name in kw:
                kw[name] = tuple(int(v) for v in kw[name])
        kw["masked_spec_embed"] = (cfg.get("mask_time_prob", 0.05) > 0
                                   or cfg.get("mask_feature_prob", 0.0) > 0)
        return cls(**kw)

    def output_length(self, in_length):
        """``_get_feat_extract_output_lengths`` (:1073): frames after the
        convolutions, (L - k) // s + 1 a layer."""
        length = in_length
        for k, s in zip(self.conv_kernel, self.conv_stride):
            length = (length - k) // s + 1
        return length


def _rename(key: str, pairs) -> str:
    head, sep, rest = key.partition("wav2vec2.encoder.layers.")
    if not sep:
        return key
    index, _, sub = rest.partition(".")
    for old, new in pairs:
        if sub.startswith(old):
            sub = new + sub[len(old):]
            break
    return f"{head}{sep}{index}.{sub}"


def port_key(hf_key: str) -> str:
    """The port's ``state_dict`` name of an HF one."""
    return _rename(hf_key, _LAYER_NAMES)


def hf_key(port_key_: str) -> str:
    """The HF ``state_dict`` name of one of the port's."""
    return _rename(port_key_, [(p, h) for h, p in _LAYER_NAMES])


class _ConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2CTCConfig, i: int):
        super().__init__()
        c_in = cfg.conv_dim[i - 1] if i else 1
        c_out = cfg.conv_dim[i]
        self.conv = nn.Conv1d(c_in, c_out, cfg.conv_kernel[i],
                              stride=cfg.conv_stride[i], bias=cfg.conv_bias)
        if cfg.feat_extract_norm == "layer":
            self.layer_norm = nn.LayerNorm(c_out)
        elif i == 0:
            self.layer_norm = nn.GroupNorm(c_out, c_out)


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: Wav2Vec2CTCConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            _ConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2CTCConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1])
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)


class _PosConv(nn.Module):
    def __init__(self, cfg: Wav2Vec2CTCConfig):
        super().__init__()
        d, k = cfg.hidden_size, cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(d, d, k, padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)


class _Encoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2CTCConfig):
        super().__init__()
        d = cfg.hidden_size
        self.pos_conv_embed = _PosConv(cfg)
        self.layer_norm = nn.LayerNorm(d)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d, cfg.intermediate_size,
                                    cfg.num_attention_heads,
                                    normalize_before=cfg.do_stable_layer_norm,
                                    activation=cfg.hidden_act)
            for _ in range(cfg.num_hidden_layers))


class _Wav2Vec2Model(nn.Module):
    def __init__(self, cfg: Wav2Vec2CTCConfig):
        super().__init__()
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        if cfg.masked_spec_embed:
            # masks time steps in training only; kept for strict loading
            self.masked_spec_embed = nn.Parameter(
                torch.zeros(cfg.hidden_size))
        self.encoder = _Encoder(cfg)


class Wav2Vec2ForCTC(nn.Module):
    """(B, L) normalised waveform -> (B, T', vocab) CTC logits, fp32."""

    def __init__(self, cfg: Wav2Vec2CTCConfig):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2 = _Wav2Vec2Model(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def _features(self, wave: torch.Tensor) -> torch.Tensor:
        """The conv feature encoder: (B, L) -> (B, T', conv_dim[-1])."""
        cfg = self.cfg
        act = get_activation(cfg.feat_extract_activation)
        x = wave[:, None, :]
        for layer in self.wav2vec2.feature_extractor.conv_layers:
            conv = layer.conv
            x = F.conv1d(x, conv.weight, conv.bias, stride=conv.stride)
            if cfg.feat_extract_norm == "layer":
                ln = layer.layer_norm
                x = F.layer_norm(x.transpose(1, 2), (x.shape[1],),
                                 ln.weight, ln.bias, 1e-5).transpose(1, 2)
            elif hasattr(layer, "layer_norm"):
                x = group_norm_over_time(x, layer.layer_norm.weight,
                                         layer.layer_norm.bias)
            x = act(x)
        return x.transpose(1, 2)

    def _pos_conv(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.wav2vec2.encoder.pos_conv_embed.conv
        y = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                     padding=conv.padding, groups=conv.groups)
        if self.cfg.num_conv_pos_embeddings % 2 == 0:
            y = y[:, :, :-1]
        return get_activation(self.cfg.feat_extract_activation)(
            y).transpose(1, 2)

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        stable = self.cfg.do_stable_layer_norm
        proj = self.wav2vec2.feature_projection
        enc = self.wav2vec2.encoder
        x = self._features(wave)
        x = layer_norm(x, proj.layer_norm.weight, proj.layer_norm.bias)
        x = linear(x, proj.projection.weight, proj.projection.bias)
        x = x + self._pos_conv(x)
        if not stable:
            x = layer_norm(x, enc.layer_norm.weight, enc.layer_norm.bias)
        for layer in enc.layers:
            x = layer(x, None)
        if stable:
            x = layer_norm(x, enc.layer_norm.weight, enc.layer_norm.bias)
        return linear(x, self.lm_head.weight, self.lm_head.bias)


def port_state_dict(hf_sd: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """An HF ``state_dict`` in the port's names, ``pos_conv``'s weight norm
    folded (``weight_norm(dim=2)``)."""
    sd = dict(hf_sd)
    for g, v in _WEIGHT_NORM:
        if _POS_CONV + g in sd:
            sd[_POS_CONV + "weight"] = fold_weight_norm(
                sd.pop(_POS_CONV + g), sd.pop(_POS_CONV + v))
    return {port_key(k): t for k, t in sd.items()}


def load(model_path: str) -> Tuple[Wav2Vec2ForCTC, Wav2Vec2Processor]:
    """(the fp32 model on the CPU, its processor) from an HF directory or
    a hub id in the local cache. The weights are assigned, not copied: a
    memory-mapped ``pytorch_model.bin`` is read once, on ``.to(device)``."""
    root = resolve_model_dir(model_path)
    cfg = Wav2Vec2CTCConfig.from_hf(read_config(root))
    processor = Wav2Vec2Processor(str(root))
    with torch.device("meta"):
        model = Wav2Vec2ForCTC(cfg)
    model.load_state_dict(port_state_dict(read_state_dict(root)),
                          strict=True, assign=True)
    return model.eval(), processor


class Transcriber:
    """``transcriber(wave (T,) float32, sr) -> text``: the processor's
    features, the logits of one utterance (no attention mask), their
    argmax and the processor's decode, as JAX's transcriber runs them."""

    def __init__(self, model_path: str, device: torch.device):
        model, self.processor = load(model_path)
        self.model = model.to(device)
        self.device = device

    def __call__(self, wave: np.ndarray, sr: int) -> str:
        x = torch.from_numpy(self.processor.features(wave, sr))
        with torch.inference_mode():
            logits = self.model(x[None].to(self.device))
        return self.processor.decode(logits.argmax(dim=-1)[0].tolist())


__all__ = ["Wav2Vec2CTCConfig", "Wav2Vec2ForCTC", "Transcriber", "load",
           "hf_key", "port_key", "port_state_dict"]
