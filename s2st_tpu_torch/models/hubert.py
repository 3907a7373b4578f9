"""The frozen HuBERT waveform frontend and the fairseq ``.pt`` reader.

Counterpart of ``s2st_tpu/models/hubert.py`` (:29-333), inference path only
(``extract_features``, :196-225): seven bias-free convolutions over the raw
waveform (x320 downsampling, GroupNorm(512, 512) after the first, exact erf
GELU) -> LayerNorm -> ``post_extract_proj`` -> the grouped ``pos_conv``
(k=128, 16 groups, the trailing frame of an even kernel trimmed) ->
``encoder.layer_norm`` -> post-LN transformer layers. The module tree carries
fairseq's ``state_dict`` names, so a fairseq checkpoint loads after the
``weight_g``/``weight_v`` fold of ``pos_conv``.

Types follow JAX's: the waveform is cast to the compute dtype before the
first convolution, and the GroupNorm takes its mean and variance in fp32,
rounds them to that dtype and normalises in it (``_group_norm``, :139-148);
its affine parameters are fp32, so from there on the frontend computes in
fp32 whatever the compute dtype, as JAX's promotion makes it do.

``frontend_config`` builds the frontend's config as JAX's ``encode`` does
(``s2st_tpu/models/s2st_transformer.py:321-329``): from the four width knobs
only, with base's conv spec and ``conv_pos``, whatever a loaded checkpoint's
config says. The trunk is always post-LN (``encoder.layer_norm`` before the
layers), as JAX's ``encode`` runs every checkpoint, pre-LN ones included.

``load_torch_hubert`` reads a fairseq checkpoint (``{"model": state_dict,
"cfg": ...}``) with ``torch.load`` and needs neither fairseq nor omegaconf:
classes of modules that are not installed unpickle as plain records, and
the config is read from their contents.
"""

from __future__ import annotations

import pickle
import types
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import layer_norm, lengths_to_padding_mask, linear
from ..nn.transformer import TransformerEncoderLayer

BASE_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 2, 2), (512, 2, 2))


@dataclass(frozen=True)
class HubertConfig:
    """The inference fields of ``s2st_tpu.models.hubert.HubertConfig``
    (hubert-base defaults). conv_layers: (dim, kernel, stride) a layer;
    conv_pos is even, as in every fairseq HuBERT config (``_pos_conv``
    trims the frame its even kernel adds)."""
    conv_layers: Tuple[Tuple[int, int, int], ...] = BASE_CONV_LAYERS
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.conv_pos % 2:
            raise ValueError(f"conv_pos {self.conv_pos} is odd")

    def output_length(self, in_length):
        """Frames after the extractor: (L - k) // s + 1 a layer (JAX's
        formula; an int or an integer tensor)."""
        length = in_length
        for _, k, s in self.conv_layers:
            length = (length - k) // s + 1
        return length


def frontend_config(cfg) -> HubertConfig:
    """The frontend of an ``S2STConfig`` with ``use_hubert``."""
    return HubertConfig(encoder_embed_dim=cfg.hubert_hidden,
                        encoder_layers=cfg.hubert_layers,
                        encoder_ffn_embed_dim=cfg.hubert_ffn,
                        encoder_attention_heads=cfg.hubert_heads,
                        dtype=cfg.dtype)


def group_norm_over_time(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-5
                         ) -> torch.Tensor:
    """GroupNorm(C, C) of x (B, C, T): each channel over every frame,
    padded ones included. Statistics in fp32, rounded to x's dtype; the
    normalisation in x's dtype; the fp32 affine returns fp32."""
    xf = x.float()
    mean = xf.mean(dim=2, keepdim=True).to(x.dtype)
    var = xf.var(dim=2, unbiased=False, keepdim=True).to(x.dtype)
    y = (x - mean) / torch.sqrt(var + eps)
    return y.float() * weight.float()[:, None] + bias.float()[:, None]


class _FeatureExtractor(nn.Module):
    def __init__(self, conv_layers):
        super().__init__()
        blocks, in_d = [], 1
        for i, (d, k, s) in enumerate(conv_layers):
            block = [nn.Conv1d(in_d, d, k, stride=s, bias=False),
                     nn.Dropout(0.0)]
            if i == 0:
                block.append(nn.GroupNorm(d, d))
            blocks.append(nn.Sequential(*block))
            in_d = d
        self.conv_layers = nn.ModuleList(blocks)


class _Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.pos_conv = nn.Sequential(nn.Conv1d(
            d, d, cfg.conv_pos, padding=cfg.conv_pos // 2,
            groups=cfg.conv_pos_groups))
        self.layer_norm = nn.LayerNorm(d)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d, cfg.encoder_ffn_embed_dim,
                                    cfg.encoder_attention_heads,
                                    normalize_before=False, activation="gelu")
            for _ in range(cfg.encoder_layers))


class HubertModel(nn.Module):
    """fairseq ``HubertModel``'s inference trunk, (B, L) waveform in."""

    # JAX's leaf name for fairseq's label_embs_concat (models/jax_bridge.py)
    jax_names = {"label_embs_concat": ("label_embs", "same")}

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg.conv_layers)
        feat_dim = cfg.conv_layers[-1][0]
        self.layer_norm = nn.LayerNorm(feat_dim)
        self.post_extract_proj = nn.Linear(feat_dim, cfg.encoder_embed_dim)
        self.encoder = _Encoder(cfg)

    def carry_pretraining(self, shapes: Dict[str, Tuple[int, ...]]) -> None:
        """Give the frontend the pretraining leaves a checkpoint holds
        ({fairseq name: shape} of ``mask_emb``, ``final_proj.weight``,
        ``final_proj.bias``, ``label_embs_concat``). ``extract_features``
        never reads them; JAX's ``load_torch_hubert`` keeps them in the
        frontend's parameters (:302-307), so they ride in its optimizer
        state and checkpoints, and the port's must hold the same keys."""
        if "mask_emb" in shapes:
            self.mask_emb = nn.Parameter(torch.zeros(shapes["mask_emb"]))
        if "final_proj.weight" in shapes:
            out_dim, dim = shapes["final_proj.weight"]
            self.final_proj = nn.Linear(dim, out_dim,
                                        bias="final_proj.bias" in shapes)
        if "label_embs_concat" in shapes:
            self.label_embs_concat = nn.Parameter(
                torch.zeros(shapes["label_embs_concat"]))

    def _extract(self, source: torch.Tensor) -> torch.Tensor:
        """(B, L) -> (B, T', C) (``_extractor``, :151-163)."""
        x = source[:, None, :]
        for i, block in enumerate(self.feature_extractor.conv_layers):
            conv = block[0]
            x = F.conv1d(x, conv.weight.to(x.dtype), stride=conv.stride)
            if i == 0:
                gn = block[2]
                x = group_norm_over_time(x, gn.weight, gn.bias)
            x = F.gelu(x)
        return x.transpose(1, 2)

    def _pos_conv(self, x: torch.Tensor) -> torch.Tensor:
        """Grouped conv positional embedding (``_pos_conv``, :166-179)."""
        conv = self.encoder.pos_conv[0]
        y = F.conv1d(x.transpose(1, 2), conv.weight.to(x.dtype),
                     conv.bias.to(x.dtype), padding=conv.padding,
                     groups=conv.groups)[:, :, :-1]
        return F.gelu(y).transpose(1, 2)

    def extract_features(self, source: torch.Tensor, lengths: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """source (B, L) waveform, lengths (B,) valid samples -> (features
        (B, T', encoder_embed_dim), out_lengths (B,) clipped to T').
        Padded frames are zeroed before ``pos_conv`` and masked as keys."""
        cfg = self.cfg
        x = self._extract(source.to(cfg.dtype))
        t_out = x.shape[1]
        out_lengths = cfg.output_length(lengths).clamp(0, t_out)
        x = layer_norm(x, self.layer_norm.weight, self.layer_norm.bias)
        x = linear(x, self.post_extract_proj.weight,
                   self.post_extract_proj.bias)
        padding_mask = lengths_to_padding_mask(out_lengths, t_out)
        x = x.masked_fill(padding_mask[:, :, None], 0.0)
        x = x + self._pos_conv(x)
        enc_ln = self.encoder.layer_norm
        x = layer_norm(x, enc_ln.weight, enc_ln.bias)
        for layer in self.encoder.layers:
            x = layer(x, padding_mask)
        return x, out_lengths

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "HubertModel":
        """Seeded random init with ``init_hubert``'s distributions
        (:87-132): normal weights scaled by fan_in^-0.5 (0.05 for
        ``pos_conv``), zero biases, unit norms."""
        def normal(t, scale):
            t.copy_(torch.randn(t.shape, generator=generator) * scale)

        for conv in (b[0] for b in self.feature_extractor.conv_layers):
            normal(conv.weight, (conv.in_channels
                                 * conv.kernel_size[0]) ** -0.5)
        pos = self.encoder.pos_conv[0]
        normal(pos.weight, 0.05)
        pos.bias.zero_()
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                normal(mod.weight, mod.in_features ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                mod.reset_parameters()
        return self


# ---------------------------------------------------------------------------
# fairseq checkpoint import
# ---------------------------------------------------------------------------

class _Absent:
    """Unpickles an instance of a class whose module is not installed
    (omegaconf's DictConfig and nodes, fairseq's dataclasses). Pickle may
    restore one without calling ``__init__``, hence the class defaults."""

    args: tuple = ()
    state: Any = None

    def __init__(self, *args, **kwargs):
        self.args, self.state = args, kwargs or None

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Absent,), {"__module__": module})


_pickle = types.ModuleType("s2st_tpu_torch_pickle")
_pickle.Unpickler = _Unpickler
_pickle.load = lambda f, **kw: _Unpickler(f, **kw).load()


def _plain(x):
    """Nested dicts and lists from a config that may hold unpickled
    omegaconf containers (``_content``) and value nodes (``_val``)."""
    if isinstance(x, _Absent):
        state = x.state
        if isinstance(state, tuple) and state and isinstance(state[-1], dict):
            state = state[-1]
        if isinstance(state, dict):
            if "_content" in state:
                return _plain(state["_content"])
            if "_val" in state:
                return _plain(state["_val"])
            return {k: _plain(v) for k, v in state.items()}
        return _plain(x.args[0]) if x.args else None
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def read_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A fairseq ``.pt`` as a dict, with or without omegaconf installed."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_pickle)


def _model_cfg(state: Dict[str, Any]) -> Dict[str, Any]:
    cfg = _plain(state.get("cfg"))
    if isinstance(cfg, dict) and isinstance(cfg.get("model"), dict):
        return cfg["model"]
    return {}


def _conv_spec(spec) -> Tuple[Tuple[int, int, int], ...]:
    """fairseq's ``conv_feature_layers`` string, e.g. "[(512,10,5)] +
    [(512,3,2)] * 4", evaluated as a list expression of int tuples."""
    if not isinstance(spec, str):
        return tuple(tuple(int(v) for v in t) for t in spec)
    value = eval(spec, {"__builtins__": {}}, {})   # noqa: S307 (list arithmetic)
    return tuple(tuple(int(v) for v in t) for t in value)


def config_from_torch_ckpt(path: str,
                           state: Optional[Dict[str, Any]] = None
                           ) -> HubertConfig:
    """The frontend's config from a fairseq checkpoint's ``cfg.model``
    (``config_from_torch_ckpt``, :233-256); base's values where absent."""
    if state is None:
        state = read_torch_checkpoint(path)
    m = _model_cfg(state)
    return HubertConfig(
        conv_layers=_conv_spec(m.get("conv_feature_layers", BASE_CONV_LAYERS)),
        encoder_layers=int(m.get("encoder_layers", 12)),
        encoder_embed_dim=int(m.get("encoder_embed_dim", 768)),
        encoder_ffn_embed_dim=int(m.get("encoder_ffn_embed_dim", 3072)),
        encoder_attention_heads=int(m.get("encoder_attention_heads", 12)),
        conv_pos=int(m.get("conv_pos", 128)),
        conv_pos_groups=int(m.get("conv_pos_groups", 16)))


def pretraining_shapes(tree: Dict[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """``carry_pretraining``'s shapes from a JAX ``params["hubert"]``
    subtree."""
    shapes = {}
    if "mask_emb" in tree:
        shapes["mask_emb"] = tuple(tree["mask_emb"].shape)
    if "final_proj" in tree:
        dim, out_dim = tree["final_proj"]["w"].shape
        shapes["final_proj.weight"] = (out_dim, dim)
        if "b" in tree["final_proj"]:
            shapes["final_proj.bias"] = (out_dim,)
    if "label_embs" in tree:
        shapes["label_embs_concat"] = tuple(tree["label_embs"].shape)
    return shapes


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``weight_norm(dim=2)``'s weight: g * v / ||v||, the norm over dims
    (0, 1) for each kernel tap."""
    norm = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    return g * v / norm.clamp(min=1e-12)


def load_torch_hubert(path: str, cfg: Optional[HubertConfig] = None
                      ) -> Tuple[Dict[str, torch.Tensor], HubertConfig]:
    """A fairseq HuBERT checkpoint -> (fp32 ``state_dict`` of
    ``HubertModel``, its config): the trunk's entries with ``pos_conv``'s
    weight norm folded and, in a pretraining checkpoint (one with
    ``mask_emb``), ``mask_emb``, ``final_proj`` and ``label_embs_concat``
    as JAX keeps them (:302-307; load them after ``carry_pretraining``)."""
    state = read_torch_checkpoint(path)
    if cfg is None:
        cfg = config_from_torch_ckpt(path, state)
    sd = state["model"] if "model" in state else state
    sd = {k: torch.as_tensor(v).detach().float() for k, v in sd.items()}
    pos = "encoder.pos_conv.0."
    if pos + "weight_g" in sd:
        sd[pos + "weight"] = fold_weight_norm(sd.pop(pos + "weight_g"),
                                              sd.pop(pos + "weight_v"))
    names = _trunk_names(cfg)
    if "mask_emb" in sd:
        names += [k for k in ("mask_emb", "final_proj.weight",
                              "final_proj.bias", "label_embs_concat")
                  if k in sd]
    missing = [k for k in names if k not in sd]
    if missing:
        raise KeyError(f"{path} lacks {missing[:4]}")
    return {k: sd[k].contiguous() for k in names}, cfg


def _trunk_names(cfg: HubertConfig):
    """The ``state_dict`` names of ``HubertModel(cfg)``, without building
    its tensors."""
    with torch.device("meta"):
        return list(HubertModel(cfg).state_dict())


__all__ = ["BASE_CONV_LAYERS", "HubertConfig", "HubertModel",
           "frontend_config", "group_norm_over_time", "config_from_torch_ckpt",
           "load_torch_hubert", "read_torch_checkpoint", "fold_weight_norm",
           "pretraining_shapes"]
