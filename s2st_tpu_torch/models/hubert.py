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

Training (``--task hubert_pretraining``, the trunks of
``models/wav2vec2.py`` and ``models/ctc_asr.py``) uses the same trunk with
what JAX's training paths add (:29-200, :336-465): the three dropouts of
``_encoder_layer`` (:182-200) and the one after ``encoder.layer_norm``,
``layer_norm_first`` (``encoder.layer_norm`` after the layers, :219-225),
``grad_mult`` (``feature_grad_mult``, ``models/wav2vec2.py:117-126``) and a
``conv_pos`` of either parity (only an even kernel's trailing frame is
trimmed, :176-177). ``HubertPretrainModel`` is JAX's ``init_hubert_pretrain``
tree with ``forward_pretrain`` (:381-465): fairseq's ``HubertModel`` names at
the root, ``mask_emb``, ``final_proj`` and ``label_embs_concat``, and the
``stats::num_updates`` counter JAX keeps (never advanced by its loss).

``load_torch_hubert`` reads a fairseq checkpoint (``{"model": state_dict,
"cfg": ...}``) through ``models/fairseq_checkpoint.py``'s reader, which
needs neither fairseq nor omegaconf: classes of modules that are not
installed unpickle as plain records, and the config is read from their
contents.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import dropout, layer_norm, lengths_to_padding_mask, linear
from ..nn.transformer import TransformerEncoderLayer
from .fairseq_checkpoint import plain, read_torch_checkpoint
from .jax_bridge import trunk_jax_rules

BASE_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 2, 2), (512, 2, 2))


@dataclass(frozen=True)
class HubertConfig:
    """``s2st_tpu.models.hubert.HubertConfig`` (hubert-base defaults).
    conv_layers: (dim, kernel, stride) a layer. The pretraining fields
    (:48-63) are read by the training paths only; ``extract_features``
    runs without dropout or masking whatever they say."""
    conv_layers: Tuple[Tuple[int, int, int], ...] = BASE_CONV_LAYERS
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16
    layer_norm_first: bool = False
    dtype: Any = torch.float32
    label_rate: float = 50
    sample_rate: int = 16000
    final_dim: int = 256
    logit_temp: float = 0.1
    num_classes: Tuple[int, ...] = ()
    untie_final_proj: bool = False
    skip_masked: bool = False
    skip_nomask: bool = False
    feature_grad_mult: float = 0.1
    mask_prob: float = 0.8
    mask_length: int = 10
    dropout_input: float = 0.1
    dropout_features: float = 0.1
    dropout: float = 0.1
    activation_dropout: float = 0.0

    @property
    def downsample(self) -> int:
        out = 1
        for _, _, s in self.conv_layers:
            out *= s
        return out

    @property
    def feat2tar_ratio(self) -> float:
        return self.label_rate * self.downsample / self.sample_rate

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


def grad_mult(x: torch.Tensor, c: float) -> torch.Tensor:
    """GradMultiply (``_grad_mult``, models/wav2vec2.py:117-126): x with
    its gradient times c, in JAX's arithmetic (x * c + detached x * (1 - c);
    x itself at c = 1, a detached x at c = 0)."""
    if c == 1.0:
        return x
    if c == 0.0:
        return x.detach()
    return x * c + x.detach() * (1.0 - c)


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
    def __init__(self, cfg: HubertConfig, rates: Sequence[float]):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.pos_conv = nn.Sequential(nn.Conv1d(
            d, d, cfg.conv_pos, padding=cfg.conv_pos // 2,
            groups=cfg.conv_pos_groups))
        self.layer_norm = nn.LayerNorm(d)
        drop, attn_drop, act_drop = rates
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d, cfg.encoder_ffn_embed_dim,
                                    cfg.encoder_attention_heads,
                                    normalize_before=False, activation="gelu",
                                    dropout_rate=drop,
                                    attention_dropout=attn_drop,
                                    activation_dropout=act_drop)
            for _ in range(cfg.encoder_layers))


class HubertModel(nn.Module):
    """fairseq ``HubertModel``'s inference trunk, (B, L) waveform in."""

    # JAX's leaf name for fairseq's label_embs_concat (models/jax_bridge.py)
    jax_names = {"label_embs_concat": ("label_embs", "same")}

    def __init__(self, cfg: HubertConfig,
                 rates: Optional[Sequence[float]] = None):
        """rates: the layers' (dropout, attention dropout, activation
        dropout), by default HuBERT's (``cfg.dropout``, 0,
        ``cfg.activation_dropout``: JAX's layer drops no attention
        probability, :182-200); they act only where a generator is
        given."""
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg.conv_layers)
        feat_dim = cfg.conv_layers[-1][0]
        self.layer_norm = nn.LayerNorm(feat_dim)
        self.post_extract_proj = nn.Linear(feat_dim, cfg.encoder_embed_dim)
        self.encoder = _Encoder(cfg, rates or (cfg.dropout, 0.0,
                                               cfg.activation_dropout))

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
                     groups=conv.groups)
        if self.cfg.conv_pos % 2 == 0:
            y = y[:, :, :-1]    # SamePad: an even kernel adds one frame
        return F.gelu(y).transpose(1, 2)

    def features(self, source: torch.Tensor, c: float) -> torch.Tensor:
        """The extractor's (B, T', C) features of a (B, L) waveform in the
        compute dtype, their gradient times c (``grad_mult``); at c = 0 the
        extractor runs without a graph."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and c != 0.0):
            return grad_mult(self._extract(source.to(self.cfg.dtype)), c)

    def post_extract(self, feats: torch.Tensor) -> torch.Tensor:
        """``layer_norm`` then ``post_extract_proj``."""
        x = layer_norm(feats, self.layer_norm.weight, self.layer_norm.bias)
        return linear(x, self.post_extract_proj.weight,
                      self.post_extract_proj.bias)

    def encode(self, x: torch.Tensor, padding_mask: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               input_dropout: float = 0.0,
               n_layers: Optional[int] = None) -> torch.Tensor:
        """The transformer over (B, T, D) inputs: padded frames zeroed,
        ``pos_conv`` added, ``encoder.layer_norm`` before the layers
        (post-LN trunk) or after them (``layer_norm_first``),
        ``input_dropout`` before the layers and each layer's dropouts with
        a generator.
        ``n_layers`` stops early, before the closing norm."""
        x = x.masked_fill(padding_mask[:, :, None], 0.0)
        x = x + self._pos_conv(x)
        enc_ln = self.encoder.layer_norm
        lnf = self.cfg.layer_norm_first
        if not lnf:
            x = layer_norm(x, enc_ln.weight, enc_ln.bias)
        x = dropout(x, input_dropout, generator)
        layers = self.encoder.layers
        for layer in layers if n_layers is None else layers[:n_layers]:
            x = layer(x, padding_mask, generator)
        if lnf and n_layers is None:
            x = layer_norm(x, enc_ln.weight, enc_ln.bias)
        return x

    def extract_features(self, source: torch.Tensor, lengths: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """source (B, L) waveform, lengths (B,) valid samples -> (features
        (B, T', encoder_embed_dim), out_lengths (B,) clipped to T').
        Padded frames are zeroed before ``pos_conv`` and masked as keys."""
        cfg = self.cfg
        x = self._extract(source.to(cfg.dtype))
        t_out = x.shape[1]
        out_lengths = cfg.output_length(lengths).clamp(0, t_out)
        padding_mask = lengths_to_padding_mask(out_lengths, t_out)
        return self.encode(self.post_extract(x), padding_mask), out_lengths

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
# SSL pretraining (HubertModel.forward, fairseq hubert.py:412-516)
# ---------------------------------------------------------------------------

class Counter(nn.Module):
    """The ``stats::num_updates`` int32 scalar of JAX's SSL and CTC trees,
    a buffer a model's ``load_stats`` writes."""

    jax_names = {"num_updates": ("stats::num_updates", "count")}

    def __init__(self):
        super().__init__()
        self.register_buffer("num_updates", torch.zeros((), dtype=torch.int32))


def cosine_logits(proj_x: torch.Tensor, target: torch.Tensor,
                  label_embs: torch.Tensor, logit_temp: float
                  ) -> torch.Tensor:
    """``_cosine_logits`` (:354-378): (B, T, 1 + V) fp32, column 0 the
    cosine of each frame with its target's codeword, columns 1.. with
    every codeword, all over ``logit_temp``, -inf where a negative is the
    positive. Norms as rsqrt(max(x . x, 1e-16)): a zero pad row keeps a
    finite gradient, where ``norm``'s is NaN."""
    x = proj_x.float()
    e = label_embs.float()
    xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True).clamp(min=1e-16))
    en = e * torch.rsqrt((e * e).sum(-1, keepdim=True).clamp(min=1e-16))
    sims = torch.einsum("btd,vd->btv", xn, en)
    tgt = target.long()[:, :, None]
    pos = sims.gather(2, tgt)
    neg_is_pos = torch.arange(sims.shape[2], device=sims.device) == tgt
    return torch.cat([pos / logit_temp, (sims / logit_temp).masked_fill(
        neg_is_pos, float("-inf"))], dim=2)


class HubertPretrainModel(HubertModel):
    """JAX's ``init_hubert_pretrain`` tree (:336-351): the trunk at the
    top level, ``mask_emb``, ``final_proj`` (``final_dim`` a label stream
    with ``untie_final_proj``) and ``label_embs_concat`` (JAX's
    ``label_embs``), and ``stats::num_updates``."""

    jax_names = {"mask_emb": ("params::mask_emb", "same"),
                 "label_embs_concat": ("params::label_embs", "same")}
    jax_rules = trunk_jax_rules()

    def __init__(self, cfg: HubertConfig):
        super().__init__(cfg)
        d = cfg.encoder_embed_dim
        n_lbl = max(len(cfg.num_classes), 1)
        self.mask_emb = nn.Parameter(torch.zeros(d))
        self.final_proj = nn.Linear(
            d, cfg.final_dim * (n_lbl if cfg.untie_final_proj else 1))
        self.label_embs_concat = nn.Parameter(
            torch.zeros(sum(cfg.num_classes), cfg.final_dim))
        self.stats = Counter()

    def load_stats(self, new_stats: Dict[str, Any]) -> None:
        self.stats.num_updates.copy_(new_stats["num_updates"])

    @torch.no_grad()
    def init_weights(self, seed) -> "HubertPretrainModel":
        """Seeded random init with ``init_hubert_pretrain``'s
        distributions: the trunk's, ``mask_emb`` and ``label_embs``
        uniform in [0, 1)."""
        g = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(seed)
        super().init_weights(g)
        for t in (self.mask_emb, self.label_embs_concat):
            t.copy_(torch.rand(t.shape, generator=g))
        return self

    def forward_pretrain(self, source: torch.Tensor, lengths: torch.Tensor,
                         target_list: Sequence[torch.Tensor],
                         train: bool = True,
                         generator: Optional[torch.Generator] = None,
                         mask_indices: Optional[torch.Tensor] = None
                         ) -> Dict[str, Any]:
        """``forward_pretrain`` (:381-465): source (B, L), lengths (B,),
        target_list (B, T_lbl) codeword indices a stream. Features trimmed
        so that every frame has a label, the labels picked as
        (arange * ratio) in fp32 truncated; a frame is padding when its
        chunk of L // T samples starts past the length (not
        ``output_length``). In training the span mask (min 2 spans) is
        drawn from ``generator`` unless ``mask_indices`` (B, T) is given,
        and the dropouts draw from it; without ``train`` nothing is masked
        unless ``mask_indices`` says so. Returns full-shape logits
        (B, T, 1 + V) a stream and the masks."""
        from .wav2vec2 import compute_span_mask
        cfg = self.cfg
        gen = generator if train else None
        feats = self.features(source, cfg.feature_grad_mult)
        t_feat = feats.shape[1]
        ratio = cfg.feat2tar_ratio
        targ_tsz = min(int(t.shape[1]) for t in target_list)
        feat_tsz = min(t_feat, int(targ_tsz / ratio)) \
            if ratio * t_feat > targ_tsz else t_feat
        feats = feats[:, :feat_tsz]
        inds = torch.from_numpy((np.arange(feat_tsz, dtype=np.float32)
                                 * np.float32(ratio)).astype(np.int64))
        target_list = [t[:, inds.to(t.device)] for t in target_list]
        k = max(source.shape[1] // feat_tsz, 1)
        padding_mask = torch.arange(feat_tsz, device=source.device)[None] \
            * k >= lengths[:, None]
        out_lengths = (~padding_mask).sum(1)
        features_pen = feats.float().pow(2).mean()

        x = dropout(self.post_extract(feats), cfg.dropout_input, gen)
        if mask_indices is None and cfg.mask_prob > 0 and train:
            mask_indices = compute_span_mask(
                out_lengths, feat_tsz, cfg.mask_prob, cfg.mask_length,
                min_masks=2, generator=generator)
        elif mask_indices is None:
            mask_indices = torch.zeros((x.shape[0], feat_tsz), dtype=torch.bool,
                                       device=x.device)
        x = torch.where(mask_indices[:, :, None],
                        self.mask_emb.to(x.dtype)[None, None, :], x)
        x = self.encode(x, padding_mask, gen, input_dropout=cfg.dropout)

        proj = linear(x, self.final_proj.weight, self.final_proj.bias)
        n_lbl = len(target_list)
        projs = proj.chunk(n_lbl, dim=-1) if cfg.untie_final_proj \
            else [proj] * n_lbl
        offs = np.cumsum([0] + list(cfg.num_classes))
        logits = [cosine_logits(projs[i], target_list[i],
                                self.label_embs_concat[offs[i]:offs[i + 1]],
                                cfg.logit_temp)
                  for i in range(n_lbl)]
        return {"logits": logits, "mask": mask_indices,
                "padding_mask": padding_mask, "features_pen": features_pen,
                "target_list": target_list}


# ---------------------------------------------------------------------------
# fairseq checkpoint import
# ---------------------------------------------------------------------------

def _model_cfg(state: Dict[str, Any]) -> Dict[str, Any]:
    cfg = plain(state.get("cfg"))
    if isinstance(cfg, dict) and isinstance(cfg.get("model"), dict):
        return cfg["model"]
    return {}


def conv_spec(spec) -> Tuple[Tuple[int, int, int], ...]:
    """fairseq's ``conv_feature_layers`` ("[(512,10,5)] + [(512,3,2)] *
    4", or a sequence of triples) as int triples, parsed without eval: int
    literals, lists, tuples, + and * only (``conv_spec_expr``,
    s2st_tpu/options.py:786-806)."""
    if not isinstance(spec, str):
        return tuple(tuple(int(v) for v in t) for t in spec)

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, (ast.List, ast.Tuple)):
            v = [ev(e) for e in node.elts]
            return v if isinstance(node, ast.List) else tuple(v)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            return ev(node.left) + ev(node.right)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
            return ev(node.left) * ev(node.right)
        raise ValueError(f"bad conv spec element: {ast.dump(node)}")
    return tuple(tuple(int(v) for v in t)
                 for t in ev(ast.parse(spec, mode="eval")))


def config_from_torch_ckpt(path: str,
                           state: Optional[Dict[str, Any]] = None
                           ) -> HubertConfig:
    """The frontend's config from a fairseq checkpoint's ``cfg.model``
    (``config_from_torch_ckpt``, :233-256); base's values where absent."""
    if state is None:
        state = read_torch_checkpoint(path)
    m = _model_cfg(state)
    return HubertConfig(
        conv_layers=conv_spec(m.get("conv_feature_layers", BASE_CONV_LAYERS)),
        encoder_layers=int(m.get("encoder_layers", 12)),
        encoder_embed_dim=int(m.get("encoder_embed_dim", 768)),
        encoder_ffn_embed_dim=int(m.get("encoder_ffn_embed_dim", 3072)),
        encoder_attention_heads=int(m.get("encoder_attention_heads", 12)),
        conv_pos=int(m.get("conv_pos", 128)),
        conv_pos_groups=int(m.get("conv_pos_groups", 16)),
        layer_norm_first=bool(m.get("layer_norm_first", False)))


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
           "pretraining_shapes", "grad_mult", "cosine_logits",
           "Counter", "HubertPretrainModel", "conv_spec"]
