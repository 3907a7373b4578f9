"""wav2vec 2.0 self-supervised pretraining.

Counterpart of ``s2st_tpu/models/wav2vec2.py`` (:40-436), the full-length
(XLA) branch that JAX follows: every frame keeps its place, negatives are
drawn over each sample's whole time axis, the InfoNCE loss is weighted by
the span mask, and the Gumbel temperature anneals from the
``stats::num_updates`` counter the model carries.

- ``compute_span_mask`` (:128-158) is JAX's algorithm, not fairseq's: a
  number of spans ``int(mask_prob * len / mask_length + U)`` clipped to
  ``[min_masks, m_max]``, starts drawn uniformly WITH replacement over
  ``[0, len - mask_length)``, nothing masked on padding.
- ``gumbel_quantize`` (:161-190): per-group Gumbel-softmax with the
  straight-through estimator, both perplexities.
- ``sample_negatives`` (:193-224): the "draw from high - 1, bump >= t"
  trick, and cross-sample negatives over the flattened batch.
- ``compute_preds`` (:227-241): cosine logits over ``logit_temp``,
  duplicate negatives at -2^30.
- ``Wav2Vec2Model``: the HuBERT trunk (``models/hubert.py``) in fairseq's
  ``Wav2Vec2Model`` names at the root (JAX's ``params::trunk``) with
  ``mask_emb``, ``quantizer.weight_proj`` / ``quantizer.vars`` (JAX's
  ``quantizer::proj`` / ``vars``, (G * V, var_dim); fairseq's file holds a
  leading 1), ``project_q``, ``final_proj`` and ``stats::num_updates``.

The random draws (mask, negatives, Gumbel noise, dropouts) come from a
``torch.Generator``; each of the first three takes a given value instead,
so that tests can hand the port JAX's draws.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.core import dropout, layer_norm, lengths_to_padding_mask, linear
from . import hubert as hub
from .jax_bridge import trunk_jax_rules


@dataclass(frozen=True)
class Wav2Vec2Config:
    """wav2vec2 base defaults (``Wav2Vec2Config``, :39-70)."""
    trunk: hub.HubertConfig = dataclasses.field(
        default_factory=hub.HubertConfig)
    final_dim: int = 256
    logit_temp: float = 0.1
    quantize_targets: bool = True
    latent_vars: int = 320
    latent_groups: int = 2
    latent_dim: int = 0
    latent_temp: Tuple[float, float, float] = (2.0, 0.5, 0.999995)
    mask_prob: float = 0.65
    mask_length: int = 10
    mask_min_masks: int = 2
    num_negatives: int = 100
    cross_sample_negatives: int = 0
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    dropout_input: float = 0.1
    dropout_features: float = 0.1
    feature_grad_mult: float = 0.1
    dtype: Any = torch.float32

    @property
    def vq_dim(self) -> int:
        return self.latent_dim if self.latent_dim > 0 else self.final_dim

    @property
    def var_dim(self) -> int:
        assert self.vq_dim % self.latent_groups == 0
        return self.vq_dim // self.latent_groups


def compute_span_mask(lengths: torch.Tensor, max_len: int, mask_prob: float,
                      mask_length: int, min_masks: int = 2,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Static-shape span mask (B, max_len), False on padding
    (``compute_span_mask``, :128-158)."""
    b = lengths.shape[0]
    dev = lengths.device
    m_max = max(int(mask_prob * max_len / float(mask_length)) + 1, min_masks)
    sz = lengths.float()
    n_f = mask_prob * sz / float(mask_length) + torch.rand(
        b, generator=generator, device=dev)
    n = torch.floor(n_f).int().clamp(min_masks, m_max)
    lo_i = (lengths - mask_length).clamp(min=1).int()
    n = torch.minimum(n, lo_i)
    starts = torch.floor(torch.rand((b, m_max), generator=generator,
                                    device=dev)
                         * lo_i.float()[:, None]).int()
    active = torch.arange(m_max, device=dev)[None, :] < n[:, None]
    t = torch.arange(max_len, device=dev)[None, None, :]
    span = (t >= starts[:, :, None]) & (t < starts[:, :, None] + mask_length)
    mask = (span & active[:, :, None]).any(dim=1)
    return mask & (torch.arange(max_len, device=dev)[None, :]
                   < lengths[:, None])


class GumbelVectorQuantizer(nn.Module):
    """``quantizer``'s parameters: ``weight_proj`` (embed -> G * V) and
    ``vars`` (G * V, var_dim)."""

    def __init__(self, cfg: Wav2Vec2Config, embed: int):
        super().__init__()
        gv = cfg.latent_groups * cfg.latent_vars
        self.weight_proj = nn.Linear(embed, gv)
        self.vars = nn.Parameter(torch.zeros(gv, cfg.var_dim))


def gumbel_quantize(q: GumbelVectorQuantizer, cfg: Wav2Vec2Config,
                    x: torch.Tensor, temp: torch.Tensor, train: bool,
                    generator: Optional[torch.Generator] = None,
                    gumbel: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """``gumbel_quantize`` (:161-190): x (B, T, C) -> the quantized
    vectors (B, T, G * var_dim) in fp32, the code and probability
    perplexities and the hard codes. In training the codes are the argmax
    of softmax((logits + Gumbel noise) / temp) with the straight-through
    estimator; the noise (B * T, G, V) is drawn unless ``gumbel`` gives
    it."""
    b, t, _ = x.shape
    g_, v_ = cfg.latent_groups, cfg.latent_vars
    logits = linear(x, q.weight_proj.weight, q.weight_proj.bias) \
        .reshape(b * t, g_, v_).float()
    k = logits.argmax(dim=-1)
    hard = F.one_hot(k, v_).float()
    hard_probs = hard.mean(dim=0)
    code_ppl = torch.exp(-(hard_probs * torch.log(hard_probs + 1e-7))
                         .sum(-1)).sum()
    avg_probs = torch.softmax(logits, dim=-1).mean(dim=0)
    prob_ppl = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-7))
                         .sum(-1)).sum()
    if train:
        if gumbel is None:     # standard Gumbel draws, -log(-log(U))
            u = torch.rand(logits.shape, generator=generator,
                           device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp(
                min=torch.finfo(torch.float32).tiny)))
        y_soft = torch.softmax((logits + gumbel) / temp, dim=-1)
        y_hard = F.one_hot(y_soft.argmax(dim=-1), v_).float()
        codes = y_hard + y_soft - y_soft.detach()
    else:
        codes = hard
    vars_ = q.vars.reshape(g_, v_, cfg.var_dim).float()
    out = torch.einsum("ngv,gvd->ngd", codes, vars_)
    return {"x": out.reshape(b, t, g_ * cfg.var_dim),
            "code_perplexity": code_ppl, "prob_perplexity": prob_ppl,
            "num_vars": float(g_ * v_), "targets": k.reshape(b, t, g_)}


def _bumped(high: int, rows: int, t: int, n: int,
            generator: Optional[torch.Generator], device) -> torch.Tensor:
    """(rows, t, n) draws in [0, high - 1) with each anchor's own index
    skipped: a draw >= t moves up one."""
    idx = torch.randint(0, max(high - 1, 1), (rows, t * n),
                        generator=generator, device=device)
    tszs = torch.arange(t, device=device).repeat_interleave(n)[None, :]
    return torch.where(idx >= tszs, idx + 1, idx).reshape(rows, t, n)


def sample_negatives(y: torch.Tensor, n_negatives: int,
                     cross_sample_negatives: int = 0,
                     generator: Optional[torch.Generator] = None,
                     indices: Optional[Tuple[Optional[torch.Tensor],
                                             Optional[torch.Tensor]]] = None
                     ) -> torch.Tensor:
    """``sample_negatives`` (:193-224): y (B, T, C) -> (N, B, T, C).
    ``indices`` = (own (B, T, N) time indices, cross (B, T, Nc) indices
    into the flattened batch), each drawn where None."""
    b, t, c = y.shape
    own, cross = indices or (None, None)
    negs = []
    if n_negatives > 0:
        if own is None:
            own = _bumped(t, b, t, n_negatives, generator, y.device)
        rows = torch.arange(b, device=y.device)[:, None, None]
        negs.append(y[rows, own])
    if cross_sample_negatives > 0:
        if cross is None:
            cross = _bumped(b * t, b, t, cross_sample_negatives, generator,
                            y.device)
        negs.append(y.reshape(b * t, c)[cross.reshape(-1)]
                    .reshape(b, t, cross_sample_negatives, c))
    return torch.cat(negs, dim=2).permute(2, 0, 1, 3)


def compute_preds(cfg: Wav2Vec2Config, x: torch.Tensor, y: torch.Tensor,
                  negatives: torch.Tensor) -> torch.Tensor:
    """``compute_preds`` (:227-241): (N + 1, B, T) cosine logits over
    ``logit_temp``, row 0 the positive; a negative equal to the positive
    gets -2^30."""
    neg_is_pos = (y[None] == negatives).all(dim=-1)
    targets = torch.cat([y[None], negatives], dim=0)
    xf = x[None].float()
    tf = targets.float()
    num = (xf * tf).sum(-1)
    den = torch.linalg.vector_norm(xf, dim=-1) \
        * torch.linalg.vector_norm(tf, dim=-1)
    logits = num / den.clamp(min=1e-8) / cfg.logit_temp
    is_dup = torch.cat([torch.zeros_like(neg_is_pos[:1]), neg_is_pos], dim=0)
    return logits.masked_fill(is_dup, -(2.0 ** 30))


def current_temp(cfg: Wav2Vec2Config, num_updates: torch.Tensor
                 ) -> torch.Tensor:
    """max(max_temp * decay^n, min_temp) in fp32, as exp(n log(decay))
    (:265-270)."""
    mx, mn, decay = cfg.latent_temp
    n = num_updates.float()
    log_decay = torch.log(torch.tensor(decay, dtype=torch.float32,
                                       device=n.device))
    return (mx * torch.exp(n * log_decay)).clamp(min=mn)


class Wav2Vec2Model(hub.HubertModel):
    """JAX's ``init_wav2vec2`` tree (:77-110) in fairseq's names; the
    trunk's layers drop at ``dropout`` / ``attention_dropout`` /
    ``activation_dropout`` of the wav2vec2 config."""

    jax_names = {"mask_emb": ("params::mask_emb", "same")}
    jax_rules = trunk_jax_rules("trunk") + [
        (r"^quantizer\.weight_proj$", "quantizer::proj")]

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__(cfg.trunk, (cfg.dropout, cfg.attention_dropout,
                                     cfg.activation_dropout))
        self.w2v_cfg = cfg
        d = cfg.trunk.encoder_embed_dim
        embed = cfg.trunk.conv_layers[-1][0]
        self.mask_emb = nn.Parameter(torch.zeros(d))
        if cfg.quantize_targets:
            self.quantizer = GumbelVectorQuantizer(cfg, embed)
            self.project_q = nn.Linear(cfg.vq_dim, cfg.final_dim)
        else:
            self.quantizer = None
            self.project_q = nn.Linear(embed, cfg.final_dim)
        self.final_proj = nn.Linear(d, cfg.final_dim)
        self.stats = hub.Counter()

    def load_stats(self, new_stats: Dict[str, Any]) -> None:
        self.stats.num_updates.copy_(new_stats["num_updates"])

    @torch.no_grad()
    def init_weights(self, seed) -> "Wav2Vec2Model":
        """Seeded random init with ``init_wav2vec2``'s distributions: the
        trunk's, ``mask_emb`` and the codebook uniform in [0, 1), the
        quantizer's projection N(0, 1) with a zero bias, ``project_q`` and
        ``final_proj`` N(0, fan_in^-0.5)."""
        g = seed if isinstance(seed, torch.Generator) \
            else torch.Generator().manual_seed(seed)
        super().init_weights(g)
        self.mask_emb.copy_(torch.rand(self.mask_emb.shape, generator=g))
        if self.quantizer is not None:
            w = self.quantizer.weight_proj.weight
            w.copy_(torch.randn(w.shape, generator=g))
            self.quantizer.vars.copy_(
                torch.rand(self.quantizer.vars.shape, generator=g))
        return self

    def forward_pretrain(self, source: torch.Tensor, lengths: torch.Tensor,
                         train: bool = True,
                         generator: Optional[torch.Generator] = None,
                         mask: Optional[torch.Tensor] = None,
                         negatives: Optional[Tuple] = None,
                         gumbel: Optional[torch.Tensor] = None
                         ) -> Dict[str, Any]:
        """``forward_pretrain`` (:276-345): source (B, L), lengths (B,).
        ``features_pen`` over every position before the LayerNorm; the
        span mask and the negatives drawn in eval too (from
        ``generator``), the dropouts and the Gumbel noise in training
        only; ``mask`` (B, T'), ``negatives`` (``sample_negatives``'
        indices) and ``gumbel`` replace the draws. Returns logits
        (N + 1, B, T'), mask and padding (B, T'), the penalties and the
        quantizer's diagnostics."""
        cfg = self.w2v_cfg
        gen = generator if train else None
        feats = self.features(source, cfg.feature_grad_mult)
        features_pen = feats.float().pow(2).mean()
        feats = layer_norm(feats, self.layer_norm.weight,
                           self.layer_norm.bias)
        t_out = feats.shape[1]
        out_lengths = self.cfg.output_length(lengths).clamp(0, t_out)
        padding_mask = lengths_to_padding_mask(out_lengths, t_out)
        x = linear(feats, self.post_extract_proj.weight,
                   self.post_extract_proj.bias)
        x = dropout(x, cfg.dropout_input, gen)
        unmasked = dropout(feats, cfg.dropout_features, gen)
        if mask is None:
            mask = compute_span_mask(
                out_lengths, t_out, cfg.mask_prob, cfg.mask_length,
                cfg.mask_min_masks, generator) if cfg.mask_prob > 0 else \
                torch.zeros((x.shape[0], t_out), dtype=torch.bool,
                            device=x.device)
        x = torch.where(mask[:, :, None], self.mask_emb.to(x.dtype), x)
        x = self.encode(x, padding_mask, gen)

        temp = current_temp(cfg, self.stats.num_updates)
        out: Dict[str, Any] = {}
        if self.quantizer is not None:
            q = gumbel_quantize(self.quantizer, cfg, unmasked, temp, train,
                                generator, gumbel)
            y = linear(q["x"], self.project_q.weight, self.project_q.bias)
            out["prob_perplexity"] = q["prob_perplexity"]
            out["code_perplexity"] = q["code_perplexity"]
            num_vars = q["num_vars"]
        else:
            y = linear(unmasked.float(), self.project_q.weight,
                       self.project_q.bias)
            num_vars = 0.0
        negs = sample_negatives(y, cfg.num_negatives,
                                cfg.cross_sample_negatives, generator,
                                negatives)
        x = linear(x, self.final_proj.weight, self.final_proj.bias).float()
        out.update(logits=compute_preds(cfg, x, y, negs), mask=mask,
                   padding_mask=padding_mask, features_pen=features_pen,
                   temp=temp, num_vars=num_vars)
        return out


def config_from_torch_ckpt(path: str,
                           state: Optional[Dict[str, Any]] = None
                           ) -> Wav2Vec2Config:
    """A fairseq wav2vec2 checkpoint's ``cfg.model`` (``config_from_torch
    _ckpt``, :365-399): the trunk as the HuBERT reader reads it."""
    if state is None:
        state = hub.read_torch_checkpoint(path)
    mc = hub._model_cfg(state)
    temp = mc.get("latent_temp", (2.0, 0.5, 0.999995))
    if isinstance(temp, str):
        temp = ast.literal_eval(temp)
    return Wav2Vec2Config(
        trunk=hub.config_from_torch_ckpt(path, state),
        final_dim=int(mc.get("final_dim", 256)),
        logit_temp=float(mc.get("logit_temp", 0.1)),
        quantize_targets=bool(mc.get("quantize_targets", False)),
        latent_vars=int(mc.get("latent_vars", 320)),
        latent_groups=int(mc.get("latent_groups", 2)),
        latent_dim=int(mc.get("latent_dim", 0)),
        latent_temp=tuple(temp),
        mask_prob=float(mc.get("mask_prob", 0.65)),
        mask_length=int(mc.get("mask_length", 10)),
        num_negatives=int(mc.get("num_negatives", 100)),
        cross_sample_negatives=int(mc.get("cross_sample_negatives", 0)),
        dropout=float(mc.get("dropout", 0.1)),
        attention_dropout=float(mc.get("attention_dropout", 0.1)),
        activation_dropout=float(mc.get("activation_dropout", 0.0)),
        dropout_input=float(mc.get("dropout_input", 0.1)),
        dropout_features=float(mc.get("dropout_features", 0.1)),
        feature_grad_mult=float(mc.get("feature_grad_mult", 1.0)))


def load_torch_wav2vec2(path: str, cfg: Optional[Wav2Vec2Config] = None
                        ) -> Tuple[Dict[str, torch.Tensor], Wav2Vec2Config]:
    """A fairseq wav2vec2 pretraining checkpoint -> (``state_dict`` of
    ``Wav2Vec2Model(cfg)``, cfg) (``load_torch_wav2vec2``, :402-436):
    the trunk through the HuBERT reader (``pos_conv``'s weight norm
    folded), ``mask_emb``, the quantizer (``vars`` without fairseq's
    leading 1), ``project_q``, ``final_proj`` and a zero update count."""
    state = hub.read_torch_checkpoint(path)
    if cfg is None:
        cfg = config_from_torch_ckpt(path, state)
    trunk, _ = hub.load_torch_hubert(path, cfg.trunk)
    sd = state["model"] if "model" in state else state
    sd = {k: torch.as_tensor(v).detach().float() for k, v in sd.items()}
    out = {k: v for k, v in trunk.items()
           if k not in ("final_proj.weight", "final_proj.bias")}
    out["mask_emb"] = sd["mask_emb"]
    if "quantizer.vars" in sd:
        out["quantizer.vars"] = sd["quantizer.vars"][0]
        for k in ("weight", "bias"):
            out[f"quantizer.weight_proj.{k}"] = sd[f"quantizer.weight_proj.{k}"]
    for name in ("project_q", "final_proj"):
        for k in ("weight", "bias"):
            out[f"{name}.{k}"] = sd[f"{name}.{k}"]
    out["stats.num_updates"] = torch.zeros((), dtype=torch.int32)
    return {k: v.contiguous() for k, v in out.items()}, cfg


__all__ = ["Wav2Vec2Config", "Wav2Vec2Model", "GumbelVectorQuantizer",
           "compute_span_mask", "gumbel_quantize",
           "sample_negatives", "compute_preds", "current_temp",
           "config_from_torch_ckpt", "load_torch_wav2vec2"]
