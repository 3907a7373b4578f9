"""The composite S2ST training loss.

Counterpart of ``s2st_tpu/train/losses.py`` (:29-117, :183-283): L1 + MSE
on the features before and after the postnet over valid frames, the EOS BCE
with a positive-class weight, the guided-attention loss, CTC over encoder
tap 0 and the label-smoothed CE of the aux ASR/ST decoders, each normalised
as JAX does. Every term is an fp32 scalar; the loss is a mean, and
``sample_size`` is the number of target frames (the trainer still divides
the gradients by it, as JAX's does).

CTC is JAX's (``optax.ctc_loss``) log-space recursion written out in
PyTorch, log(0) = -1e5 included, so a row whose labels cannot be aligned to
its frames gives optax's large finite value, where ``F.ctc_loss`` would give
inf (or 0 with ``zero_infinity``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.s2st_transformer import PAD

CTC_LOG_EPSILON = -1e5  # optax.ctc_loss's log(0)


@dataclass(frozen=True)
class LossConfig:
    """The fields of ``s2st_tpu.train.losses.LossConfig`` (:29-47) that
    ``s2st_loss`` reads."""
    bce_pos_weight: float = 5.0
    use_guided_attention_loss: bool = False
    guided_attention_loss_sigma: float = 0.4
    label_smoothing: float = 0.1
    ctc_weight: float = 0.0
    asr_ce_weight: float = 0.0
    st_ce_weight: float = 0.0
    l1_loss_weight: float = 1.0
    mse_loss_weight: float = 1.0
    eos_loss_weight: float = 1.0
    attn_loss_weight: float = 1.0
    sentence_avg: bool = False


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B, max_len) True at valid positions."""
    return torch.arange(max_len, device=lengths.device)[None, :] \
        < lengths[:, None]


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the elements where mask (broadcastable) is True."""
    mask = torch.broadcast_to(mask, x.shape)
    return torch.where(mask, x, torch.zeros_like(x)).sum() \
        / mask.sum().clamp(min=1)


def label_smoothed_nll_loss(lprobs: torch.Tensor, target: torch.Tensor,
                            epsilon: float, ignore_index: int = PAD
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum-reduced label-smoothed NLL (:57-71). lprobs (N, V) fp32
    log-probabilities, target (N,). Returns (loss, nll); the smoothing mass
    is spread over the V - 1 other classes."""
    nll = -lprobs.gather(-1, target[:, None].long())[:, 0]
    smooth = -lprobs.sum(dim=-1)
    keep = target != ignore_index
    nll_sum = torch.where(keep, nll, torch.zeros_like(nll)).sum()
    smooth_sum = torch.where(keep, smooth, torch.zeros_like(smooth)).sum()
    eps_i = epsilon / (lprobs.shape[-1] - 1)
    loss = (1.0 - epsilon - eps_i) * nll_sum + eps_i * smooth_sum
    return loss, nll_sum


def guided_attention_loss(attn: torch.Tensor, src_lens: torch.Tensor,
                          tgt_lens: torch.Tensor, sigma: float
                          ) -> torch.Tensor:
    """attn (B, Tt, Ts) fp32 cross-attention probabilities (:74-89)."""
    b, tt, ts = attn.shape
    dev = attn.device
    t_idx = torch.arange(tt, dtype=torch.float32, device=dev)[None, :, None]
    s_idx = torch.arange(ts, dtype=torch.float32, device=dev)[None, None, :]
    s_len = src_lens.float()[:, None, None]
    t_len = tgt_lens.float()[:, None, None]
    w = (s_idx / s_len - t_idx / t_len) ** 2
    weights = 1.0 - torch.exp(-w / (2.0 * sigma ** 2))
    mask = lengths_to_mask(tgt_lens, tt)[:, :, None] \
        & lengths_to_mask(src_lens, ts)[:, None, :]
    return masked_mean(weights * attn, mask)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float, mask: torch.Tensor) -> torch.Tensor:
    """``binary_cross_entropy_with_logits(pos_weight=w)``, masked mean
    (:92-98)."""
    loss = -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))
    return masked_mean(loss, mask)


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood (B,), optax.ctc_loss's
    recursion over blank and label alphas, with log(0) = -1e5. logits
    (B, T, V); labels (B, N) right-padded."""
    b, t_max, _ = logits.shape
    n = labels.shape[1]
    dev = logits.device
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    repeat = torch.zeros((b, n), device=dev)
    if n > 1:
        repeat[:, :-1] = (labels[:, :-1] == labels[:, 1:]).float()
    lp_phi = logprobs[:, :, blank_id].transpose(0, 1)[:, :, None]  # (T, B, 1)
    lp_emit = logprobs.gather(
        2, labels.long()[:, None, :].expand(b, t_max, n)).transpose(0, 1)
    pad = (torch.arange(t_max, device=dev)[:, None]
           >= logit_lengths[None, :]).float()[:, :, None]         # (T, B, 1)
    eps = CTC_LOG_EPSILON

    def add_phi(phi, score):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)],
                         dim=-1)

    phi = torch.full((b, n + 1), eps, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), eps, device=dev)
    for t in range(t_max):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, emit + eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[t],
                                    emit + lp_emit[t])
        next_phi = prev_phi + lp_phi[t]
        next_phi = add_phi(next_phi, emit + lp_phi[t] + eps * (1.0 - repeat))
        emit = pad[t] * emit + (1.0 - pad[t]) * next_emit
        phi = pad[t] * prev_phi_orig + (1.0 - pad[t]) * next_phi
    phi_last = add_phi(phi, emit)
    return -phi_last.gather(1, label_lengths.long()[:, None])[:, 0]


def _aux_ce(logits, target, epsilon, ntokens, weight):
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss_sum, _ = label_smoothed_nll_loss(lp.reshape(-1, lp.shape[-1]),
                                          target.reshape(-1), epsilon)
    keep = target != PAD
    n_correct = ((lp.argmax(dim=-1) == target) & keep).sum()
    return loss_sum / max(int(ntokens), 1) * weight, n_correct, keep.sum()


def composite_loss(net: Dict[str, Any], lcfg: LossConfig,
                   batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``_composite_loss`` (:183-283): (loss, {"new_stats", "logging",
    "sample_size"}) with JAX's logging keys."""
    tgt_feat = batch["tgt_speech"].float()
    tgt_lens = batch["target_lengths"]
    b, tt, _ = tgt_feat.shape
    frame_mask = lengths_to_mask(tgt_lens, tt)
    fmask3 = frame_mask[:, :, None]
    feat_out = net["feat_out"].float()
    post_feat_out = net["post_feat_out"].float()
    eos_out = net["eos_out"].float()[:, :, 0]
    eos_tgt = (torch.arange(tt, device=tgt_lens.device)[None, :]
               == (tgt_lens[:, None] - 1)).float()

    l1 = masked_mean((feat_out - tgt_feat).abs(), fmask3) \
        + masked_mean((post_feat_out - tgt_feat).abs(), fmask3)
    mse = masked_mean((feat_out - tgt_feat) ** 2, fmask3) \
        + masked_mean((post_feat_out - tgt_feat) ** 2, fmask3)
    eos = bce_with_logits(eos_out, eos_tgt, lcfg.bce_pos_weight, frame_mask)
    zero = torch.zeros((), device=feat_out.device)

    attn_loss = zero
    if lcfg.use_guided_attention_loss and net.get("attn") is not None:
        attn_loss = guided_attention_loss(
            net["attn"].float(), net["encoder_out_lengths"], tgt_lens,
            lcfg.guided_attention_loss_sigma)

    ctc = zero
    if lcfg.ctc_weight > 0.0 and "ctc_logits" in net:
        logit_lens = (~net["encoder_padding_mask"]).sum(dim=1)
        per_ex = ctc_loss(net["ctc_logits"], logit_lens, batch["src_text"],
                          batch["src_text_len"])
        # torch CTCLoss(reduction='mean'): per-example nll / label length,
        # then the batch mean
        per_ex = per_ex / batch["src_text_len"].float().clamp(min=1.0)
        ctc = per_ex.mean() * lcfg.ctc_weight

    logging: Dict[str, Any] = {}
    aux_asr = aux_st = zero
    if lcfg.asr_ce_weight > 0.0 and "asr_logits" in net:
        aux_asr, logging["asr_n_correct"], logging["asr_total"] = _aux_ce(
            net["asr_logits"], batch["src_text"], lcfg.label_smoothing,
            batch["src_txt_ntokens"], lcfg.asr_ce_weight)
    if lcfg.st_ce_weight > 0.0 and "st_logits" in net:
        aux_st, logging["st_n_correct"], logging["st_total"] = _aux_ce(
            net["st_logits"], batch["tgt_text"], lcfg.label_smoothing,
            batch["tgt_txt_ntokens"], lcfg.st_ce_weight)

    l1 = l1 * lcfg.l1_loss_weight
    mse = mse * lcfg.mse_loss_weight
    eos = eos * lcfg.eos_loss_weight
    attn_loss = attn_loss * lcfg.attn_loss_weight
    loss = l1 + mse + eos + attn_loss + ctc + aux_asr + aux_st
    ntokens = tgt_lens.sum()
    sample_size = torch.full_like(ntokens, b) if lcfg.sentence_avg \
        else ntokens
    logging.update({
        "loss": loss, "l1_loss": l1, "mse_loss": mse, "eos_loss": eos,
        "attn_loss": attn_loss, "ctc_loss": ctc, "ctc_loss_tgt": zero,
        "aux_asr_loss": aux_asr, "aux_st_loss": aux_st,
        "ntokens": ntokens, "nsentences": b, "sample_size": sample_size,
    })
    return loss, {"new_stats": net.get("new_stats"), "logging": logging,
                  "sample_size": sample_size}


def s2st_loss(model, lcfg: LossConfig, batch: Dict[str, Any],
              train: bool = True,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``s2st_loss`` (:101-114): the model's forward, then the composite
    loss. Dropout runs when a generator is given."""
    net = model(batch, train=train, generator=generator)
    return composite_loss(net, lcfg, batch)
