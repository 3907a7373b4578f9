"""The training losses: the composite S2ST loss, the T2S and Tacotron2
losses, the S2T CE and the FastSpeech2 loss.

Counterpart of ``s2st_tpu/train/losses.py`` (:29-182, :183-283,
:299-318, :1216-1286): L1 + MSE
on the features before and after the postnet over valid frames, the EOS BCE
with a positive-class weight, the guided-attention loss, CTC over encoder
tap 0, the MTL target CTC over the first decoder tap and the
label-smoothed CE of the aux ASR/ST decoders, each normalised as JAX does;
``t2s_loss`` and ``tacotron2_loss`` are the spectrogram terms on the T2S
and Tacotron2 models' forwards; ``fastspeech2_loss`` is its own. Every
term is an fp32 scalar; the loss is a mean, and
``sample_size`` is the number of target frames (the trainer still divides
the gradients by it, as JAX's does).

CTC is JAX's (``optax.ctc_loss``) log-space recursion written out in
PyTorch, log(0) = -1e5 included, so a row whose labels cannot be aligned to
its frames gives optax's large finite value, where ``F.ctc_loss`` would give
inf (or 0 with ``zero_infinity``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

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
    ctc_weight_tgt: float = 0.0
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
    "sample_size", "mean_keys"}) with JAX's logging keys."""
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

    ctc_tgt = zero
    if lcfg.ctc_weight_tgt > 0.0 and "ctc_tgt_logits" in net:
        # the MTL target CTC over the first decoder tap (:226-240): its
        # logits' lengths are the target frame lengths
        per_ex = ctc_loss(net["ctc_tgt_logits"], tgt_lens, batch["tgt_text"],
                          batch["tgt_text_len"])
        per_ex = per_ex / batch["tgt_text_len"].float().clamp(min=1.0)
        ctc_tgt = per_ex.mean() * lcfg.ctc_weight_tgt

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
    loss = l1 + mse + eos + attn_loss + ctc + ctc_tgt + aux_asr + aux_st
    ntokens = tgt_lens.sum()
    sample_size = torch.full_like(ntokens, b) if lcfg.sentence_avg \
        else ntokens
    logging.update({
        "loss": loss, "l1_loss": l1, "mse_loss": mse, "eos_loss": eos,
        "attn_loss": attn_loss, "ctc_loss": ctc, "ctc_loss_tgt": ctc_tgt,
        "aux_asr_loss": aux_asr, "aux_st_loss": aux_st,
        "ntokens": ntokens, "nsentences": b, "sample_size": sample_size,
    })
    return loss, {"new_stats": net.get("new_stats"), "logging": logging,
                  "sample_size": sample_size, "mean_keys": MEAN_KEYS}


def s2st_loss(model, lcfg: LossConfig, batch: Dict[str, Any],
              train: bool = True,
              generator: Optional[torch.Generator] = None,
              layer_keep: Optional[Sequence[bool]] = None
              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``s2st_loss`` (:101-114): the model's forward, then the composite
    loss. Dropout runs when a generator is given; ``layer_keep`` is the
    encoder's LayerDrop decision for each layer."""
    net = model(batch, train=train, generator=generator,
                layer_keep=layer_keep)
    return composite_loss(net, lcfg, batch)


def t2s_loss(model, lcfg: LossConfig, batch: Dict[str, Any],
             train: bool = True,
             generator: Optional[torch.Generator] = None,
             layer_keep: Optional[Sequence[bool]] = None
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``t2s_loss`` (:120-131): the T2S model's forward over ``src_text``,
    then the composite loss, whose CTC and aux terms find no logits; the
    new statistics are the text encoder's and the postnet's."""
    net = model(batch, train=train, generator=generator,
                layer_keep=layer_keep)
    return composite_loss(net, lcfg, batch)


def s2t_loss(model, lcfg: LossConfig, batch: Dict[str, Any],
             train: bool = True,
             generator: Optional[torch.Generator] = None,
             layer_keep: Optional[Sequence[bool]] = None,
             test_type: str = "st") -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``s2t_loss`` (:132-182) of the S2T model: the label-smoothed CE,
    summed over the target tokens, of the target text (``st``) or the
    source text (``asr``) teacher-forced from its shifted tokens.
    ``sample_size`` is the batch's count of those tokens (its rows under
    ``sentence_avg``), by which the trainer divides the gradients; the
    logged ``loss`` and ``nll_loss`` are per token, the means over a
    batch."""
    side = "src" if test_type == "asr" else "tgt"
    tgt = batch[f"{side}_text"]
    ntokens = batch[f"{side}_txt_ntokens"]
    net = model(batch, batch[f"prev_{side}_text_tokens"], train=train,
                generator=generator, layer_keep=layer_keep)
    lp = torch.log_softmax(net["logits"].float(), dim=-1)
    loss_sum, nll_sum = label_smoothed_nll_loss(
        lp.reshape(-1, lp.shape[-1]), tgt.reshape(-1), lcfg.label_smoothing)
    keep = tgt != PAD
    denom = max(float(ntokens), 1.0)
    dev = lp.device
    sample_size = torch.tensor(tgt.shape[0] if lcfg.sentence_avg
                               else int(ntokens), device=dev)
    logging = {
        "loss": loss_sum / denom, "nll_loss": nll_sum / denom,
        "n_correct": ((lp.argmax(dim=-1) == tgt) & keep).sum(),
        "total": keep.sum(), "ntokens": float(ntokens),
        "nsentences": tgt.shape[0], "sample_size": sample_size,
    }
    return loss_sum, {"new_stats": net["new_stats"], "logging": logging,
                      "sample_size": sample_size,
                      "mean_keys": ("loss", "nll_loss")}


def tacotron2_loss(model, lcfg: LossConfig, batch: Dict[str, Any],
                   train: bool = True,
                   generator: Optional[torch.Generator] = None,
                   layer_keep: Optional[Sequence[bool]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``tacotron2_loss`` (:299-318): the Tacotron2 model's teacher-forced
    forward, then the composite loss on its attention transposed to (B,
    Tt, Ts), guided attention included; the new statistics are the
    encoder's BatchNorms' and the postnet's."""
    net = model(batch, train=train, generator=generator,
                layer_keep=layer_keep)
    net["attn"] = net["attn"].transpose(1, 2)
    return composite_loss(net, lcfg, batch)


def fastspeech2_loss(model, lcfg: LossConfig, batch: Dict[str, Any],
                     train: bool = True,
                     generator: Optional[torch.Generator] = None,
                     layer_keep: Optional[Sequence[bool]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``fastspeech2_loss`` (:1216-1286): the teacher-forced FastSpeech2
    pass at the batch's padded target length; masked-mean L1 on the
    features (and on the postnet's, with one), MSE on pitch and energy and
    on log(duration + 1) over source positions, and with ``ctc_weight``
    the CTC of the source tokens (PAD positions as 0) against the frame
    logits over each row's target frames. ``sample_size`` is the number of
    rows."""
    tgt = batch["tgt_speech"]
    b, tt, _ = tgt.shape
    ts = batch["src_text"].shape[1]
    net = model(batch["src_text"], batch["src_text_len"],
                speaker=batch.get("speaker"), durations=batch["durations"],
                pitches=batch["pitches"], energies=batch["energies"],
                max_out_len=tt, train=train, generator=generator)
    tgt_mask = lengths_to_mask(batch["target_lengths"], tt)[:, :, None]
    src_mask = lengths_to_mask(batch["src_text_len"], ts)
    feat = tgt.float()
    l1 = masked_mean((net["feat_out"].float() - feat).abs(), tgt_mask)
    if model.cfg.add_postnet:
        l1 = l1 + masked_mean((net["post_feat_out"].float() - feat).abs(),
                              tgt_mask)
    pitch = masked_mean((net["pitch_out"].float()
                         - batch["pitches"].float()) ** 2, src_mask)
    energy = masked_mean((net["energy_out"].float()
                          - batch["energies"].float()) ** 2, src_mask)
    log_dur = torch.log(batch["durations"].float() + 1.0)
    dur = masked_mean((net["log_dur_out"].float() - log_dur) ** 2, src_mask)
    ctc = torch.zeros((), device=feat.device)
    if lcfg.ctc_weight > 0.0 and "ctc_logits" in net:
        labels = torch.where(src_mask, batch["src_text"],
                             torch.zeros_like(batch["src_text"]))
        per_ex = ctc_loss(net["ctc_logits"], batch["target_lengths"],
                          labels, batch["src_text_len"])
        per_ex = per_ex / batch["src_text_len"].float().clamp(min=1.0)
        ctc = per_ex.mean() * lcfg.ctc_weight
    loss = l1 + dur + pitch + energy + ctc
    sample_size = torch.tensor(b, device=feat.device)
    logging = {"loss": loss, "l1_loss": l1, "dur_loss": dur,
               "pitch_loss": pitch, "energy_loss": energy, "ctc_loss": ctc,
               "ntokens": batch["target_lengths"].sum(), "nsentences": b,
               "sample_size": sample_size}
    return loss, {"new_stats": net["new_stats"], "logging": logging,
                  "sample_size": sample_size, "mean_keys": FS2_MEAN_KEYS}


# the logging values that are means over a batch (:291-294): a gradient
# accumulation sums every value over its microbatches, then divides these
# by their number
MEAN_KEYS = ("loss", "l1_loss", "mse_loss", "eos_loss", "attn_loss",
             "ctc_loss", "ctc_loss_tgt", "aux_asr_loss", "aux_st_loss")
FS2_MEAN_KEYS = ("loss", "l1_loss", "dur_loss", "pitch_loss", "energy_loss",
                 "ctc_loss")


# ---------------------------------------------------------------------------
# the self-supervised and CTC fine-tuning criteria (losses.py:1294-1560)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Wav2VecLossConfig:
    """``Wav2VecLossConfig`` (:1294-1303): --loss-weights is
    (prob_ppl_weight, features_pen_weight)."""
    infonce: bool = True
    prob_ppl_weight: float = 0.1
    features_pen_weight: float = 10.0


def wav2vec_loss(model, lcfg: Wav2VecLossConfig, batch: Dict[str, Any],
                 train: bool = True,
                 generator: Optional[torch.Generator] = None,
                 layer_keep: Optional[Sequence[bool]] = None,
                 **forward_kw) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``wav2vec_loss`` (:1305-1354): InfoNCE over (1 positive + N
    negatives) at every frame, weighted by the span mask on non-padded
    frames; the probability-perplexity and feature penalties times
    ``sample_size``; ``n_correct`` / ``total``. The update count the
    Gumbel temperature reads comes back one higher as ``new_stats`` in
    training. ``forward_kw`` (mask, negatives, gumbel) go to the
    forward."""
    num_updates = model.stats.num_updates
    net = model.forward_pretrain(batch["source"], batch["source_lens"],
                                 train=train, generator=generator,
                                 **forward_kw)
    logits = net["logits"]
    w = (net["mask"] & ~net["padding_mask"]).float()
    lp = torch.log_softmax(logits, dim=0)
    main_loss = -(lp[0] * w).sum()
    sample_size = w.sum()
    loss = main_loss
    logging: Dict[str, Any] = {"loss": main_loss}
    if "prob_perplexity" in net and lcfg.prob_ppl_weight != 0.0:
        ppl_pen = (net["num_vars"] - net["prob_perplexity"]) / net["num_vars"]
        ppl_term = lcfg.prob_ppl_weight * ppl_pen * sample_size
        loss = loss + ppl_term
        logging.update(prob_ppl_loss=ppl_term,
                       prob_perplexity=net["prob_perplexity"],
                       code_perplexity=net["code_perplexity"],
                       temp=net["temp"])
    if lcfg.features_pen_weight != 0.0:
        pen_term = lcfg.features_pen_weight * net["features_pen"] \
            * sample_size
        loss = loss + pen_term
        logging["features_pen"] = pen_term
    logging.update(n_correct=((logits.argmax(dim=0) == 0).float() * w).sum(),
                   total=sample_size, ntokens=sample_size,
                   nsentences=batch["source"].shape[0],
                   sample_size=sample_size)
    new_stats = {"num_updates": num_updates + 1} if train else {}
    return loss, {"new_stats": new_stats, "logging": logging,
                  "sample_size": sample_size,
                  "mean_keys": ("prob_perplexity", "code_perplexity", "temp")}


@dataclass(frozen=True)
class HubertLossConfig:
    """``HubertLossConfig`` (:1362-1370)."""
    pred_masked_weight: float = 1.0
    pred_nomask_weight: float = 0.0
    features_pen_weight: float = 10.0


def hubert_loss(model, lcfg: HubertLossConfig, batch: Dict[str, Any],
                train: bool = True,
                generator: Optional[torch.Generator] = None,
                layer_keep: Optional[Sequence[bool]] = None,
                mask_indices: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``hubert_loss`` (:1382-1427): for the masked and the unmasked
    frames (each branch on unless its weight is 0 or the model skips it)
    the sum-reduced cross entropy of every label stream with the positive
    at column 0; ``sample_size`` counts each branch's frames once, not
    once a stream; the features penalty times ``sample_size``; the
    ``correct_*`` / ``count_*`` meters (argmax at 0 but not also argmin
    at 0). The update count is not advanced (``new_stats`` empty)."""
    cfg = model.cfg
    targets = batch["target_list"]
    net = model.forward_pretrain(batch["source"], batch["source_lens"],
                                 [targets[i] for i in range(len(targets))],
                                 train=train, generator=generator,
                                 mask_indices=mask_indices)
    pad = net["padding_mask"]
    w_m = (net["mask"] & ~pad).float()
    w_u = (~net["mask"] & ~pad).float()
    loss = torch.zeros((), device=w_m.device)
    sample_size = torch.zeros((), device=w_m.device)
    logging: Dict[str, Any] = {}
    for branch, w, wt in (("m", w_m, lcfg.pred_masked_weight),
                          ("u", w_u, lcfg.pred_nomask_weight)):
        if wt <= 0 or (branch == "m" and cfg.skip_masked) or \
                (branch == "u" and cfg.skip_nomask):
            continue
        n = w.sum()
        for i, lg in enumerate(net["logits"]):
            li = -(torch.log_softmax(lg.float(), dim=-1)[:, :, 0] * w).sum()
            logging[f"loss_{branch}_{i}"] = li
            loss = loss + wt * li
            amax = lg.argmax(dim=-1) == 0
            amin = lg.argmin(dim=-1) == 0
            logging[f"correct_{branch}_{i}"] = (
                (amax & ~(amax & amin)).float() * w).sum()
            logging[f"count_{branch}_{i}"] = n
        sample_size = sample_size + n
    if lcfg.features_pen_weight != 0.0:
        pen = lcfg.features_pen_weight * net["features_pen"] * sample_size
        loss = loss + pen
        logging["loss_features_pen"] = pen
    logging.update(loss=loss, ntokens=sample_size,
                   nsentences=batch["source"].shape[0],
                   sample_size=sample_size)
    return loss, {"new_stats": {}, "logging": logging,
                  "sample_size": sample_size, "mean_keys": ()}


@dataclass(frozen=True)
class CtcLossConfig:
    """``CtcLossConfig`` (:1435-1445): blank is the dictionary's
    ``bos_index``, ``sep_idx`` its "|" (-1: no word separator)."""
    zero_infinity: bool = True
    sentence_avg: bool = False
    pad_idx: int = 1
    eos_idx: int = 2
    blank_idx: int = 0
    sep_idx: int = -1


def levenshtein_unit(x: torch.Tensor, xlen: torch.Tensor, y: torch.Tensor,
                     ylen: torch.Tensor) -> torch.Tensor:
    """Batched unit-cost edit distance (``_levenshtein_unit``,
    :1447-1469): one row of the table a token of x, its insertions by a
    running minimum along the row; read at (xlen, ylen)."""
    b, lx = x.shape
    ly = y.shape[1]
    j_idx = torch.arange(ly + 1, device=x.device)
    row = j_idx.expand(b, ly + 1)
    rows = [row]
    for i in range(lx):
        neq = (x[:, i:i + 1] != y).long()
        c_tail = torch.minimum(row[:, 1:] + 1, row[:, :-1] + neq)
        c = torch.cat([torch.full((b, 1), i + 1, device=x.device,
                                  dtype=c_tail.dtype), c_tail], dim=1)
        row = j_idx + torch.cummin(c - j_idx, dim=1).values
        rows.append(row)
    table = torch.stack(rows, dim=0)                       # (Lx + 1, B, Ly + 1)
    r = table.gather(0, xlen.long()[None, :, None].expand(1, b, ly + 1))[0]
    return r.gather(1, ylen.long()[:, None])[:, 0]


def pack_words(toks: torch.Tensor, n: torch.Tensor, sep: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_pack_words`` (:1472-1501): each "|"-separated non-empty word of
    a (B, L) unit row as JAX's rolling 32-bit hash (h * 1000003 + unit +
    1 mod 2^32, in int64 masked to 32 bits, then read as int32, as JAX
    casts its uint32), left-packed, with the word counts."""
    b, l = toks.shape
    t_idx = torch.arange(l, device=toks.device)[None, :]
    is_sep = (toks == sep) | ~(t_idx < n[:, None])
    h = torch.zeros(b, dtype=torch.long, device=toks.device)
    hs = []
    for j in range(l):
        h = torch.where(is_sep[:, j], torch.zeros_like(h),
                        (h * 1000003 + toks[:, j].long() + 1) & 0xFFFFFFFF)
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    nxt_sep = torch.cat([is_sep[:, 1:], torch.ones_like(is_sep[:, :1])],
                        dim=1)
    word_end = ~is_sep & nxt_sep
    pos = word_end.long().cumsum(dim=1) - 1
    nw = word_end.sum(dim=1)
    out = torch.zeros_like(hs).scatter_(
        1, torch.where(word_end, pos, torch.full_like(pos, l - 1)),
        torch.where(word_end, hs, torch.zeros_like(hs)))
    out = torch.where(t_idx < nw[:, None], out, torch.zeros_like(out))
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out), nw


def ctc_criterion(model, lcfg: CtcLossConfig, batch: Dict[str, Any],
                  train: bool = True,
                  generator: Optional[torch.Generator] = None,
                  layer_keep: Optional[Sequence[bool]] = None,
                  **forward_kw) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The ``ctc`` criterion (``ctc_loss``, :1504-1560): the blank weight
    on the training path too; ``ctc_loss`` (optax's recursion, log(0) =
    -1e5) over the non-pad, non-EOS targets, summed, non-finite rows
    zeroed under ``zero_infinity`` and rows of ``source_lens`` 0 zeroed;
    ``sample_size`` the target units (the real rows under
    ``sentence_avg``). In eval, the greedy decode's ``c_errors`` /
    ``c_total`` and, with a word separator, ``w_errors`` (= ``wv_errors``)
    / ``w_total``. In training the update count comes back one higher as
    ``new_stats``, so that the freeze lifts after
    ``freeze_finetune_updates`` updates (JAX's returns it unchanged and
    its freeze never lifts: ROADMAP §3). ``forward_kw`` (mask,
    channel_mask) go to the forward."""
    from ..models.ctc_asr import blank_weighted, greedy_ctc_decode
    num_updates = model.stats.num_updates
    net = model.forward_ctc(batch["source"], batch["source_lens"],
                            train=train, generator=generator, **forward_kw)
    logits = blank_weighted(net["logits"], model.cfg, lcfg.blank_idx)
    in_lens = (~net["padding_mask"]).sum(dim=1)
    target = batch["target"]
    keep = (target != lcfg.pad_idx) & (target != lcfg.eos_idx)
    tgt_lens = keep.sum(dim=1)
    tgt = torch.where(keep, target, torch.zeros_like(target))
    per_ex = ctc_loss(logits, in_lens, tgt, tgt_lens, lcfg.blank_idx)
    if lcfg.zero_infinity:
        per_ex = torch.where(torch.isfinite(per_ex), per_ex,
                             torch.zeros_like(per_ex))
    real = (batch["source_lens"] > 0).float()
    loss = (per_ex * real).sum()
    ntokens = (tgt_lens * real).sum()
    nsentences = real.sum()
    sample_size = nsentences if lcfg.sentence_avg else ntokens
    logging: Dict[str, Any] = {"loss": loss, "ntokens": ntokens,
                               "nsentences": nsentences,
                               "sample_size": sample_size}
    if not train:
        toks, n = greedy_ctc_decode(logits, in_lens, lcfg.blank_idx)
        logging["c_errors"] = (levenshtein_unit(toks, n, tgt, tgt_lens)
                               * real).sum()
        logging["c_total"] = ntokens
        if lcfg.sep_idx >= 0:
            hw, nw = pack_words(toks, n, lcfg.sep_idx)
            tw, ntw = pack_words(tgt, tgt_lens, lcfg.sep_idx)
            logging["w_errors"] = (levenshtein_unit(hw, nw, tw, ntw)
                                   * real).sum()
            logging["wv_errors"] = logging["w_errors"]
            logging["w_total"] = (ntw * real).sum()
    new_stats = {"num_updates": num_updates + 1} if train else {}
    return loss, {"new_stats": new_stats, "logging": logging,
                  "sample_size": sample_size, "mean_keys": ()}
