"""Autoregressive spectrogram generation.

Counterpart of ``s2st_tpu/generate/speech_generator.py``: the encoder once
per batch, then one decoder step at a time with per-layer KV caches and
precomputed cross-attention K/V, sigmoid(eos) > threshold per row, the
postnet residual over the whole sequence, GCMVN denormalisation and frame
unpacking. JAX runs the steps in a ``lax.while_loop`` that stops once every
row has finished; here they run in a Python loop that asks the device
whether all rows have finished only every few steps, and then zeroes every
frame after the step at which the JAX loop stops, so the output is the
same (the postnet reads two frames past each valid end).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.s2st_transformer import PAD, S2STTransformer
from ..nn.attention import cross_attn_precompute, self_attn_cache_init
from ..nn.transformer import (decoder_layer_step_fused,
                              fuse_decoder_layer_params, position_at_step)

# decode steps between checks that every row has finished (each check
# waits for the device)
_FINISH_CHECK_EVERY = 8


@dataclass(frozen=True)
class GenerationConfig:
    max_iter: int = 1500            # decode steps at the packed frame rate
    eos_prob_threshold: float = 0.5
    prenet_dropout_at_inference: bool = True  # the reference's always-on


def decode_loop(model: S2STTransformer, gen_cfg: GenerationConfig,
                enc: Dict[str, Any], speaker=None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, int]:
    """The AR loop (JAX ``_decode_loop``, speech_generator.py:53).
    Returns (feats (B, T, out_dim) fp32, eos_prob (B, T), attn (B, T, Ts),
    out_lens (B,), steps run); frames at and after max(out_lens) are 0."""
    cfg = model.cfg
    dec = model.decoder
    enc_out = enc["encoder_out"]
    b, ts = enc_out.shape[:2]
    dev = enc_out.device
    heads = cfg.decoder_attention_heads
    max_iter = gen_cfg.max_iter
    # the matmul weights in the compute dtype once for the whole loop: a
    # no-op for a model cast for inference, one cast instead of one a step
    # for a training model's fp32 parameters; norms stay fp32
    fused = [{k: v if "_ln_" in k else v.to(cfg.dtype)
              for k, v in fuse_decoder_layer_params(layer).items()}
             for layer in dec.transformer_layers]
    cross_kv = [cross_attn_precompute(layer.encoder_attn, enc_out)
                for layer in dec.transformer_layers]
    caches = [self_attn_cache_init(b, max_iter, heads,
                                   cfg.decoder_embed_dim // heads, cfg.dtype,
                                   dev)
              for _ in dec.transformer_layers]
    enc_pad = enc["encoder_padding_mask"]
    last = len(fused) - 1
    drop_gen = generator if gen_cfg.prenet_dropout_at_inference else None

    prev = torch.zeros((b, 1, cfg.out_dim), dtype=cfg.dtype, device=dev)
    if speaker is not None and dec.embed_speaker is not None:
        prev = dec.embed_speaker.weight.to(cfg.dtype)[
            speaker.reshape(-1)][:, None, :]
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    out_lens = torch.full((b,), max_iter, dtype=torch.long, device=dev)
    feats = torch.zeros((b, max_iter, cfg.out_dim), dtype=cfg.dtype,
                        device=dev)
    eos_prob = torch.zeros((b, max_iter), dtype=torch.float32, device=dev)
    attn = torch.zeros((b, max_iter, ts), dtype=torch.float32, device=dev)
    alpha = dec.pos_emb_alpha.to(cfg.dtype)

    steps = 0
    for step in range(max_iter):
        x = dec.prenet_in(prev, drop_gen)
        x = x + alpha * position_at_step(dec.pos_table, step, PAD, x.dtype)
        for i, lp in enumerate(fused):
            x, _, w = decoder_layer_step_fused(
                lp, x, caches[i], step, cross_kv[i], enc_pad, heads,
                normalize_before=cfg.decoder_normalize_before,
                activation=cfg.activation_fn,
                need_attn=i == last)
            if w is not None:
                attn[:, step] = w.mean(dim=1)[:, 0, :]
        feat, eos_logit = dec.heads(x)                        # (B, 1, out)
        eos_p = torch.sigmoid(eos_logit.float()[:, 0, 0])
        cur = eos_p > gen_cfg.eos_prob_threshold
        out_lens = torch.where(~finished & cur,
                               torch.full_like(out_lens, step + 1), out_lens)
        finished = finished | cur
        feats[:, step] = feat[:, 0]
        eos_prob[:, step] = eos_p
        prev = feat
        steps = step + 1
        if steps % _FINISH_CHECK_EVERY == 0 and bool(finished.all()):
            break
    if bool(finished.all()):
        # the JAX loop stops after the step where the last row finished
        stop = int(out_lens.max())
        feats[:, stop:] = 0
        eos_prob[:, stop:] = 0
        attn[:, stop:] = 0
    return feats.float(), eos_prob, attn, out_lens, steps


def postprocess(model: S2STTransformer, feats: torch.Tensor,
                eos_prob: torch.Tensor, out_lens: torch.Tensor,
                gcmvn_mean=None, gcmvn_std=None) -> Dict[str, torch.Tensor]:
    """Postnet residual over the whole sequence, unpack the frames,
    GCMVN-denormalise (speech_generator.py:195-218)."""
    cfg = model.cfg
    feats = feats + model.decoder.postnet(feats.to(cfg.dtype)).float()
    b = feats.shape[0]
    r = cfg.n_frames_per_step
    feats = feats.reshape(b, -1, cfg.output_frame_dim)
    if gcmvn_mean is not None:
        feats = feats * torch.as_tensor(gcmvn_std, device=feats.device) \
            + torch.as_tensor(gcmvn_mean, device=feats.device)
    return {"feats": feats, "raw_out_lens": out_lens * r,
            "out_lens": out_lens,
            "eos_prob": eos_prob.repeat_interleave(r, dim=1)}


def generate_from_encoder_out(model: S2STTransformer,
                              gen_cfg: GenerationConfig, enc: Dict[str, Any],
                              speaker=None, generator=None, gcmvn_mean=None,
                              gcmvn_std=None) -> Dict[str, torch.Tensor]:
    feats, eos_prob, attn, out_lens, _ = decode_loop(model, gen_cfg, enc,
                                                     speaker, generator)
    out = postprocess(model, feats, eos_prob, out_lens, gcmvn_mean,
                      gcmvn_std)
    out["attn"] = attn
    out["enc_lens"] = enc["out_lengths"]
    return out


@torch.no_grad()
def generate_features(model: S2STTransformer, gen_cfg: GenerationConfig,
                      src_speech: torch.Tensor, src_speech_lens: torch.Tensor,
                      speaker=None, generator=None, gcmvn_mean=None,
                      gcmvn_std=None) -> Dict[str, torch.Tensor]:
    """fbank -> encoder -> AR decode -> postnet -> denorm -> unpacked mel
    frames. Returns feats (B, max_iter*r, raw_dim) fp32, raw_out_lens,
    out_lens, eos_prob (B, max_iter*r), attn (B, max_iter, Ts), enc_lens."""
    enc = model.encode(src_speech, src_speech_lens, speaker)
    return generate_from_encoder_out(model, gen_cfg, enc, speaker, generator,
                                     gcmvn_mean, gcmvn_std)


@torch.no_grad()
def teacher_forcing_features(model: S2STTransformer,
                             batch: Dict[str, torch.Tensor],
                             gcmvn_mean=None, gcmvn_std=None,
                             generator=None) -> Dict[str, torch.Tensor]:
    """Full teacher-forced forward, lengths from the target
    (speech_generator.py:221)."""
    cfg = model.cfg
    speaker = batch.get("speaker")
    enc = model.encode(batch["src_speech"], batch["src_speech_lens"], speaker)
    out = model.decode(batch["prev_output_tokens"], batch["target_lengths"],
                       enc, speaker, generator)
    b = out["post_feat_out"].shape[0]
    r = cfg.n_frames_per_step
    feats = out["post_feat_out"].float().reshape(b, -1, cfg.output_frame_dim)
    if gcmvn_mean is not None:
        feats = feats * torch.as_tensor(gcmvn_std, device=feats.device) \
            + torch.as_tensor(gcmvn_mean, device=feats.device)
    eos_prob = torch.sigmoid(out["eos_out"].float())[:, :, 0]
    lens = batch["target_lengths"]
    return {"feats": feats, "raw_out_lens": lens * r, "out_lens": lens,
            "eos_prob": eos_prob.repeat_interleave(r, dim=1),
            "attn": out["attn"]}
