"""Beam search through a step-function interface.

Counterpart of ``s2st_tpu/generate/sequence_generator.py``: ``BeamConfig``
(:37-72) and ``beam_search_aux`` with ``step_fns`` (:289-617) for the
``beam`` strategy, with ``_fill_finished_slots`` (:80-112), ``_step_beam``
(:115-119), the length penalty (:239-240) and the n-gram ban (:243-280).
The semantics are fairseq's SequenceGenerator as the JAX loop reproduces
them:

- position 0 of every hypothesis is the bos (EOS) token; step 0 expands the
  first beam only (the others start at -1e9);
- pad is never emitted; EOS is banned while step < ``min_len`` and, with
  per-sentence bounds, while step < a * src_len + b; at step >= the
  per-sentence max length every continuation but EOS is banned;
- each step takes the top 2K of (alive score + log-prob) over K x V; an
  EOS among the first K candidates finishes a hypothesis with score / (step
  + 1) ** lenpen, filling the sentence's free finished slots in arrival
  order (a full sentence is done and frozen); the top K non-EOS candidates
  stay alive;
- when the loop reaches ``max_len`` the alive hypotheses are finished with a
  scored EOS, into the free slots only; the output is each sentence's
  finished hypotheses by score.

JAX runs the loop as a ``while_loop`` over a worst-case static ``max_len``
(``cli/generate.py:141-150``). This loop is eager and stops once every
sentence is done, or at ``max_len``; a sentence that is done never changes
again, so the output is the same. Top-k takes the lower index among equal
scores, as ``jax.lax.top_k`` does. Sampling, diverse search, constraints,
prefixes and ensembles are not ported: ``BeamConfig`` refuses them.

The aux text decoders of the S2ST model decode through the same loop:
``_aux_step`` (:215-236) is the step function and ``beam_search_aux``
(:289-617) sets it up (the tap and pad mask tiled to B*K, the cross K/V of
each layer projected once, a self-attention cache of ``max_len + 1``
positions for each layer). ``score_sequences`` (:630-672) is the
teacher-forced SequenceScorer and ``ctc_argmax_decode`` (:675-689) the
best-path CTC decode.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.attention import cross_attn_precompute, self_attn_cache_init
from ..nn.core import layer_norm, linear, scaled
from ..nn.transformer import decoder_layer_step_fused, \
    fuse_decoder_layer_params

PAD, EOS = 1, 2
NEG_INF = -1e9

StepFn = Callable[[torch.Tensor, int, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclass(frozen=True)
class BeamConfig:
    beam: int = 5
    max_len: int = 200
    min_len: int = 1            # EOS banned while step < min_len
    len_penalty: float = 1.0
    no_repeat_ngram_size: int = 0
    strategy: str = "beam"
    # per-sentence max length a * src_len + b, on when max_len_b >= 0
    max_len_a: float = 0.0
    max_len_b: float = -1.0
    # per-sentence min length a * src_len + b, on when min_len_b >= 0
    min_len_a: float = 0.0
    min_len_b: float = -1.0
    eos: int = 2

    def __post_init__(self):
        if self.strategy != "beam":
            raise NotImplementedError(f"search strategy {self.strategy!r} is "
                                      "not ported; only 'beam'")
        if self.no_repeat_ngram_size == 1:
            raise ValueError("--no-repeat-ngram-size must be 0 or >= 2")


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k along the last axis, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, ...) gathered along axis 1 by idx (B, N)."""
    shape = idx.shape + x.shape[2:]
    view = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, view)


def _fill_finished_slots(fin, cand_scores, cand_tokens, cand_pos, length,
                         k):
    """Append EOS candidates (best first) to the free finished slots of each
    sentence; slots fill in arrival order and are never replaced.
    fin: dict of scores (B, K), tokens (B, K, L), lens (B, K), flags (B, K),
    pos (B, K, L); cand_scores (B, C) with NEG_INF for non-candidates."""
    filled = fin["flags"].sum(dim=1)
    take = min(k, cand_scores.shape[1])
    cs, ci = _top_k(cand_scores, take)
    ct, cp = _gather_rows(cand_tokens, ci), _gather_rows(cand_pos, ci)
    r = torch.arange(k, device=cs.device)[None, :] - filled[:, None]
    in_range = (r >= 0) & (r < take)
    rc = r.clamp(0, take - 1)
    new_score = torch.gather(cs, 1, rc)
    valid = in_range & (new_score > NEG_INF / 2)
    return {
        "scores": torch.where(valid, new_score, fin["scores"]),
        "tokens": torch.where(valid[:, :, None], _gather_rows(ct, rc),
                              fin["tokens"]),
        "lens": torch.where(valid, torch.full_like(fin["lens"], length),
                            fin["lens"]),
        "flags": fin["flags"] | valid,
        "pos": torch.where(valid[:, :, None], _gather_rows(cp, rc),
                           fin["pos"]),
    }


def _length_penalty(length: int, alpha: float, device) -> torch.Tensor:
    return torch.tensor(float(length), device=device) ** alpha


def _ngram_ban_mask(tokens: torch.Tensor, t: int, vocab: int, n: int
                    ) -> torch.Tensor:
    """(B, K, V) additive mask banning every token that would repeat an
    n-gram of the prefix tokens[:, :, :t+1] (position 0 = bos): a token v is
    banned at step t+1 if [tokens[t-n+2..t], v] already occurs."""
    m = n - 1
    if t + 1 < n:
        return torch.zeros(tokens.shape[:2] + (vocab,), device=tokens.device)
    prefix = tokens[:, :, :t + 1]
    ctx = prefix[:, :, t - m + 1:t + 1]                      # (B, K, m)
    j = t - m + 1                      # n-grams start at 0 .. t - m
    match = torch.ones(prefix.shape[:2] + (j,), dtype=torch.bool,
                       device=tokens.device)
    for i in range(m):
        match &= prefix[:, :, i:i + j] == ctx[:, :, i:i + 1]
    nxt = prefix[:, :, m:m + j]                              # tokens[j+m]
    banned = torch.zeros(prefix.shape[:2] + (vocab,), device=tokens.device)
    banned.scatter_reduce_(2, nxt, match.float(), reduce="amax")
    return torch.where(banned > 0, NEG_INF, 0.0)


@torch.no_grad()
def beam_search(step_fn: StepFn, cache: Dict[str, torch.Tensor], b: int,
                vocab: int, cfg: BeamConfig, device: torch.device,
                src_lengths: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Beam-decode ``b`` sentences on ``device``.

    step_fn(tokens (B*K, 1), step, cache) -> (log-probs fp32 (B*K, V), new
    cache); every cache tensor leads with B*K rows, sentence-major, and is
    reordered with the surviving beams. src_lengths (B,) is needed for the
    per-sentence length bounds.

    Returns tokens (B, K, max_len + 2) (position 0 = bos), scores (B, K)
    normalised, lengths (B, K) counting the final EOS, pos_scores (B, K,
    max_len + 2) (the step's log-prob at positions 1..length) and steps,
    the number of model steps taken."""
    k, max_len, eos, dev = cfg.beam, cfg.max_len, cfg.eos, device
    width = max_len + 2
    tokens0 = torch.full((b, k, width), PAD, dtype=torch.long, device=dev)
    tokens0[:, :, 0] = eos
    alive_scores = torch.full((b, k), NEG_INF, device=dev)
    alive_scores[:, 0] = 0.0
    min_lens = max_lens = None
    if cfg.min_len_b >= 0 or cfg.max_len_b >= 0:
        if src_lengths is None:
            raise ValueError("length-constrained search needs src_lengths")
        sl = src_lengths.to(dev, torch.float32)
        if cfg.min_len_b >= 0:
            min_lens = cfg.min_len_a * sl + cfg.min_len_b
        if cfg.max_len_b >= 0:
            max_lens = cfg.max_len_a * sl + cfg.max_len_b
    alive_tokens = tokens0
    alive_pos = torch.zeros((b, k, width), device=dev)
    fin = {"scores": torch.full((b, k), NEG_INF, device=dev),
           "tokens": tokens0.clone(),
           "lens": torch.zeros((b, k), dtype=torch.long, device=dev),
           "flags": torch.zeros((b, k), dtype=torch.bool, device=dev),
           "pos": torch.zeros((b, k, width), device=dev)}
    write = torch.zeros(width, dtype=torch.bool, device=dev)
    row_base = (torch.arange(b, device=dev) * k)[:, None]
    t = 0
    while t < max_len and not bool(fin["flags"].all()):
        last = alive_tokens.view(b * k, width)[:, t:t + 1]
        lprobs, cache = step_fn(last, t, cache)
        lprobs = lprobs.view(b, k, vocab).clone()
        lprobs[:, :, PAD] = NEG_INF
        if t < cfg.min_len:
            lprobs[:, :, eos] += NEG_INF
        if min_lens is not None:
            lprobs[:, :, eos] += torch.where(t < min_lens, NEG_INF,
                                             0.0)[:, None]
        if max_lens is not None:
            forced = torch.full_like(lprobs, NEG_INF)
            forced[:, :, eos] = 0.0
            lprobs = torch.where((t >= max_lens)[:, None, None], forced,
                                 lprobs)
        if cfg.no_repeat_ngram_size > 0:
            lprobs = lprobs + _ngram_ban_mask(alive_tokens, t, vocab,
                                              cfg.no_repeat_ngram_size)

        cand = alive_scores[:, :, None] + lprobs
        top_scores, top_idx = _top_k(cand.view(b, k * vocab), 2 * k)
        tok, beam_idx = top_idx % vocab, top_idx // vocab
        write.zero_()
        write[t + 1] = True
        cand_tokens = torch.where(write, tok[:, :, None],
                                  _gather_rows(alive_tokens, beam_idx))
        prev_cum = torch.gather(alive_scores, 1, beam_idx)
        cand_pos = torch.where(write, (top_scores - prev_cum)[:, :, None],
                               _gather_rows(alive_pos, beam_idx))

        is_eos = tok == eos
        norm = top_scores / _length_penalty(t + 1, cfg.len_penalty, dev)
        first_k = torch.arange(2 * k, device=dev)[None, :] < k
        eos_scores = torch.where(is_eos & first_k, norm, NEG_INF)
        fin = _fill_finished_slots(fin, eos_scores, cand_tokens, cand_pos,
                                   t + 1, k)

        alive_scores, alive_sel = _top_k(
            torch.where(is_eos, NEG_INF, top_scores), k)
        sel_beam = torch.gather(beam_idx, 1, alive_sel)
        alive_tokens = _gather_rows(cand_tokens, alive_sel)
        alive_pos = _gather_rows(cand_pos, alive_sel)
        keep = (row_base + sel_beam).view(-1)
        cache = {name: x.index_select(0, keep) for name, x in cache.items()}
        t += 1

    steps = t
    if not bool(fin["flags"].all()):
        # finish the alive hypotheses with a scored EOS (fairseq's last step
        # restricted to EOS at max_len) into the free slots
        last = alive_tokens.view(b * k, width)[:, t:t + 1]
        final_lp, _ = step_fn(last, t, cache)
        steps += 1
        eos_lp = final_lp.view(b, k, vocab)[:, :, eos]
        norm = (alive_scores + eos_lp) / _length_penalty(
            t + 1, cfg.len_penalty, dev)
        alive_tokens = alive_tokens.clone()
        alive_tokens[:, :, t + 1] = eos
        alive_pos = alive_pos.clone()
        alive_pos[:, :, t + 1] = eos_lp
        fin = _fill_finished_slots(fin, norm, alive_tokens, alive_pos,
                                   t + 1, k)
    top, idx = _top_k(fin["scores"], k)
    return {"tokens": _gather_rows(fin["tokens"], idx), "scores": top,
            "lengths": torch.gather(fin["lens"], 1, idx),
            "pos_scores": _gather_rows(fin["pos"], idx), "steps": steps}


def _aux_step(dec, fused: List[Dict[str, torch.Tensor]],
              tokens_t: torch.Tensor, step: int,
              caches: List[Dict[str, torch.Tensor]],
              cross_kvs: List[Dict[str, torch.Tensor]],
              enc_pad: Optional[torch.Tensor]) -> torch.Tensor:
    """One decode step of an aux text decoder (``AuxTextDecoder``):
    tokens_t (N, 1) -> fp32 log-probs (N, V); each layer's cache is
    written at ``step``. ``fused`` holds each layer's
    ``fuse_decoder_layer_params``: the step is the mel decoder's fused one,
    which masks the cache positions after ``step`` as JAX's unfused
    ``decoder_layer_step`` does. The embedding is scaled by sqrt(dim), the
    position is step + PAD + 1 (every earlier token is a non-pad), and the
    output projection takes fp32 products of the compute-dtype operands
    (JAX's ``preferred_element_type``)."""
    cfg = dec.cfg
    x = dec.embed_tokens.weight.to(cfg.dtype)[tokens_t]
    if not cfg.no_scale_embedding:
        x = scaled(x, math.sqrt(dec.dim))
    x = x + dec.pos_table[step + PAD + 1].to(cfg.dtype)
    for lp, cache, kv in zip(fused, caches, cross_kvs):
        x, _, _ = decoder_layer_step_fused(
            lp, x, cache, step, kv, enc_pad, cfg.decoder_attention_heads,
            normalize_before=cfg.decoder_normalize_before,
            activation=cfg.activation_fn)
    if dec.layer_norm is not None:
        x = layer_norm(x, dec.layer_norm.weight, dec.layer_norm.bias)
    w = dec.output_projection.weight.to(x.dtype)
    logits = torch.matmul(x[:, 0].float(), w.float().t())
    return torch.log_softmax(logits, dim=-1)


@torch.no_grad()
def beam_search_aux(dec, enc_tap: torch.Tensor,
                    enc_pad: Optional[torch.Tensor], cfg: BeamConfig
                    ) -> Dict[str, torch.Tensor]:
    """Beam-decode text from one aux decoder over its encoder tap (B, Ts,
    C) and padding mask (B, Ts). Returns ``beam_search``'s dict."""
    k, b = cfg.beam, enc_tap.shape[0]
    dev = enc_tap.device
    tap_k = enc_tap.repeat_interleave(k, dim=0)
    pad_k = enc_pad.repeat_interleave(k, dim=0) if enc_pad is not None \
        else None
    fused = [fuse_decoder_layer_params(layer) for layer in dec.layers]
    cross = [cross_attn_precompute(layer.encoder_attn, tap_k)
             for layer in dec.layers]
    heads = dec.cfg.decoder_attention_heads
    cache: Dict[str, torch.Tensor] = {}
    for i in range(len(dec.layers)):
        c = self_attn_cache_init(b * k, cfg.max_len + 1, heads,
                                 dec.dim // heads, dec.cfg.dtype, dev)
        cache[f"k{i}"], cache[f"v{i}"] = c["k"], c["v"]

    def step_fn(tokens, t, cache):
        layers = [{"k": cache[f"k{i}"], "v": cache[f"v{i}"]}
                  for i in range(len(dec.layers))]
        return _aux_step(dec, fused, tokens, t, layers, cross, pad_k), cache

    vocab = dec.output_projection.weight.shape[0]
    return beam_search(step_fn, cache, b, vocab, cfg, dev)


@torch.no_grad()
def score_sequences(dec, enc_tap: torch.Tensor,
                    enc_pad: Optional[torch.Tensor], tokens: torch.Tensor,
                    lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Teacher-forced scores of given targets (SequenceScorer): tokens
    (B, T) ending in EOS, PAD-padded; lengths (B,) counting the EOS. The
    decoder reads them shifted, EOS first, pads kept. Returns
    positional_scores (B, T) fp32 (0 past each length) and score (B,),
    their mean over each length."""
    b, tt = tokens.shape
    prev = torch.where(tokens == PAD, PAD, torch.cat(
        [torch.full((b, 1), EOS, dtype=tokens.dtype, device=tokens.device),
         tokens[:, :-1]], dim=1))
    lp = torch.log_softmax(dec(prev, enc_tap, enc_pad).float(), dim=-1)
    pos = torch.gather(lp, 2, tokens[:, :, None].long())[:, :, 0]
    valid = torch.arange(tt, device=tokens.device)[None, :] \
        < lengths[:, None]
    pos = torch.where(valid, pos, 0.0)
    return {"positional_scores": pos,
            "score": pos.sum(dim=1) / lengths.clamp(min=1).float()}


@torch.no_grad()
def ctc_argmax_decode(model, enc_tap0: torch.Tensor,
                      enc_lens: torch.Tensor) -> List[np.ndarray]:
    """Best-path CTC over the model's CTC head on tap 0: the argmax of
    each frame, repeats collapsed, blanks (0) dropped, up to each
    length."""
    proj = model.decoder.ctc_proj
    ids = linear(enc_tap0, proj.weight, proj.bias).argmax(dim=-1)
    out = []
    for row, n in zip(ids.cpu().numpy(), enc_lens.cpu().numpy()):
        row = row[:n]
        out.append(np.asarray([int(t) for i, t in enumerate(row)
                               if t != 0 and (i == 0 or t != row[i - 1])],
                              np.int32))
    return out
