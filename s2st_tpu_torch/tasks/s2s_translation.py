"""Validation with inference for the S2ST task: MCD-DTW on generated speech.

Counterpart of ``s2st_tpu/tasks/s2s_translation.py``: the data config as
``setup_task`` reads it (:47-49, ``--use-hubert`` switching the sources to
raw waveforms), ``gcmvn_stats`` (:300) and ``build_eval_inference_fn``
(:312-372), which takes fbank or waveform batches alike. For a validation
batch
the function decodes the model's log-mels autoregressively (prenet dropout
on, as fairseq's inference keeps it), maps them and the batch's
denormalised target mels to linear magnitudes, vocodes both with the same
Griffin-Lim and sums the MCD of the two waveforms over the whole padded
batch (``ops/mcd.py::batch_mcd``). The first-utterance TensorBoard panels
of JAX's function are not produced.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.data_cfg import S2STDataConfig
from ..data.dictionary import Dictionary
from ..generate.speech_generator import GenerationConfig, generate_features
from ..ops.dsp import griffin_lim, logmel_to_linear, make_pinv_mel_basis
from ..ops.mcd import batch_mcd

# the decode's stop threshold; JAX's train CLI never passes its own
EOS_PROB_THRESHOLD = 0.5


def data_config(args) -> S2STDataConfig:
    """``<data>/<config-yaml>`` with the CLI's ``--use-hubert`` (the
    command line's, not a checkpoint's: JAX's data loading keeps the CLI's
    choices, options.py:2385-2386)."""
    cfg = S2STDataConfig(Path(args.data) / args.config_yaml)
    cfg.set_use_hubert(getattr(args, "use_hubert", False))
    return cfg


def load_dictionaries(data: str, data_cfg: S2STDataConfig
                      ) -> Tuple[Dictionary, Dictionary]:
    """The source and target dictionaries that config.yaml names."""
    return tuple(Dictionary.load(str(Path(data) / data_cfg.config[key]))
                 for key in ("src_vocab_filename", "tgt_vocab_filename"))


def gcmvn_stats(data_cfg: S2STDataConfig
                ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(mean, std) of the target's global CMVN, or (None, None)."""
    path = data_cfg.cmvn_stats_path("tgt_global_cmvn")
    if path is None:
        return None, None
    stats = np.load(path)
    return stats["mean"].astype(np.float32), stats["std"].astype(np.float32)


def build_eval_inference_fn(model, data_cfg: S2STDataConfig,
                            spec_bwd_max_iter: int = 8, max_iter: int = 500
                            ) -> Callable:
    """fn(src_speech, src_speech_lens, tgt_speech, target_lengths,
    generator=None, init_angles=None, prenet_dropout=True, lap=None) ->
    the batch's MCD sums (mcd_loss, targ_frames, pred_frames, nins, ndel).

    The features block of config.yaml gives the vocoder's settings under
    JAX's keys and defaults (sample_rate 16000, n_fft 1024, hop_length
    256, win_length n_fft, n_mels 80, f_min 20, f_max sr // 2); Griffin-Lim
    runs its DFT products in bf16, as JAX's does.
    ``generator`` draws the prenet dropout and both Griffin-Lim phase
    initialisations; ``init_angles`` = (prediction's, target's) (B, T, F)
    phases replace those draws, and ``prenet_dropout=False`` turns the
    dropout off. lap(name), when given, is called after the decode, the
    two Griffin-Lim runs, the MFCCs and the DTW."""
    cfg = model.cfg
    mean, std = gcmvn_stats(data_cfg)
    feats_cfg = data_cfg.features or {}
    sr = int(feats_cfg.get("sample_rate", 16000))
    n_fft = int(feats_cfg.get("n_fft", 1024))
    hop = int(feats_cfg.get("hop_length", 256))
    win = int(feats_cfg.get("win_length", n_fft))
    n_mels = int(feats_cfg.get("n_mels", 80))
    f_min = float(feats_cfg.get("f_min", 20.0))
    f_max = float(feats_cfg.get("f_max", sr // 2))
    pinv_np = make_pinv_mel_basis(sr, n_fft, n_mels, f_min, f_max)
    r = cfg.n_frames_per_step

    @torch.no_grad()
    def fn(src_speech: torch.Tensor, src_speech_lens: torch.Tensor,
           tgt_speech: torch.Tensor, target_lengths: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           init_angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           prenet_dropout: bool = True, lap=None) -> Dict[str, float]:
        dev = src_speech.device
        gen_cfg = GenerationConfig(max_iter=max_iter,
                                   eos_prob_threshold=EOS_PROB_THRESHOLD,
                                   prenet_dropout_at_inference=prenet_dropout)
        out = generate_features(model, gen_cfg, src_speech, src_speech_lens,
                                generator=generator, gcmvn_mean=mean,
                                gcmvn_std=std)
        if lap is not None:
            lap("decode")
        pinv = torch.from_numpy(pinv_np).to(dev)
        angles = init_angles or (None, None)
        pred_wave = griffin_lim(logmel_to_linear(out["feats"], pinv), n_fft,
                                win, hop, spec_bwd_max_iter, angles[0],
                                generator)
        # the inverse STFT gives (T - 1) * hop samples for T frames
        pred_wlen = (out["raw_out_lens"] - 1).clamp(min=0) * hop
        tgt = tgt_speech.float().reshape(tgt_speech.shape[0], -1,
                                         cfg.output_frame_dim)
        if mean is not None:
            tgt = tgt * torch.from_numpy(std).to(dev) \
                + torch.from_numpy(mean).to(dev)
        tgt_wave = griffin_lim(logmel_to_linear(tgt, pinv), n_fft, win, hop,
                               spec_bwd_max_iter, angles[1], generator)
        tgt_wlen = (target_lengths * r - 1).clamp(min=0) * hop
        if lap is not None:
            lap("griffin_lim")
        return batch_mcd(pred_wave, pred_wlen, tgt_wave, tgt_wlen, sr, lap)

    return fn
