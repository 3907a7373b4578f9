"""Vocoders: Griffin-Lim (log-mel -> pseudo-inverse mel -> Griffin-Lim,
batched on the device) and HiFi-GAN (counterpart of
``s2st_tpu/generate/vocoder.py``: ``GriffinLimVocoder`` :29-78,
``HiFiGANVocoder`` :81-110, ``get_vocoder`` :113-119).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..data.data_cfg import S2STDataConfig
from ..ops.dsp import griffin_lim, logmel_to_linear, make_pinv_mel_basis

LOG_EPS = float(np.log(1e-5))  # log-mel floor of the target features


class GriffinLimVocoder:
    def __init__(self, sample_rate: int, win_size: int, hop_size: int,
                 n_fft: int, n_mels: int, f_min: float, f_max: float,
                 spec_bwd_max_iter: int = 32, device=None):
        self.sample_rate = sample_rate
        self.win_size, self.hop_size, self.n_fft = win_size, hop_size, n_fft
        self.n_iter = spec_bwd_max_iter
        self.pinv_basis = torch.from_numpy(make_pinv_mel_basis(
            sample_rate, n_fft, n_mels, f_min, f_max)).to(device)

    def __call__(self, logmel: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 init_angles: Optional[torch.Tensor] = None) -> torch.Tensor:
        """logmel (B, T, n_mels) -> (B, hop * (T - 1)) waveform; frames at
        and past each length are set to the log floor first."""
        logmel = logmel.float()
        b, t, _ = logmel.shape
        if lengths is not None:
            mask = torch.arange(t, device=logmel.device)[None, :] \
                < lengths.to(logmel.device)[:, None]
            logmel = torch.where(mask[:, :, None], logmel,
                                 torch.full_like(logmel, LOG_EPS))
        spec = logmel_to_linear(logmel, self.pinv_basis)        # (B, F, T)
        return griffin_lim(spec, self.n_fft, self.win_size, self.hop_size,
                           self.n_iter, init_angles=init_angles,
                           generator=generator)

    def wave_length(self, n_frames: int) -> int:
        return self.hop_size * (int(n_frames) - 1) if n_frames > 1 else 0

    @classmethod
    def from_data_cfg(cls, data_cfg: S2STDataConfig, spec_bwd_max_iter: int,
                      device=None) -> "GriffinLimVocoder":
        feat = data_cfg.features
        if feat is None:
            raise ValueError("config.yaml must provide a features block")
        return cls(sample_rate=feat["sample_rate"],
                   win_size=int(feat["win_len_t"] * feat["sample_rate"]),
                   hop_size=int(feat["hop_len_t"] * feat["sample_rate"]),
                   n_fft=feat["n_fft"], n_mels=feat["n_mels"],
                   f_min=feat.get("f_min", 0.0),
                   f_max=feat.get("f_max", 8000.0),
                   spec_bwd_max_iter=spec_bwd_max_iter, device=device)


class HiFiGANVocoder:
    """The HiFi-GAN generator of a torch checkpoint, in fp32. It vocodes
    the whole (B, T, n_mels) tensor it is given, frames past each row's
    length included (JAX's takes no lengths either, :96-101), and a row of
    T frames gives hop * T samples."""

    def __init__(self, checkpoint_path: str, model_cfg: dict, device=None):
        from ..models.hifigan import (HiFiGANConfig, HiFiGANGenerator,
                                      load_torch_generator)
        self.cfg = HiFiGANConfig.from_json(model_cfg)
        self.model = HiFiGANGenerator(self.cfg)
        self.model.load_state_dict(load_torch_generator(checkpoint_path,
                                                        self.cfg))
        self.model = self.model.to(device).eval()
        self.sample_rate = model_cfg.get("sampling_rate", 16000)
        self.hop_size = int(np.prod(self.cfg.upsample_rates))

    @torch.no_grad()
    def __call__(self, logmel: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """logmel (B, T, n_mels) -> (B, hop * T); lengths and generator are
        taken for Griffin-Lim's signature and not used."""
        return self.model(logmel.float())

    def wave_length(self, n_frames: int) -> int:
        return self.hop_size * int(n_frames)

    @classmethod
    def from_data_cfg(cls, data_cfg: S2STDataConfig, device=None
                      ) -> "HiFiGANVocoder":
        """From config.yaml's ``vocoder:`` block: ``type: hifigan``,
        ``checkpoint`` and ``config`` (the generator's JSON)."""
        block = data_cfg.vocoder or {}
        if block.get("type", "griffin_lim") != "hifigan":
            raise ValueError("--vocoder hifigan needs a vocoder block with "
                             "type: hifigan in config.yaml")
        with open(data_cfg.abs_path(block["config"])) as f:
            model_cfg = json.load(f)
        return cls(data_cfg.abs_path(block["checkpoint"]), model_cfg, device)


def get_vocoder(name: str, data_cfg: S2STDataConfig, spec_bwd_max_iter: int,
                device=None):
    """``--vocoder griffin_lim|hifigan``."""
    if name == "griffin_lim":
        return GriffinLimVocoder.from_data_cfg(data_cfg, spec_bwd_max_iter,
                                               device)
    if name == "hifigan":
        return HiFiGANVocoder.from_data_cfg(data_cfg, device)
    raise ValueError(f"Unknown vocoder {name}")
