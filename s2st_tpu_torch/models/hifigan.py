"""The HiFi-GAN generator (vocoder) and its torch checkpoints.

Counterpart of ``s2st_tpu/models/hifigan.py`` (the reference's
``fairseq/models/text_to_speech/hifigan.py``): conv_pre -> [leaky ReLU ->
ConvTranspose1d upsampling (padding (k - u) // 2) -> the multi-receptive-
field fusion, the average of parallel dilated ResBlocks] a rate -> leaky
ReLU -> conv_post -> tanh. Every leaky ReLU has slope 0.1, the last one
too, as in the JAX package. ``HiFiGANConfig.from_json`` reads the public
HiFi-GAN ``config.json`` keys.

The module carries fairseq's ``state_dict`` names (``conv_pre``,
``ups.{i}``, ``resblocks.{i * n_kernels + j}.convs1/convs2/convs.{d}``,
``conv_post``) in torch's own layouts: Conv1d (Cout, Cin, K),
ConvTranspose1d (Cin, Cout, K). ``load_torch_generator`` reads a torch
checkpoint (``{"generator": state_dict}`` or a bare state dict) and folds
``weight_g``/``weight_v`` (w = g * v / ||v||, the norm over all but the
first dim) in float32 numpy, as JAX's ``_fold_weight_norm`` does.
``state_dict_from_jax`` carries JAX's HiFi-GAN parameters (numpy) across:
it inverts JAX's ``_t_conv`` (K, Cin, Cout) and ``_t_convT`` (K, Cin, Cout)
time-flipped. ``synthesize_streaming`` is JAX's chunked synthesis
(:224-269): the mel padded with ``receptive_field_frames`` zero frames on
both sides, each chunk synthesized with that margin and its interior
kept.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class HiFiGANConfig:
    model_in_dim: int = 80
    upsample_initial_channel: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))

    @classmethod
    def from_json(cls, cfg: Dict[str, Any]) -> "HiFiGANConfig":
        return cls(
            model_in_dim=cfg.get("model_in_dim") or cfg.get("num_mels", 80),
            upsample_initial_channel=cfg["upsample_initial_channel"],
            upsample_rates=tuple(cfg["upsample_rates"]),
            upsample_kernel_sizes=tuple(cfg["upsample_kernel_sizes"]),
            resblock=str(cfg.get("resblock", "1")),
            resblock_kernel_sizes=tuple(cfg["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in cfg["resblock_dilation_sizes"]))


def _conv(ch: int, k: int, d: int = 1) -> nn.Conv1d:
    return nn.Conv1d(ch, ch, k, dilation=d, padding=(k - 1) // 2 * d)


class ResBlock(nn.Module):
    """ResBlock1 (``convs1`` dilated then ``convs2`` undilated, a residual
    a dilation) or ResBlock2 (``convs`` dilated, a residual each)."""

    def __init__(self, kind: str, ch: int, k: int, dilations):
        super().__init__()
        self.kind = kind
        if kind == "1":
            self.convs1 = nn.ModuleList(_conv(ch, k, d) for d in dilations)
            self.convs2 = nn.ModuleList(_conv(ch, k) for _ in dilations)
        else:
            self.convs = nn.ModuleList(_conv(ch, k, d) for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "1":
            for c1, c2 in zip(self.convs1, self.convs2):
                x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)),
                                        LRELU_SLOPE))
        else:
            for c in self.convs:
                x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.model_in_dim, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, u,
                                               padding=(k - u) // 2))
            ch //= 2
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(cfg.resblock, ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, logmel: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) log-mel -> (B, T * prod(upsample_rates)) fp32."""
        h = self.conv_pre(logmel.float().transpose(1, 2))
        n = len(self.cfg.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            h = up(F.leaky_relu(h, LRELU_SLOPE))
            acc = self.resblocks[i * n](h)
            for j in range(1, n):
                acc = acc + self.resblocks[i * n + j](h)
            h = acc / n
        h = self.conv_post(F.leaky_relu(h, LRELU_SLOPE))
        return torch.tanh(h)[:, 0, :]


def _fold(sd: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    if prefix + ".weight" in sd:
        return np.asarray(sd[prefix + ".weight"], np.float32)
    g = np.asarray(sd[prefix + ".weight_g"], np.float32)
    v = np.asarray(sd[prefix + ".weight_v"], np.float32)
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def load_torch_generator(path: str, cfg: HiFiGANConfig
                         ) -> Dict[str, torch.Tensor]:
    """A torch HiFi-GAN checkpoint -> the ``state_dict`` of
    ``HiFiGANGenerator(cfg)``, weight norms folded."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "generator" in state:
        state = state["generator"]
    sd = {k: v.float().numpy() for k, v in state.items()}
    with torch.device("meta"):
        names = HiFiGANGenerator(cfg).state_dict()
    out = {}
    for name in names:
        prefix, leaf = name.rsplit(".", 1)
        arr = _fold(sd, prefix) if leaf == "weight" else np.asarray(
            sd[name], np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def state_dict_from_jax(params: Dict[str, Any], cfg: HiFiGANConfig
                        ) -> Dict[str, torch.Tensor]:
    """JAX's HiFi-GAN parameters (``init_hifigan`` / ``load_torch_generator``
    layout, numpy) -> the port's ``state_dict``."""
    def conv(p):
        return np.transpose(np.asarray(p["w"], np.float32), (2, 1, 0))

    def conv_t(p):
        return np.transpose(np.asarray(p["w"], np.float32)[::-1], (1, 2, 0))

    sd = {}

    def put(name, w, b):
        sd[name + ".weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[name + ".bias"] = torch.from_numpy(np.asarray(b, np.float32))

    put("conv_pre", conv(params["conv_pre"]), params["conv_pre"]["b"])
    n = len(cfg.resblock_kernel_sizes)
    names = ("convs1", "convs2") if cfg.resblock == "1" else ("convs",)
    for i in range(len(cfg.upsample_rates)):
        put(f"ups.{i}", conv_t(params[f"up_{i}"]), params[f"up_{i}"]["b"])
        for j, rd in enumerate(cfg.resblock_dilation_sizes):
            blk = params[f"res_{i}_{j}"]
            for d in range(len(rd)):
                for c in names:
                    p = blk[f"{c}_{d}"]
                    put(f"resblocks.{i * n + j}.{c}.{d}", conv(p), p["b"])
    put("conv_post", conv(params["conv_post"]), params["conv_post"]["b"])
    return sd


def receptive_field_frames(cfg: HiFiGANConfig) -> int:
    """An upper bound on the generator's receptive field in input mel
    frames: conv_pre and each rate's resblocks mapped back through the
    cumulative upsampling, plus conv_post and a margin."""
    rf = 3  # conv_pre k=7 -> +-3
    up = 1
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        up *= u
        stage_rf = k  # transpose conv spread
        for rk, rd in zip(cfg.resblock_kernel_sizes,
                          cfg.resblock_dilation_sizes):
            stage_rf += sum((rk - 1) * d + (rk - 1) for d in rd)
        rf += -(-stage_rf // up)  # ceil back to input frames
    return rf + 4  # conv_post + margin


def synthesize_streaming(generator: HiFiGANGenerator, x: torch.Tensor,
                         chunk_frames: int = 64,
                         overlap: Optional[int] = None) -> torch.Tensor:
    """(B, T, n_mels) log-mel -> (B, T * prod(upsample_rates)) fp32, one
    chunk of ``chunk_frames`` after another, each synthesized with
    ``overlap`` (the receptive field by default) frames of context on both
    sides (zeros past the ends) and its ``chunk_frames * hop`` interior
    samples kept."""
    cfg = generator.cfg
    b, t, _ = x.shape
    ov = overlap if overlap is not None else receptive_field_frames(cfg)
    up = int(np.prod(cfg.upsample_rates))
    n_chunks = -(-t // chunk_frames)
    xp = F.pad(x, (0, 0, ov, n_chunks * chunk_frames - t + ov))
    chunks = []
    for ci in range(n_chunks):
        start = ci * chunk_frames
        wav = generator(xp[:, start:start + chunk_frames + 2 * ov])
        chunks.append(wav[:, ov * up:ov * up + chunk_frames * up])
    return torch.cat(chunks, dim=1)[:, :t * up]
