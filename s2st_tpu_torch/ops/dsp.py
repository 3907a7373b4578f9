"""Griffin-Lim, the pseudo-inverse mel and the MFCC, on the device.

Counterpart of ``s2st_tpu/ops/dsp.py``. The STFT is framing plus one
matmul against a windowed DFT kernel trimmed to the window's support, and
the inverse is one matmul against a windowed inverse-DFT basis plus an
overlap-add; the refinement loop carries the complex spectrum as (re, im)
pairs in one (B, T, F) layout. The DFT products are ``torch.matmul``, as
the JAX package leaves them to XLA. Bases are built with numpy on the host.
``mfcc`` is the 13-coefficient MFCC of the MCD validation metric (:301-337).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.audio_utils import mel_filters, mel_filters_htk


def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic hann, zero-padded to n_fft about the centre."""
    win = np.hanning(win_length + 1)[:-1]
    pad = n_fft - win_length
    return np.pad(win, (pad // 2, pad - pad // 2)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _stft_kernel(n_fft: int, win_length: int) -> Tuple[np.ndarray, int]:
    """((K', 2F) windowed DFT kernel, first nonzero tap): column f is
    Re(X_f), column F+f is Im(X_f); K' = win_length taps of the window's
    support (ops/dsp.py:43-62)."""
    f_count = n_fft // 2 + 1
    off = (n_fft - win_length) // 2
    j = np.arange(off, off + win_length)[:, None].astype(np.float64)
    f = np.arange(f_count)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * j * f / n_fft
    win = hann_window(win_length, n_fft).astype(np.float64)[
        off:off + win_length, None]
    k = np.concatenate([np.cos(ang) * win, -np.sin(ang) * win], axis=1)
    return k.astype(np.float32), off


@functools.lru_cache(maxsize=8)
def _istft_basis(n_fft: int, win_length: int) -> Tuple[np.ndarray, int]:
    """((2F, K') windowed inverse-DFT basis, first tap): frames =
    [Re | Im] @ basis (ops/dsp.py:65-83)."""
    f_count = n_fft // 2 + 1
    off = (n_fft - win_length) // 2
    j = np.arange(off, off + win_length)[None, :].astype(np.float64)
    f = np.arange(f_count)[:, None].astype(np.float64)
    ang = 2.0 * np.pi * j * f / n_fft
    coef = np.full((f_count, 1), 2.0)
    coef[0, 0] = 1.0
    if n_fft % 2 == 0:
        coef[-1, 0] = 1.0
    win = hann_window(win_length, n_fft).astype(np.float64)[
        None, off:off + win_length]
    ic = coef * np.cos(ang) / n_fft * win
    is_ = -coef * np.sin(ang) / n_fft * win
    return np.concatenate([ic, is_], axis=0).astype(np.float32), off


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, K) frames -> (B, (T-1)*hop + K), without a scatter: frames
    g = ceil(K / hop) apart never overlap, so each residue class lays out
    as one reshape and the g streams add densely (ops/dsp.py:86-108)."""
    b, t, k = frames.shape
    g = -(-k // hop)
    stride = g * hop
    out_len = (t - 1) * hop + k
    buf_len = out_len + stride + k
    total = frames.new_zeros((b, buf_len))
    for r in range(g):
        fr = frames[:, r::g]
        tr = fr.shape[1]
        if tr == 0:
            continue
        flat = F.pad(fr, (0, stride - k)).reshape(b, tr * stride)
        start = r * hop
        total[:, start:start + tr * stride] += flat
    return total[:, :out_len]


def _frames_view(x: torch.Tensor, off: int, n_frames: int, win: int,
                 hop: int) -> torch.Tensor:
    """(B, L) -> (B, n_frames, win) overlapping frames from ``off``: g =
    win // hop slices of a (B, n, hop) reshape when hop divides win,
    else an unfold (ops/dsp.py:111-127)."""
    if win % hop == 0:
        g = win // hop
        need = (n_frames + g - 1) * hop
        chunks = x[:, off:off + need].reshape(x.shape[0], -1, hop)
        return torch.cat([chunks[:, c:c + n_frames] for c in range(g)],
                         dim=-1)
    return x[:, off:].unfold(-1, win, hop)[:, :n_frames]


@functools.lru_cache(maxsize=16)
def _window_sumsquare(n_frames: int, hop: int, win_length: int, n_fft: int
                      ) -> np.ndarray:
    """Sum of squared windows over the frames, tiny values replaced by 1
    (ops/dsp.py:160-168, :228-229)."""
    w_sq = hann_window(win_length, n_fft) ** 2
    n = n_fft + hop * (n_frames - 1)
    x = np.zeros(n, np.float32)
    for i in range(n_frames):
        ofst = i * hop
        x[ofst:min(n, ofst + n_fft)] += w_sq[:max(0, min(n_fft, n - ofst))]
    return np.where(x > 1.1754944e-38, x, 1.0).astype(np.float32)


def griffin_lim(specgram: torch.Tensor, n_fft: int, win_length: int,
                hop: int, n_iter: int,
                init_angles: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Griffin-Lim phase reconstruction (ops/dsp.py:203-280).
    specgram (B, F, T) linear magnitude -> (B, (T-1)*hop) waveform.

    init_angles (B, T, F): the initial phases; drawn uniform in [-pi, pi)
    from ``generator`` when not given. The DFT products and the refinement
    carry run in compute_dtype; the final synthesis writes fp32."""
    spec_t = specgram.transpose(1, 2).float()                    # (B, T, F)
    b, t, f_count = spec_t.shape
    dev = spec_t.device
    basis_np, ioff = _istft_basis(n_fft, win_length)
    kern_np, koff = _stft_kernel(n_fft, win_length)
    basis = torch.from_numpy(basis_np).to(dev)
    kern = torch.from_numpy(kern_np).to(dev)
    wss = torch.from_numpy(_window_sumsquare(t, hop, win_length, n_fft)
                           ).to(dev)
    pad = n_fft // 2
    out_len = (t - 1) * hop + n_fft
    win_len = kern_np.shape[0]

    def synth(re, im, wave_dtype):
        # operands rounded to compute_dtype, product in wave_dtype (JAX's
        # preferred_element_type): the final synthesis keeps fp32 sums
        spec2 = torch.cat([re, im], dim=-1).to(compute_dtype)   # (B, T, 2F)
        frames = torch.matmul(spec2.to(wave_dtype),
                              basis.to(compute_dtype).to(wave_dtype))
        wave = _overlap_add(frames, hop)
        wave = F.pad(wave, (ioff, out_len - ioff - wave.shape[-1]))
        return wave / wss.to(wave_dtype)

    def project(wave):
        inner = wave[:, pad:-pad]
        x = F.pad(inner[:, None, :].float(), (pad, pad), mode="reflect")[:, 0]
        frames = _frames_view(x, koff, t, win_len, hop)
        out = torch.matmul(frames.to(compute_dtype),
                           kern.to(compute_dtype)).float()       # (B, T, 2F)
        return out[..., :f_count], out[..., f_count:]

    if init_angles is None:
        init_angles = (torch.rand(spec_t.shape, generator=generator,
                                  device=dev) * 2.0 - 1.0) * math.pi
    ang = init_angles.to(dev, torch.float32)
    re = (spec_t * torch.cos(ang)).to(compute_dtype)
    im = (spec_t * torch.sin(ang)).to(compute_dtype)
    for _ in range(n_iter):
        pre, pim = project(synth(re, im, compute_dtype))
        scale = spec_t * torch.rsqrt(pre * pre + pim * pim + 1e-30)
        re, im = (pre * scale).to(compute_dtype), (pim * scale).to(
            compute_dtype)
    return synth(re, im, torch.float32)[:, pad:-pad]


def make_pinv_mel_basis(sample_rate: int, n_fft: int, n_mels: int,
                        f_min: float, f_max: float) -> np.ndarray:
    """(F, n_mels) pseudo-inverse of the slaney mel filterbank."""
    basis = mel_filters(sample_rate, n_fft, n_mels, f_min, f_max)
    return np.linalg.pinv(basis).astype(np.float32)


def logmel_to_linear(logmel: torch.Tensor, pinv_basis: torch.Tensor
                     ) -> torch.Tensor:
    """(B, T, n_mels) log-mel -> (B, F, T) linear magnitude, clamped >= 0."""
    mel = torch.exp(logmel.float())
    spec = torch.einsum("fm,btm->bft", pinv_basis.float(), mel)
    return torch.clamp(spec, min=0.0)


@functools.lru_cache(maxsize=8)
def _dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_mfcc) DCT-II with the ortho norm (torchaudio create_dct)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[None, :]
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k) \
        * np.sqrt(2.0 / n_mels)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    return dct.astype(np.float32)


# the MCD metric's MFCC: 13 coefficients of 80 mels (ops/dsp.py:310)
MFCC_COEFFS, MFCC_MELS = 13, 80


@functools.lru_cache(maxsize=8)
def _mfcc_bases(sample_rate: int, n_fft: int):
    return (hann_window(n_fft, n_fft),
            mel_filters_htk(sample_rate, n_fft, MFCC_MELS, 20.0,
                            sample_rate / 2.0).T.copy(),
            _dct_matrix(MFCC_COEFFS, MFCC_MELS))


def mfcc(wave: torch.Tensor, lengths: torch.Tensor, sample_rate: int = 16000
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchaudio ``MFCC(log_mels=True)`` with the MCD settings
    (ops/dsp.py:310-337): a 50 ms hann window (= n_fft), a 12.5 ms hop,
    reflect padding of n_fft // 2, the power spectrum, HTK mel triangles
    from 20 Hz to sr / 2, log(mel + 1e-6) and the ortho DCT.
    wave (B, L) padded; lengths (B,). Returns (mfcc (B, T, 13) fp32,
    out_lengths (B,) = 1 + L // hop)."""
    n_fft = int(0.05 * sample_rate)
    hop = int(0.0125 * sample_rate)
    pad = n_fft // 2
    win_np, fb_np, dct_np = _mfcc_bases(sample_rate, n_fft)
    dev = wave.device
    x = F.pad(wave.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + (x.shape[-1] - n_fft) // hop
    frames = _frames_view(x, 0, n_frames, n_fft, hop) \
        * torch.from_numpy(win_np).to(dev)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2                      # (B, T, F)
    mel = torch.matmul(power, torch.from_numpy(fb_np).to(dev))
    out = torch.matmul(torch.log(mel + 1e-6), torch.from_numpy(dct_np).to(dev))
    return out, 1 + torch.div(lengths, hop, rounding_mode="floor")
