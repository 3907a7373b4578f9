"""Feature and waveform reads, PCM16 WAV writes, the mel filterbanks and
the features of stage 3.

The port's own copies of ``s2st_tpu/data/audio_utils.py`` ``read_wav``
(:41-69), ``parse_path`` and ``get_features_or_waveform`` (:100-123:
``.npy`` features, ``.wav`` files and zip slices holding either),
``write_wav`` (:72-83), ``create_zip`` and ``get_zip_manifest`` (:126-154),
``mel_filters`` (:157-196, librosa slaney mel), ``mel_filters_htk``
(:198-221, torchaudio's HTK mel of the MCD metric), ``kaldi_mel_banks``
(:223), ``compute_global_cmvn`` (:325) and ``resample`` (:343).

Stage 3's features, ``kaldi_fbank`` (:287, the source's 80-d fbank) and
``extract_logmel_spectrogram`` (:266, through ``tts_spectrogram``, the
target's 80-bin log-mel), run in PyTorch on ``device`` (CUDA unless the
caller names another; it raises without a card) in float64 up to the log,
as the JAX package's numpy does: frames gathered by index, the FFT
``torch.fft.rfft``, float32 numpy out.
"""

from __future__ import annotations

import io
import mmap
import struct
import wave
import zipfile
from math import gcd
from pathlib import Path
from typing import BinaryIO, Dict, Iterable, List, Tuple, Union

import numpy as np
import torch

from ..nn.core import resolve_device

AUDIO_OR_FEATURE_SUFFIXES = {".npy", ".wav", ".flac", ".ogg"}


def read_wav(path_or_fp: Union[str, BinaryIO], normalization: bool = True
             ) -> Tuple[np.ndarray, int]:
    """(waveform (T,) float32, sample rate) of a PCM WAV of 8, 16 or 32
    bits, channels averaged. ``normalization`` scales to [-1, 1); without
    it the samples keep the 16-bit integer scale."""
    with wave.open(path_or_fp, "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        width, channels = w.getsampwidth(), w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data, scale = np.frombuffer(raw, "<i2").astype(np.float32), 2.0 ** 15
    elif width == 4:
        data, scale = np.frombuffer(raw, "<i4").astype(np.float32), 2.0 ** 31
    elif width == 1:
        data = np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0
        scale = 2.0 ** 7
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    if normalization:
        data = data / scale
    elif width != 2:
        data = data / scale * 2.0 ** 15
    return data, sr


def parse_path(path: str) -> Tuple[str, List[int]]:
    """``file.npy`` (or ``.wav``) or ``archive.zip:offset:length``."""
    if Path(path).suffix in AUDIO_OR_FEATURE_SUFFIXES:
        return path, []
    _path, *slice_ptr = path.split(":")
    if not Path(_path).is_file():
        raise FileNotFoundError(f"File not found: {_path}")
    if len(slice_ptr) not in (0, 2):
        raise ValueError(f"Invalid path: {path}")
    return _path, [int(i) for i in slice_ptr]


def get_features(path: str) -> np.ndarray:
    """(T, F) features from an ``.npy`` file or an ``.npy`` member stored
    uncompressed in a zip, addressed by byte offset and length."""
    feats = get_features_or_waveform(path)
    if feats.ndim != 2:
        raise ValueError(f"{path} does not hold (T, F) features")
    return feats


def get_features_or_waveform(path: str, need_waveform: bool = False
                             ) -> np.ndarray:
    """``.npy`` features, or a WAV's samples (scaled to [-1, 1) with
    ``need_waveform``) from a file or a zip slice."""
    _path, slice_ptr = parse_path(path)
    if not slice_ptr:
        if Path(_path).suffix == ".npy":
            return np.load(_path)
        return read_wav(_path, normalization=need_waveform)[0]
    with open(_path, "rb") as f:
        with mmap.mmap(f.fileno(), length=0, access=mmap.ACCESS_READ) as mm:
            data = mm[slice_ptr[0]:slice_ptr[0] + slice_ptr[1]]
    if data[:2] == b"\x93N":
        return np.load(io.BytesIO(data))
    return read_wav(io.BytesIO(data), normalization=need_waveform)[0]


def create_zip(data_root: Path, zip_path: Path) -> None:
    """Every ``.npy`` under data_root, stored uncompressed in name order."""
    paths = sorted(Path(data_root).glob("*.npy"))
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for p in paths:
            zf.write(p, arcname=p.name)


def get_zip_manifest(zip_path: Path) -> Dict[str, str]:
    """member stem -> ``zipfile:offset:length`` of its stored bytes."""
    with zipfile.ZipFile(zip_path, "r") as zf:
        infos = zf.infolist()
    manifest = {}
    with open(zip_path, "rb") as f:
        for info in infos:
            f.seek(info.header_offset)
            header = f.read(30)
            if header[:4] != b"PK\x03\x04":
                raise ValueError(f"{zip_path}: bad local header for "
                                 f"{info.filename}")
            name_len, extra_len = struct.unpack("<HH", header[26:30])
            offset = info.header_offset + 30 + name_len + extra_len
            manifest[Path(info.filename).stem] = \
                f"{zip_path}:{offset}:{info.compress_size}"
    return manifest


def write_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """waveform: float in [-1, 1] (or already int16-scale); writes PCM16."""
    x = np.asarray(waveform, dtype=np.float32).reshape(-1)
    if np.max(np.abs(x), initial=0.0) > 8.0:
        pcm = np.clip(x, -32768, 32767).astype("<i2")
    else:
        pcm = np.clip(x * 2.0 ** 15, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filters(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
                f_max: float) -> np.ndarray:
    """librosa.filters.mel (htk=False, norm='slaney') -> (n_mels, 1+n_fft/2)."""
    fft_freqs = np.linspace(0, sample_rate / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max),
                          n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (np.exp(np.asarray(m, np.float64) / 1127.0) - 1.0)


def mel_filters_htk(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
                    f_max: float) -> np.ndarray:
    """torchaudio ``melscale_fbanks(mel_scale='htk', norm=None)``:
    (n_mels, 1 + n_fft // 2) unit-peak triangles on the HTK mel scale."""
    fft_freqs = np.linspace(0, sample_rate / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max),
                          n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32)


def kaldi_mel_banks(num_bins: int, window_length_padded: int,
                    sample_rate: int, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi's MelBanks: unnormalised triangles on the HTK mel scale,
    (num_bins, padded // 2); high_freq <= 0 counts down from Nyquist."""
    num_fft_bins = window_length_padded // 2
    if high_freq <= 0.0:
        high_freq = 0.5 * sample_rate + high_freq
    fft_bin_width = sample_rate / window_length_padded
    mel_low, mel_high = hz_to_mel_htk(low_freq), hz_to_mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bin_mels = hz_to_mel_htk(np.arange(num_fft_bins) * fft_bin_width)
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (bin_mels[None, :] - left) / (center - left)
    down = (right - bin_mels[None, :]) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


def _povey_window(n: int) -> np.ndarray:
    a = 2 * np.pi / (n - 1)
    return (0.5 - 0.5 * np.cos(a * np.arange(n))) ** 0.85


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Indices of numpy's ``np.pad(x, pad, mode="reflect")`` into x, also
    where pad >= n (numpy reflects again; torch's reflect pad refuses)."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    j = np.mod(i, period)
    return np.where(j >= n, period - j, j)


def _frames(x: torch.Tensor, size: int, shift: int) -> torch.Tensor:
    """(n_frames, size) windows of x every ``shift`` samples."""
    n_frames = 1 + (x.shape[0] - size) // shift
    idx = (torch.arange(size, device=x.device)[None, :]
           + shift * torch.arange(n_frames, device=x.device)[:, None])
    return x[idx]


def tts_spectrogram(waveform: np.ndarray, n_fft: int, win_length: int,
                    hop_length: int, device=None) -> torch.Tensor:
    """The centred magnitude STFT (reflect pad of n_fft // 2, a periodic
    Hann window zero-padded to n_fft): (F, T) float64 on the device."""
    dev = resolve_device(device)
    x = np.asarray(waveform, dtype=np.float64)
    if x.shape[0] == 0:
        raise ValueError("an empty waveform has no frames")
    x = torch.from_numpy(x).to(dev)
    pad = n_fft // 2
    x = x[torch.from_numpy(_reflect_index(x.shape[0], pad)).to(dev)]
    win = np.hanning(win_length + 1)[:-1]   # torch.hann_window(periodic)
    wpad = n_fft - win_length
    win = np.pad(win, (wpad // 2, wpad - wpad // 2))
    frames = _frames(x, n_fft, hop_length) * torch.from_numpy(win).to(dev)
    return torch.fft.rfft(frames, n=n_fft, dim=1).abs().T


def extract_logmel_spectrogram(waveform: np.ndarray, sample_rate: int,
                               win_length: int = 1024, hop_length: int = 256,
                               n_fft: int = 1024, n_mels: int = 80,
                               f_min: float = 0.0, f_max: float = 8000.0,
                               eps: float = 1e-5, device=None) -> np.ndarray:
    """(T,) waveform in [-1, 1] -> (frames, n_mels) float32 log-mel:
    log(max(slaney_mel @ |STFT|, eps))."""
    dev = resolve_device(device)
    mag = tts_spectrogram(waveform, n_fft, win_length, hop_length, dev)
    basis = torch.from_numpy(mel_filters(sample_rate, n_fft, n_mels, f_min,
                                         f_max).astype(np.float64)).to(dev)
    mel = basis @ mag
    return torch.log(mel.clamp(min=eps)).T.float().cpu().numpy()


def kaldi_fbank(waveform: np.ndarray, sample_rate: int = 16000,
                num_mel_bins: int = 80, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, preemphasis: float = 0.97,
                remove_dc_offset: bool = True, low_freq: float = 20.0,
                high_freq: float = 0.0, device=None) -> np.ndarray:
    """torchaudio.compliance.kaldi.fbank with its defaults (no dither, a
    povey window, snip_edges, the power spectrum, the natural log) of a
    (T,) waveform at 16-bit integer scale: (frames, num_mel_bins) float32,
    (0, num_mel_bins) below one window."""
    window_size = int(sample_rate * frame_length_ms * 1e-3)
    window_shift = int(sample_rate * frame_shift_ms * 1e-3)
    padded = 1 << (window_size - 1).bit_length()
    x = np.asarray(waveform, dtype=np.float64)
    if x.shape[0] < window_size:
        return np.zeros((0, num_mel_bins), np.float32)
    dev = resolve_device(device)
    frames = _frames(torch.from_numpy(x).to(dev), window_size, window_shift)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=1, keepdim=True)
    if preemphasis != 0.0:
        first = frames[:, :1]
        frames = torch.cat([first - preemphasis * first,
                            frames[:, 1:] - preemphasis * frames[:, :-1]],
                           dim=1)
    frames = frames * torch.from_numpy(_povey_window(window_size)).to(dev)
    spec = torch.fft.rfft(frames, n=padded, dim=1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, :padded // 2]
    banks = kaldi_mel_banks(num_mel_bins, padded, sample_rate, low_freq,
                            high_freq)
    mel = power @ torch.from_numpy(banks.T.astype(np.float64)).to(dev)
    eps = float(np.finfo(np.float32).eps)
    return torch.log(mel.clamp(min=eps)).float().cpu().numpy()


def compute_global_cmvn(feature_iter: Iterable[np.ndarray]
                        ) -> Dict[str, np.ndarray]:
    """Mean and std over the frames of every (T, C) array, in float64 on
    the host (one pass, the std floored at sqrt(1e-10))."""
    mean_x = mean_x2 = None
    n = 0
    for frames in feature_iter:
        frames = np.asarray(frames, dtype=np.float64)
        n += frames.shape[0]
        sx, sx2 = frames.sum(axis=0), (frames ** 2).sum(axis=0)
        mean_x = sx if mean_x is None else mean_x + sx
        mean_x2 = sx2 if mean_x2 is None else mean_x2 + sx2
    mean_x /= n
    mean_x2 /= n
    std = np.sqrt(np.maximum(mean_x2 - mean_x ** 2, 1e-10))
    return {"mean": mean_x.astype(np.float32), "std": std.astype(np.float32)}


def resample(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling on the host (scipy's ``resample_poly``, as the
    JAX package does; scipy is on both machines and a file is resampled
    once), in the waveform's dtype."""
    if orig_sr == new_sr:
        return waveform
    from scipy.signal import resample_poly
    g = gcd(orig_sr, new_sr)
    return resample_poly(waveform, new_sr // g, orig_sr // g).astype(
        waveform.dtype)
