"""Feature and waveform reads, PCM16 WAV writes and the mel filterbank.

The port's own copies of ``s2st_tpu/data/audio_utils.py`` ``read_wav``
(:41-69), ``parse_path`` and ``get_features_or_waveform`` (:100-123:
``.npy`` features, ``.wav`` files and zip slices holding either),
``write_wav`` (:72-83), ``mel_filters`` (:157-196, librosa slaney mel) and
``mel_filters_htk`` (:198-221, torchaudio's HTK mel of the MCD metric).
"""

from __future__ import annotations

import io
import mmap
import wave
from pathlib import Path
from typing import BinaryIO, List, Tuple, Union

import numpy as np

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
