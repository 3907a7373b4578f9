"""Batched DTW and the mel-cepstral distortion of the MCD validation metric.

Counterpart of ``s2st_tpu/ops/mcd.py``: ``rms_dist_matrix`` (:27),
``batch_dtw`` (:35-99) and ``batch_mcd`` (:102-122). The DP runs over the
M + N - 1 anti-diagonals of the (M, N) distance matrix, each diagonal a few
batched ops over (B, M) rows (row i of diagonal k is cell (i, k - i)); its
pointers (0 = left, 1 = up-left, 2 = up; the lowest pointer among equal
costs) are copied to the host once, where the backtrace counts each path's
length with JAX's forced moves along the borders (i == 0 moves left, j == 0
moves up). Cells off the matrix hold ``INF`` = 1e30, which every sum that
reaches them is clamped back to, as JAX's ``where(d >= INF, INF, ...)``
does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .dsp import mfcc

INF = 1e30


def rms_dist_matrix(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(B, M, D), (B, N, D) -> (B, M, N) RMS distance, sqrt(|a - b|^2 / D)
    through the expanded square, as JAX computes it."""
    d2 = (x1.pow(2).sum(-1)[:, :, None] + x2.pow(2).sum(-1)[:, None, :]
          - 2.0 * torch.bmm(x1, x2.transpose(1, 2)))
    return torch.sqrt(torch.clamp(d2, min=0.0) / x1.shape[-1])


def _skewed(dist: torch.Tensor) -> torch.Tensor:
    """(K, B, M): diagonal k, row i holds dist[:, i, k - i], INF off the
    matrix; one gather through precomputed indices."""
    b, m, n = dist.shape
    dev = dist.device
    k = torch.arange(m + n - 1, device=dev)[:, None]
    i = torch.arange(m, device=dev)[None, :]
    j = k - i
    valid = (j >= 0) & (j < n)
    flat = (i * n + j.clamp(0, n - 1)).reshape(-1)
    vals = dist.reshape(b, m * n)[:, flat].reshape(b, m + n - 1, m)
    return torch.where(valid[None], vals, INF).permute(1, 0, 2).contiguous()


def dtw_pointers(dist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DP on the device. dist (B, M, N) fp32. Returns (cumulative
    costs (K + 1, B, M + 1), row k + 1 diagonal k, column 0 and row 0
    INF; pointers (K, B, M) int64)."""
    b, m, n = dist.shape
    n_diags = m + n - 1
    skew = _skewed(dist.float())
    diags = torch.full((n_diags + 1, b, m + 1), INF, device=dist.device)
    ptrs = torch.zeros((n_diags, b, m), dtype=torch.long, device=dist.device)
    best = torch.empty((b, m), device=dist.device)
    diags[1, :, 1:] = skew[0]          # the origin has no predecessor
    for k in range(1, n_diags):
        prev1, prev2 = diags[k], diags[k - 1]
        cand = torch.stack([prev1[:, 1:], prev2[:, :-1], prev1[:, :-1]], -1)
        torch.min(cand, -1, out=(best, ptrs[k]))
        cur = diags[k + 1, :, 1:]
        torch.add(skew[k], best, out=cur)
        cur.clamp_(max=INF)
    return diags, ptrs


def _wrap(idx: np.ndarray, size: int) -> np.ndarray:
    """JAX's gather index: negative counts from the end, then clamped."""
    return np.clip(np.where(idx < 0, idx + size, idx), 0, size - 1)


def backtrace_lengths(ptrs: np.ndarray, m_lens: np.ndarray,
                      n_lens: np.ndarray) -> np.ndarray:
    """Path lengths (B,) from the end cell back to the origin, the end cell
    counted; a row with no frames on either side counts 1."""
    b = ptrs.shape[1]
    rows = np.arange(b)
    i = np.maximum(m_lens - 1, 0)
    j = np.maximum(n_lens - 1, 0)
    done = (m_lens <= 0) | (n_lens <= 0)
    steps = np.ones((b,), np.int64)
    for _ in range(int(ptrs.shape[0]) + 1):
        done = done | ((i == 0) & (j == 0))
        if done.all():
            break
        p = ptrs[i + j, rows, i]
        p = np.where(i == 0, 0, np.where(j == 0, 2, p))
        i = np.where(done, i, np.maximum(i - ((p == 1) | (p == 2)), 0))
        j = np.where(done, j, np.maximum(j - ((p == 0) | (p == 1)), 0))
        steps += ~done
    return steps


def batch_dtw(dist: torch.Tensor, m_lens: torch.Tensor, n_lens: torch.Tensor
              ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Unconstrained DTW of each row's valid (m, n) corner of the padded
    dist (B, M, N). Returns (distortion (B,) = the cumulative cost at
    (m - 1, n - 1), on dist's device; nins = path length - m and ndel =
    path length - n, (B,) int64 numpy)."""
    b, m, n = dist.shape
    diags, ptrs = dtw_pointers(dist)
    ml = m_lens.cpu().numpy().astype(np.int64)
    nl = n_lens.cpu().numpy().astype(np.int64)
    last_k = torch.from_numpy(_wrap(ml + nl - 2, m + n - 1) + 1)
    col = torch.from_numpy(_wrap(ml - 1, m) + 1)
    distortion = diags[last_k.to(dist.device), torch.arange(b,
                       device=dist.device), col.to(dist.device)]
    path = backtrace_lengths(ptrs.to(torch.int8).cpu().numpy(), ml, nl)
    return distortion, path - ml, path - nl


def batch_mcd(pred_wave: torch.Tensor, pred_lens: torch.Tensor,
              targ_wave: torch.Tensor, targ_lens: torch.Tensor,
              sample_rate: int = 16000, lap=None) -> Dict[str, float]:
    """MCD sums over a padded batch of waveforms: mcd_loss, targ_frames,
    pred_frames, nins, ndel (``batch_mcd`` :102-122). Every row counts,
    a row of length 0 too (its MFCC has 1 frame). Padded MFCC frames are
    zeroed before the distances. lap(name), when given, is called after
    the MFCCs and after the DTW."""
    targ_mfcc, m_lens = mfcc(targ_wave, targ_lens, sample_rate)
    pred_mfcc, n_lens = mfcc(pred_wave, pred_lens, sample_rate)
    tmask = torch.arange(targ_mfcc.shape[1], device=targ_mfcc.device
                         )[None, :, None] < m_lens[:, None, None]
    pmask = torch.arange(pred_mfcc.shape[1], device=pred_mfcc.device
                         )[None, :, None] < n_lens[:, None, None]
    targ_mfcc = torch.where(tmask, targ_mfcc, 0.0)
    pred_mfcc = torch.where(pmask, pred_mfcc, 0.0)
    if lap is not None:
        lap("mfcc")
    dist = rms_dist_matrix(targ_mfcc, pred_mfcc)
    distortion, nins, ndel = batch_dtw(dist, m_lens, n_lens)
    out = {"mcd_loss": float(distortion.sum()),
           "targ_frames": float(m_lens.sum()),
           "pred_frames": float(n_lens.sum()),
           "nins": float(nins.sum()), "ndel": float(ndel.sum())}
    if lap is not None:
        lap("dtw")
    return out
