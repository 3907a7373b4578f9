"""Metrics aggregation and progress logging.

The port's own copy of ``s2st_tpu/logging_utils.py`` (which imports no
JAX, but the port imports nothing of the JAX package): meters
(``AverageMeter``, ``SumMeter``, ``SpeedMeter``, ``MetersDict``, the
nested ``aggregate`` contexts, ``log_scalar``/``log_sum``/``log_speed``/
``log_derived``) and ``ProgressLogger`` with the ``simple``, ``json`` and
``tqdm`` formats, TensorBoard through ``torch.utils.tensorboard``, and the
wandb and azureml sinks. Each optional library is imported where JAX
imports it, with JAX's warning where it is absent, and every line is
JAX's, through this module's logger. ``log_file`` adds a file handler to
the ``s2st_tpu_torch`` package logger, as JAX's does to ``s2st_tpu``.
"""

from __future__ import annotations

import json
import logging
import math
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


class AverageMeter:
    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: float = 1.0):
        if val is not None and not (isinstance(val, float) and math.isnan(val)):
            self.sum += float(val) * n
            self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count > 0 else 0.0

    @property
    def smoothed_value(self) -> float:
        v = self.avg
        return round(v, self.round) if self.round is not None else v


class SumMeter(AverageMeter):
    @property
    def avg(self) -> float:
        return self.sum


class SpeedMeter:
    """Items/sec since start (wps/ups parity)."""

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def reset(self):
        self.start = time.perf_counter()
        self.n = 0.0

    def update(self, val: float, n: float = 1.0):
        self.n += val

    @property
    def avg(self) -> float:
        dt = time.perf_counter() - self.start
        return self.n / dt if dt > 0 else 0.0

    @property
    def smoothed_value(self) -> float:
        v = self.avg
        return round(v, self.round) if self.round is not None else v


class MetersDict(OrderedDict):
    def get_smoothed_values(self) -> Dict[str, float]:
        out = {}
        for k, m in self.items():
            if k.startswith("_"):
                continue
            if isinstance(m, _Derived):
                out[k] = m.fn(self)
            else:
                out[k] = m.smoothed_value
        return out


class _Derived:
    def __init__(self, fn: Callable[[MetersDict], float]):
        self.fn = fn


_aggregators: Dict[str, MetersDict] = {}
_active: List[str] = ["default"]
_aggregators["default"] = MetersDict()


@contextmanager
def aggregate(name: Optional[str] = None, new_root: bool = False):
    """Nested aggregation context (metrics.py:44-104 parity): scalars logged
    inside go to this aggregator and (unless new_root) all enclosing ones."""
    if name is None:
        name = f"_anon_{len(_aggregators)}"
    agg = _aggregators.setdefault(name, MetersDict())
    if new_root:
        saved, _active[:] = _active[:], [name]
    else:
        _active.append(name)
    try:
        yield agg
    finally:
        if new_root:
            _active[:] = saved
        else:
            _active.remove(name)


def reset_meters(name: str):
    if name in _aggregators:
        _aggregators[name].clear()


def get_meters(name: str) -> MetersDict:
    return _aggregators.setdefault(name, MetersDict())


def log_scalar(key: str, value: float, weight: float = 1.0,
               priority: int = 10, round: Optional[int] = None):
    for name in _active:
        agg = _aggregators[name]
        if key not in agg:
            agg[key] = AverageMeter(round=round)
        agg[key].update(value, weight)


def log_sum(key: str, value: float, priority: int = 10):
    for name in _active:
        agg = _aggregators[name]
        if key not in agg:
            agg[key] = SumMeter()
        agg[key].update(value)


def log_speed(key: str, value: float, priority: int = 10,
              round: Optional[int] = None):
    for name in _active:
        agg = _aggregators[name]
        if key not in agg:
            agg[key] = SpeedMeter(round=round)
        agg[key].update(value)


def log_derived(key: str, fn: Callable[[MetersDict], float],
                priority: int = 10):
    for name in _active:
        _aggregators[name].setdefault(key, _Derived(fn))


def get_smoothed_values(name: str) -> Dict[str, float]:
    return get_meters(name).get_smoothed_values()


# ---------------------------------------------------------------------------
# progress output
# ---------------------------------------------------------------------------

class ProgressLogger:
    """json-lines or simple progress output (progress_bar.py parity),
    optional TensorBoard event writing."""

    def __init__(self, log_format: str = "simple", log_interval: int = 100,
                 epoch: Optional[int] = None,
                 tensorboard_logdir: Optional[str] = None,
                 log_file: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 wandb_run_name: Optional[str] = None,
                 azureml_logging: bool = False):
        self.log_format = log_format
        self.log_interval = log_interval
        self.epoch = epoch
        # interactive tqdm bar (progress_bar.py:100-130 TqdmProgressBar):
        # wrap() attaches the bar to an epoch iterator; log() drives
        # set_postfix instead of emitting a line per interval
        self._bar = None
        if log_format == "tqdm":
            try:
                import tqdm as _tqdm  # noqa: F401
            except ImportError:
                logger.warning("tqdm not installed; falling back to simple")
                self.log_format = "simple"
        self._tb = None
        if tensorboard_logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_logdir)
            except Exception:
                logger.warning("tensorboard unavailable; skipping event logs")
        # Weights & Biases sink (reference --wandb-project,
        # progress_bar.py:392-436 WandBProgressBarWrapper); library-gated —
        # a warning, not an error, when wandb isn't installed.
        self._wandb = None
        if wandb_project:
            try:
                import wandb
                wandb.init(project=wandb_project, reinit=False,
                           name=wandb_run_name)
                self._wandb = wandb
            except Exception:
                logger.warning("wandb not found, pip install wandb")
        # AzureML sink (reference --azureml-logging,
        # progress_bar.py:445-481 AzureMLProgressBarWrapper)
        self._azureml = None
        if azureml_logging:
            try:
                from azureml.core import Run
                self._azureml = Run.get_context()
            except Exception:
                logger.warning("azureml.core not found, "
                               "pip install azureml-core")
        if log_file:
            handler = logging.FileHandler(log_file)
            handler.setFormatter(logging.Formatter(
                "%(asctime)s | %(levelname)s | %(name)s | %(message)s"))
            # --log-file must capture progress lines even when the embedding
            # process configured logging at WARNING (e.g. a test harness).
            # Scope everything to the package logger (never mutate foreign
            # or root handlers): file handler at INFO on
            # 's2st_tpu_torch' with propagate=False, plus a console handler that
            # keeps emitting at the process's previous effective threshold
            # so console verbosity is unchanged.
            pkg = logging.getLogger("s2st_tpu_torch")
            prev_level = pkg.getEffectiveLevel()
            handler.setLevel(logging.INFO)
            console = logging.StreamHandler()
            console.setLevel(prev_level)
            pkg.addHandler(console)
            pkg.addHandler(handler)
            pkg.setLevel(logging.INFO)
            pkg.propagate = False

    def _fmt(self, stats: Dict[str, Any], tag: str, step: int) -> str:
        stats = dict(stats)
        if self.epoch is not None:
            stats = {"epoch": self.epoch, **stats}
        if self.log_format == "json":
            return json.dumps({f"{tag}_{k}" if tag else k:
                               (round(v, 4) if isinstance(v, float) else v)
                               for k, v in stats.items()})
        body = " | ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in stats.items())
        return f"{tag} | {body}" if tag else body

    def wrap(self, iterable, prefix: Optional[str] = None):
        """Attach the interactive bar to an epoch iterator (TqdmProgressBar
        wraps the iterable, progress_bar.py:100-113). No-op for the
        line-oriented formats."""
        if self.log_format != "tqdm":
            return iterable
        from tqdm import tqdm
        try:
            total = len(iterable)
        except TypeError:
            total = None
        self._bar = tqdm(iterable, desc=prefix, total=total, leave=False)
        return self._bar

    def log(self, stats: Dict[str, Any], tag: str = "train_inner",
            step: int = 0):
        if self._bar is not None:
            # set_postfix parity (progress_bar.py:115-123): refresh the
            # bar's stat trailer instead of emitting one line per interval
            self._bar.set_postfix({k: (f"{v:.4g}" if isinstance(v, float)
                                       else v) for k, v in stats.items()},
                                  refresh=False)
        else:
            logger.info(self._fmt(stats, tag, step))
        self._tb_write(stats, tag, step)
        self._sinks_write(stats, tag, step)

    def print(self, stats: Dict[str, Any], tag: str = "train", step: int = 0):
        if self._bar is not None:
            from tqdm import tqdm
            self._bar.close()
            self._bar = None
            tqdm.write(self._fmt(stats, tag, step))
        logger.info(self._fmt(stats, tag, step))
        self._tb_write(stats, tag, step)
        self._sinks_write(stats, tag, step)

    def _sinks_write(self, stats, tag, step):
        if self._wandb is not None:
            prefix = f"{tag}/" if tag else ""
            self._wandb.log({prefix + k: v for k, v in stats.items()
                             if isinstance(v, (int, float))}, step=step)
        if self._azureml is not None:
            prefix = f"{tag}/" if tag else ""
            for k, v in stats.items():
                if isinstance(v, (int, float)):
                    self._azureml.log(name=prefix + k, value=v)

    def _tb_write(self, stats, tag, step):
        if self._tb is None:
            return
        for k, v in stats.items():
            if isinstance(v, (int, float)):
                self._tb.add_scalar(f"{tag}/{k}", v, step)
        self._tb.flush()

    def log_audio(self, tag: str, wave, sample_rate: int, step: int = 0):
        """Validation audio panel (tasks/s2s_translation.py:266-310 parity)."""
        if self._tb is None:
            return
        import numpy as np
        w = np.asarray(wave, dtype=np.float32).reshape(-1)
        peak = max(float(np.abs(w).max()), 1e-8)
        self._tb.add_audio(tag, (w / peak)[None, :], step,
                           sample_rate=sample_rate)
        self._tb.flush()

    def log_spectrogram(self, tag: str, spec, step: int = 0):
        """(T, n_mels) spectrogram as a normalized image panel."""
        if self._tb is None:
            return
        import numpy as np
        s = np.asarray(spec, dtype=np.float32).T  # (mels, T)
        s = s - s.min()
        s = s / max(float(s.max()), 1e-8)
        self._tb.add_image(tag, s[None, ::-1, :], step)
        self._tb.flush()

    def log_attention(self, tag: str, attn, step: int = 0):
        if self._tb is None:
            return
        import numpy as np
        a = np.asarray(attn, dtype=np.float32)
        a = a / max(float(a.max()), 1e-8)
        self._tb.add_image(tag, a[None], step)
        self._tb.flush()
