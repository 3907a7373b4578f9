"""Non-finite reports, the heartbeat watchdog and the profiler.

Counterpart of ``s2st_tpu/utils/diagnostics.py``:

- ``find_nonfinite`` / ``report_nonfinite`` (:38-63): the names of the
  tensors holding non-finite values, each with its count, over named
  tensors (a mapping of names to tensors, nested mappings joined with
  ``/``; other values are skipped); the finiteness of every tensor reaches
  the host in one transfer. The train CLI names the parameters by their
  JAX paths, so the report reads as JAX's.
- ``HeartbeatWatchdog`` (:70-108): a daemon thread sends the process
  SIGINT when ``beat()`` has not been called for ``timeout`` seconds.
- ``Profiler`` / ``profile`` (:115-124): a ``torch.profiler`` trace of the
  host and, where there is one, the CUDA device, written as a Chrome trace
  (``trace.json``) into ``PROFILE_DIR``, the port's own directory under
  the temporary directory, where JAX writes ``/tmp/s2st_tpu_profile``.

JAX's ``CompileWatchdog`` watches its compilations and has no counterpart.
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import tempfile
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

PROFILE_DIR = os.path.join(tempfile.gettempdir(), "s2st_tpu_torch_profile")


def _named(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


def find_nonfinite(tree: Dict[str, Any], prefix: str = "") -> List[str]:
    """``<prefix><name> (<n>/<size> non-finite)`` for every floating tensor
    of ``tree`` with a non-finite value."""
    named = [(n, t) for n, t in _named(tree)
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    if not named:
        return []
    bad_counts = torch.stack([(~torch.isfinite(t.detach())).sum()
                              for _, t in named]).cpu().tolist()
    return [f"{prefix}{n} ({c}/{t.numel()} non-finite)"
            for (n, t), c in zip(named, bad_counts) if c]


def report_nonfinite(grads=None, params=None, batch=None) -> str:
    """Every non-finite tensor of the given trees, one a line, or ``no
    non-finite values found``."""
    lines = []
    for name, tree in (("grads", grads), ("params", params),
                       ("batch", batch)):
        if tree is not None:
            lines.extend(find_nonfinite(tree, prefix=f"{name}:"))
    return "\n".join(lines) if lines else "no non-finite values found"


class HeartbeatWatchdog:
    """Sends the process SIGINT if ``beat()`` is not called within
    ``timeout`` seconds; a timeout <= 0 watches nothing."""

    def __init__(self, timeout: float):
        self.timeout = timeout
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self.timeout <= 0:
            return self

        def run():
            while not self._stop.wait(min(self.timeout / 4, 5.0)):
                if time.monotonic() - self._last > self.timeout:
                    logger.error(
                        f"no heartbeat for {self.timeout}s; interrupting")
                    os.kill(os.getpid(), signal.SIGINT)
                    return
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="heartbeat")
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class Profiler:
    """A ``torch.profiler`` trace between ``start()`` and ``stop()``: the
    host's operators and, on a CUDA machine, the device's kernels and
    copies. ``stop()`` writes ``<logdir>/trace.json`` and returns its
    path."""

    def __init__(self, logdir: str = PROFILE_DIR):
        self.logdir = logdir
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> "Profiler":
        self._prof.__enter__()
        return self

    def stop(self) -> str:
        self._prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self._prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def profile(enabled: bool, logdir: str = PROFILE_DIR):
    """The ``--profile`` trace around a block."""
    if not enabled:
        yield
        return
    prof = Profiler(logdir).start()
    try:
        yield
    finally:
        prof.stop()
    logger.info(f"profiler trace written to {logdir}")
