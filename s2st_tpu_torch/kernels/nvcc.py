"""Build and load the port's hand-written CUDA kernels.

Every source under ``csrc/`` has a plain C interface. On first use on a CUDA
machine it is compiled for ``sm_90a`` by ``nvcc`` into a shared library under
``build/kernels/`` (git-ignored), named by the hash of the source and of
the headers beside it, and loaded with ctypes. ``build()`` compiles every
source that is not built yet, one ``nvcc`` a source, all started together.
Nothing here runs at import time, so the CPU tests can import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# library name -> (source, C symbol, ctypes argument types)
LIBRARIES = {
    "flash_attention": ("flash_attention.cu", "s2st_flash_attention_fwd",
                        [_P] * 7 + [_LL] * 13 + [_I] * 7 + [_P]),
    "flash_attention_bwd": ("flash_attention_bwd.cu",
                            "s2st_flash_attention_bwd",
                            [_P] * 9 + [_LL] + [_P] * 4 + [_I] * 7 + [_P]),
    "lightconv": ("lightconv.cu", "s2st_lightconv_fwd",
                  [_P] * 3 + [_LL] * 3 + [_I] * 6 + [_P]),
    "dynamicconv": ("dynamicconv.cu", "s2st_dynamicconv_fwd",
                    [_P] * 3 + [_LL] * 3 + [_I] * 7 + [_P]),
}


def source(name: str) -> Path:
    return _CSRC / LIBRARIES[name][0]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def lib_path(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}_{tag}.so"


def _compile(names: Iterable[str]) -> None:
    """Build the named libraries that are not built yet, one nvcc a source,
    all started together; the ptxas report goes beside each library."""
    jobs = []
    for name in names:
        path = lib_path(name)
        if path.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(source(name))]
        jobs.append((path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for path, tmp, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for "
                          f"{path.name}:\n{log}")
            continue
        (BUILD_DIR / f"{path.stem}.ptxas.txt").write_text(log.strip())
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def function(name: str):
    """The C entry point of one library, built (once per source version)
    and loaded; it returns the launch's cudaError_t."""
    _compile([name])
    _, symbol, argtypes = LIBRARIES[name]
    fn = getattr(ctypes.CDLL(str(lib_path(name))), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named libraries (every one by default) in parallel and load
    them; returns {name: library path}."""
    names = list(LIBRARIES if names is None else names)
    _compile(names)
    for name in names:
        function(name)
    return {name: lib_path(name) for name in names}
