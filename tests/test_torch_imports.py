"""The port stands alone, and its entry points never fall back to the CPU.

- Importing every module of s2st_tpu_torch (and chip_smoke.py) in a fresh
  interpreter loads neither jax nor any module of s2st_tpu.
- Without a CUDA card the serving CLI raises unless ``--device cpu`` is
  given, and chip_smoke.py exits non-zero with no result line, as it does
  from a directory that holds nothing else of the repository.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import s2st_tpu_torch
names = [m.name for m in pkgutil.walk_packages(s2st_tpu_torch.__path__,
                                               "s2st_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "s2st_tpu" or m.startswith("s2st_tpu."))
print(len(names), bad)
"""


def _run(code_or_args, cwd=REPO, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    args = [sys.executable] + (["-c", code_or_args]
                               if isinstance(code_or_args, str)
                               else code_or_args)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_neither_jax_nor_s2st_tpu():
    res = _run(_IMPORT_ALL)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 15
    assert bad == "[]", bad


def test_cli_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from s2st_tpu_torch.cli import generate_waveform
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_waveform.main([str(tmp_path), "--path", "x.npz",
                                "--results-path", str(tmp_path / "out")])


@pytest.mark.parametrize("where", ["repo", "bare"])
def test_chip_smoke_fails_without_card_or_repo(where, tmp_path):
    """No CUDA here, or no package beside the script: a non-zero exit and
    no result line."""
    if where == "repo":
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        res = _run([str(REPO / "chip_smoke.py")])
    else:
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        res = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
