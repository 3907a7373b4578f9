"""The port stands alone, and its entry points never fall back to the CPU.

- Importing every module of s2st_tpu_torch (and chip_smoke.py) in a fresh
  interpreter loads neither jax nor any module of s2st_tpu.
- Without a CUDA card the serving, training and text generation CLIs raise
  unless ``--device cpu`` is given, and chip_smoke.py exits non-zero with no
  result line, as it does from a directory that holds nothing else of the
  repository.
- The tests' shared helper keeps the JAX CLIs' compilation cache inside
  the test process.
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


def _run(code_or_args, cwd=REPO, timeout=120, **env_vars):
    env = dict(os.environ, PYTHONPATH=str(cwd), **env_vars)
    args = [sys.executable] + (["-c", code_or_args]
                               if isinstance(code_or_args, str)
                               else code_or_args)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_neither_jax_nor_s2st_tpu():
    res = _run(_IMPORT_ALL)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().split(" ", 1)
    assert int(n) >= 21
    for name in ("train.losses", "train.optim", "train.trainer",
                 "data.dictionary", "data.s2st_dataset", "cli.train",
                 "kernels.nvcc", "kernels.conv", "data.indexed_dataset",
                 "data.language_pair_dataset", "tasks.translation",
                 "models.lightconv_model", "models.lightconv_args",
                 "generate.sequence_generator", "scoring", "cli.generate"):
        assert f"s2st_tpu_torch.{name}" in _walk_names(), name
    assert bad == "[]", bad


_CACHE_DIR = """
import tests._torch_port
from s2st_tpu.utils.compilation_cache import enable_persistent_cache
print(enable_persistent_cache())
"""


def test_test_helper_gives_jax_cli_a_cache_of_its_process(tmp_path):
    """Importing the tests' shared helper points the JAX CLIs' compilation
    cache at a directory of that process, removed at its exit, whatever
    HOME or the environment named."""
    home = tmp_path / "home"
    res = _run(_CACHE_DIR, HOME=str(home),
               S2ST_TPU_COMPILATION_CACHE_DIR=str(home / "cache"),
               S2ST_TPU_NO_COMPILATION_CACHE="")
    assert res.returncode == 0, res.stderr
    got = Path(res.stdout.strip().splitlines()[-1])
    assert got.name.startswith("s2st_xla_cache_") and home not in got.parents
    assert not got.exists() and not (home / "cache").exists()


def _walk_names():
    import pkgutil
    import s2st_tpu_torch
    return {m.name for m in pkgutil.walk_packages(s2st_tpu_torch.__path__,
                                                  "s2st_tpu_torch.")}


def test_cli_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from s2st_tpu_torch.cli import generate_waveform
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_waveform.main([str(tmp_path), "--path", "x.npz",
                                "--results-path", str(tmp_path / "out")])


def test_train_cli_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from s2st_tpu_torch.cli import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main([str(tmp_path)])


def test_text_generate_cli_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from s2st_tpu_torch.cli import generate
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main([str(tmp_path), "--path", "x.npz"])


@pytest.mark.parametrize("flags", [["--sampling"],
                                   ["--diverse-beam-groups", "2"],
                                   ["--diversity-rate", "0.5"],
                                   ["--prefix-size", "1"],
                                   ["--constraints", "ordered"],
                                   ["--path", "a.npz:b.npz"]])
def test_text_generate_cli_refuses_later_slices_flags(tmp_path, flags):
    from s2st_tpu_torch.cli import generate
    with pytest.raises(NotImplementedError, match="not ported"):
        generate.main([str(tmp_path), "--path", "x.npz", "--device", "cpu",
                       *flags])


def test_train_cli_refuses_later_slices_flags(tmp_path):
    from s2st_tpu_torch.cli import train
    for flags in (["--update-freq", "2"], ["--restore-file", "x.npz"],
                  ["--eval-inference"], ["--store-ema"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            train.main([str(tmp_path), "--device", "cpu", *flags])


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
