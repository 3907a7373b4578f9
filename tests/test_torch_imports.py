"""The port stands alone, and its entry points never fall back to the CPU.

- Importing every module of s2st_tpu_torch (and chip_smoke.py) in a fresh
  interpreter loads neither jax nor any module of s2st_tpu, nor sacrebleu
  or matplotlib (the card's machine has neither).
- Without a CUDA card the serving, training, text generation and
  generate_for_s2st CLIs raise unless ``--device cpu`` is given, and
  chip_smoke.py exits non-zero with no result line, as it does from a directory that holds nothing else of the
  repository.
- The tests' shared helper keeps the JAX CLIs' compilation cache inside
  the test process.
"""

import functools
import os
import re
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
             or m == "s2st_tpu" or m.startswith("s2st_tpu.")
             or m.split(".")[0] in ("sacrebleu", "matplotlib"))
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
    assert int(n) >= 25
    for name in ("train.losses", "train.optim", "train.trainer",
                 "data.dictionary", "data.s2st_dataset", "cli.train",
                 "kernels.nvcc", "kernels.conv", "data.indexed_dataset",
                 "data.language_pair_dataset", "tasks.translation",
                 "models.lightconv_model", "models.lightconv_args",
                 "generate.sequence_generator", "scoring", "cli.generate",
                 "data.iterators", "train.checkpoint", "train.ema",
                 "cli.average_checkpoints", "tasks.s2s_translation",
                 "ops.mcd", "cli.generate_for_s2st", "models.hubert"):
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


def test_generate_for_s2st_cli_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from s2st_tpu_torch.cli import generate_for_s2st
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_for_s2st.main([str(tmp_path), "--path", "x.npz"])


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
    """Asynchronous saves wait for a later slice, with validation on or
    off; validation and its flags are ported and pass the check."""
    from s2st_tpu_torch.cli import train
    off = "--disable-validation"
    for flags in (["--write-checkpoints-asynchronously"],
                  [off, "--write-checkpoints-asynchronously"]):
        with pytest.raises(NotImplementedError, match="not ported"):
            train.main([str(tmp_path), "--device", "cpu", *flags])
    for flags in (["--eval-inference"], [],
                  ["--validate-interval-updates", "5"], ["--patience", "3"],
                  ["--valid-subset", "dev", "--validate-after-updates",
                   "10", "--lr-scheduler", "reduce_lr_on_plateau"]):
        train.check_args(train.get_parser().parse_args(
            [str(tmp_path), "--device", "cpu", *flags]))


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


def test_attention_tiles_fails_without_card_and_imports_no_jax():
    """attention_tiles.py, the bf16 attention kernels' block-shape sweep,
    exits non-zero with no result line here, and importing it loads
    neither jax nor s2st_tpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = _run([str(REPO / "attention_tiles.py")])
    assert res.returncode != 0
    assert "attention_tiles {" not in res.stdout
    res = _run("import sys, attention_tiles; print(sorted(m for m in "
               "sys.modules if m.split('.')[0] in ('jax', 's2st_tpu')))")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


@pytest.mark.parametrize("w,s", [(2, 4), (4, 2), (4, 1)])
def test_attention_tiles_forces_each_block_shape(w, s, tmp_path):
    """A forced copy's launchers take (w, s) at every grid, in the forward
    and in both backward kernels, and leave the rest of each source as it
    is."""
    sys.path.insert(0, str(REPO))
    try:
        import attention_tiles
    finally:
        sys.path.remove(str(REPO))
    root = attention_tiles.forced_copy(w, s, under=tmp_path)
    csrc = root / "s2st_tpu_torch" / "csrc"
    for name, calls in (
            ("flash_attention.cu", [f"launch_tiles<{w}, {s}, NK>"]),
            ("flash_attention_bwd.cu", [f"launch_dq<{w}, {s}, NK>",
                                        f"launch_dkdv<{w}, {s}, NK>"])):
        forced = (csrc / name).read_text()
        body = forced.split("cudaError_t launch_shape(")[1].split("\n}\n")[0]
        assert "tiles_for" not in body
        for call in calls:
            assert call in body, (name, call)
        original = (REPO / "s2st_tpu_torch" / "csrc" / name).read_text()
        strip = functools.partial(re.sub, attention_tiles._LAUNCH_SHAPE,
                                  r"\1\3", flags=re.S)
        assert strip(forced) == strip(original)


@pytest.mark.parametrize("r,k", [(64, 32), (32, 32), (64, 64)])
def test_attention_tiles_forces_each_fp32_block_shape(r, k, tmp_path):
    """A forced fp32 copy takes r-query blocks at every grid and streams
    k-key tiles, and leaves the rest of the source as it is."""
    sys.path.insert(0, str(REPO))
    try:
        import attention_tiles
    finally:
        sys.path.remove(str(REPO))
    root = attention_tiles.fp32_copy(r, k, under=tmp_path)
    forced = (root / "s2st_tpu_torch" / "csrc" /
              "flash_attention.cu").read_text()
    rows = forced.split("inline int rows_for(int bh, int Tq) {\n")[1]
    assert rows.startswith(f"  return {r};\n}}\n")
    fp32 = forced.split("namespace fp32 {")[1]
    assert f"constexpr int kKeys = {k};" in fp32.split("\n\n")[1]
    original = (REPO / "s2st_tpu_torch" / "csrc" /
                "flash_attention.cu").read_text()
    strip = functools.partial(re.sub, attention_tiles._FP32_ROWS, r"\1\3",
                              flags=re.S)
    keys = functools.partial(re.sub, attention_tiles._FP32_KEYS, r"\g<1>K",
                             flags=re.S)
    assert keys(strip(forced)) == keys(strip(original))


@pytest.mark.parametrize("shape", [(64, 16, 32, 16, 32),
                                   (32, 16, 64, 32, 16)])
def test_attention_tiles_forces_each_fp32_backward_block_shape(shape,
                                                               tmp_path):
    """A forced fp32-backward copy launches dQ and dK/dV in the given
    block shapes and tile height at every grid, and leaves the rest of the
    source as it is."""
    rq, gq, rk, gk, t = shape
    sys.path.insert(0, str(REPO))
    try:
        import attention_tiles
    finally:
        sys.path.remove(str(REPO))
    root = attention_tiles.fp32_bwd_copy(*shape, under=tmp_path)
    forced = (root / "s2st_tpu_torch" / "csrc" /
              "flash_attention_bwd.cu").read_text()
    body = forced.split("cudaError_t launch_shapes(")[1].split("\n}\n")[0]
    assert "rows_for" not in body and "short_tiles" not in body
    assert f"launch_dq_fp32<Dp, {rq}, {gq}, {t}>" in body
    assert f"launch_dkdv_fp32<Dp, {rk}, {gk}, {t}>" in body
    original = (REPO / "s2st_tpu_torch" / "csrc" /
                "flash_attention_bwd.cu").read_text()
    strip = functools.partial(re.sub, attention_tiles._FP32_BWD_SHAPES,
                              r"\1\3", flags=re.S)
    assert strip(forced) == strip(original)


def test_chip_smoke_conv_timing_fails_without_card():
    """chip_smoke.py --conv-timing, the conv kernels' timing across trees,
    exits non-zero with no result line here, with or without trees."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for extra in ([], [str(REPO)]):
        res = _run([str(REPO / "chip_smoke.py"), "--conv-timing", *extra])
        assert res.returncode != 0
        assert "conv_timing {" not in res.stdout


def test_chip_smoke_fp32_update_timing_fails_without_card():
    """chip_smoke.py --fp32-update-timing, the fp32 update's timing across
    trees, exits non-zero with no result line here, with or without
    trees."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for extra in ([], [str(REPO)]):
        res = _run([str(REPO / "chip_smoke.py"), "--fp32-update-timing",
                    *extra])
        assert res.returncode != 0
        assert "fp32_update {" not in res.stdout


def test_conv_batch_sums_follow_the_path_kernel_sizes():
    """A beam batch sums the encoder's 7 launches (K = 3, 7, 15, 31 x 4),
    a --score-reference batch the decoder's 6 (3, 7, 15, 31 x 3) on top."""
    recs = {f"{side}_K{k}": {"kernel_graph_ms": k * scale,
                             "bound_ms": scale}
            for side, scale in (("encoder", 1.0), ("decoder", 100.0))
            for k in (3, 7, 15, 31)}
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    sums = chip_smoke.conv_batch_sums(recs)
    assert sums["batch_ms"] == {"beam": 149.0,
                                "score_reference": 149.0 + 11800.0}
    assert sums["batch_bound_ms"] == {"beam": 7.0,
                                      "score_reference": 607.0}
