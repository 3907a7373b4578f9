"""``recipes/run_baseline_torch.sh``, stages 1-11 of the recipe through the
port, against ``recipes/run_baseline.sh``.

- Each stage block (1-3, 5-11) is JAX's with ``s2st_tpu.`` replaced by
  ``s2st_tpu_torch.``, line for line; the variables of both scripts are
  the same, the default first stage too (3), and the port's sources the
  same ``parse_options.sh``.
- ``bash -n`` passes.
- A stage below 5 alone does what JAX's script does with the same
  environment: stage 1 without METADATA_TSVS refuses with JAX's message,
  stage 3 without manifests fails (here the port's CLI also finds no
  card), stage 4 runs nothing; none makes SAVE_DIR.
- Stages 1-3 run by each script over the same seeded WAV pairs (two
  speakers, one target row with Latin letters, which stage 2 drops) give
  byte-identical manifests, TSVs, vocabularies, speakers.txt and
  config.yaml once the feature root is replaced, and features within
  1e-5 (the port's stage 3 on the CPU through a ``python`` on the PATH
  that adds ``--device cpu`` to that one module's line).
- Stage 9 alone, run by each script on one decode.txt and four reference
  files, prints the same multi-reference BLEU line.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_RECIPE = REPO / "recipes" / "run_baseline.sh"
PORT_RECIPE = REPO / "recipes" / "run_baseline_torch.sh"


def stage_blocks(path: Path) -> dict:
    """{stage: the text of its ``if [ "${stage}" -le N ] ...`` block}."""
    text = path.read_text()
    starts = [(int(m.group(1)), m.start()) for m in re.finditer(
        r'^if \[ "\$\{stage\}" -le (\d+) \]', text, flags=re.M)]
    blocks = {}
    for i, (n, at) in enumerate(starts):
        end = starts[i + 1][1] if i + 1 < len(starts) else len(text)
        blocks[n] = text[at:end].rstrip()
    return blocks


def variables(path: Path) -> list:
    return sorted(set(re.findall(r"^([a-zA-Z_]+)=\$\{", path.read_text(),
                                 flags=re.M)))


def test_stage_lines_equal_jax_with_the_port_package():
    jax, port = stage_blocks(JAX_RECIPE), stage_blocks(PORT_RECIPE)
    assert sorted(port) == sorted(jax) == [1, 2, 3] + list(range(5, 12))
    for n in sorted(jax):
        assert port[n] == jax[n].replace("s2st_tpu.", "s2st_tpu_torch."), n
        assert "s2st_tpu." not in port[n].replace("s2st_tpu_torch.", "")
    assert variables(PORT_RECIPE) == variables(JAX_RECIPE)
    assert '. "$(dirname "$0")/parse_options.sh"' in PORT_RECIPE.read_text()
    for path in (PORT_RECIPE, JAX_RECIPE):
        assert "\nstage=${stage:-3}\n" in path.read_text()


@pytest.mark.parametrize("path", [PORT_RECIPE, JAX_RECIPE])
def test_bash_parses(path):
    res = subprocess.run(["bash", "-n", str(path)], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr


def _env(tmp_path, **extra):
    return {**os.environ, "AUDIO_MANIFEST_ROOT": str(tmp_path / "manifests"),
            "FEATURE_MANIFEST_ROOT": str(tmp_path / "features"),
            "SAVE_DIR": str(tmp_path / "save"), "PYTHONPATH": str(REPO),
            **extra}


@pytest.mark.parametrize("stage", ["1", "3", "4"])
def test_stages_below_5_refuse(tmp_path, stage):
    """A stage below 5 alone, without its inputs: the port's script exits
    as JAX's does and makes no SAVE_DIR."""
    res = {}
    for script in (JAX_RECIPE, PORT_RECIPE):
        res[script.name] = subprocess.run(
            ["bash", str(script), "--stage", stage, "--stop-stage", stage],
            env=_env(tmp_path, JAX_PLATFORMS="cpu", PATH=_path()),
            capture_output=True, text=True, timeout=120)
        assert not (tmp_path / "save").exists()
    port, jax = res["run_baseline_torch.sh"], res["run_baseline.sh"]
    assert port.returncode == jax.returncode == (0 if stage == "4" else 1)
    if stage == "1":
        assert "stage 1 needs METADATA_TSVS" in port.stdout == jax.stdout


def _path() -> str:
    return f"{Path(sys.executable).parent}:{os.environ['PATH']}"


def _run_stages_1_3(script, tmp_path, specs, wav_root, out, bin_dir=None):
    env = _env(tmp_path, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PATH=(f"{bin_dir}:" if bin_dir else "") + _path(),
               AUDIO_MANIFEST_ROOT=str(out / "manifests"),
               FEATURE_MANIFEST_ROOT=str(out / "features"),
               METADATA_TSVS=" ".join(specs),
               AUDIO_DATA_ROOT=str(wav_root))
    res = subprocess.run(["bash", str(script), "--stage", "1",
                          "--stop-stage", "3", "--g2p-nj", "2"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]


def test_stages_1_to_3_match_jax(tmp_path):
    import numpy as np
    from s2st_tpu_torch.data.audio_utils import get_features_or_waveform
    from tests._torch_port import write_wav_pairs
    specs = write_wav_pairs(tmp_path / "raw", latin_row=True)
    # the port's stage 3 runs on this CPU: its one line gains --device cpu
    shim = tmp_path / "bin"
    shim.mkdir()
    (shim / "python").write_text(
        '#!/bin/sh\nif [ "$2" = s2st_tpu_torch.cli.get_feature_manifest ]'
        f'; then exec "{sys.executable}" "$@" --device cpu; fi\n'
        f'exec "{sys.executable}" "$@"\n')
    (shim / "python").chmod(0o755)
    jax, port = tmp_path / "jax", tmp_path / "port"
    _run_stages_1_3(JAX_RECIPE, tmp_path, specs, tmp_path / "raw" / "wavs",
                    jax)
    _run_stages_1_3(PORT_RECIPE, tmp_path, specs, tmp_path / "raw" / "wavs",
                    port, shim)
    want = sorted(p.relative_to(jax).as_posix() for p in jax.rglob("*")
                  if p.is_file() and "/log/" not in p.as_posix())
    got = sorted(p.relative_to(port).as_posix() for p in port.rglob("*")
                 if p.is_file() and "/log/" not in p.as_posix())
    assert got == want
    assert "features/config.yaml" in want and \
        "manifests/train.audio_phone.tsv" in want
    for name in want:
        if name.endswith(".zip") or name.endswith(".npz"):
            continue
        text = (jax / name).read_bytes().replace(str(jax).encode(),
                                                 str(port).encode())
        assert (port / name).read_bytes() == text, name
    rows = (port / "features" / "train.tsv").read_text().splitlines()[1:]
    assert len(rows) == 3          # one of 4 dropped for its Latin target
    for split in ("train", "dev", "tst"):
        for line in (port / "features" / f"{split}.tsv").read_text() \
                .splitlines()[1:]:
            for col in (1, 2):
                path = line.split("\t")[col]
                np.testing.assert_allclose(
                    get_features_or_waveform(path),
                    get_features_or_waveform(path.replace(str(port),
                                                          str(jax))),
                    atol=1e-5, rtol=0)
    for name in ("src_gcmvn_stats.npz", "tgt_gcmvn_stats.npz"):
        a, b = (np.load(root / "features" / name) for root in (port, jax))
        for key in ("mean", "std"):
            np.testing.assert_allclose(a[key], b[key], atol=1e-5, rtol=0)


def test_stage9_prints_jax_line(tmp_path):
    pytest.importorskip("sacrebleu")
    dump = tmp_path / "save" / "dump_wav_tst"
    dump.mkdir(parents=True)
    hyps = ["the cat sat on the mat", "a quick brown fox", "", "hello"]
    (dump / "decode.txt").write_text("".join(
        f"{h}\tref\tu{i}\n" for i, h in enumerate(hyps)))
    refs = tmp_path / "refs"
    refs.mkdir()
    words = ["the cat sat on a mat", "the quick brown fox", "x", "hello you"]
    for k in range(4):
        (refs / f"en.{k}.norm.lc.rm").write_text(
            "\n".join(" ".join(w.split()[k % 2:]) or "y" for w in words)
            + "\n")
    lines = {}
    for script in (JAX_RECIPE, PORT_RECIPE):
        res = subprocess.run(
            ["bash", str(script), "--stage", "9", "--stop-stage", "9",
             "--multi-ref-dir", str(refs)],
            env=_env(tmp_path, JAX_PLATFORMS="cpu", PATH=_path()),
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        lines[script.name] = res.stdout.strip().splitlines()[-1]
    assert lines["run_baseline_torch.sh"] == lines["run_baseline.sh"]
    assert lines["run_baseline.sh"].startswith("BLEU = ")
