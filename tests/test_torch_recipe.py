"""``recipes/run_baseline_torch.sh``, stages 5-11 of the recipe through the
port, against ``recipes/run_baseline.sh``.

- Each stage block from 5 to 11 is JAX's with ``s2st_tpu.`` replaced by
  ``s2st_tpu_torch.``, line for line; the variables of both scripts are
  the same, and the port's sources the same ``parse_options.sh``.
- ``bash -n`` passes.
- A stage below 5 refuses (stages 1-3 are not ported) and runs nothing.
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
    assert sorted(port) == list(range(5, 12))
    assert sorted(jax) == [1, 2, 3] + list(range(5, 12))
    for n in range(5, 12):
        assert port[n] == jax[n].replace("s2st_tpu.", "s2st_tpu_torch."), n
        assert "s2st_tpu." not in port[n].replace("s2st_tpu_torch.", "")
    assert variables(PORT_RECIPE) == variables(JAX_RECIPE)
    assert '. "$(dirname "$0")/parse_options.sh"' in PORT_RECIPE.read_text()


@pytest.mark.parametrize("path", [PORT_RECIPE, JAX_RECIPE])
def test_bash_parses(path):
    res = subprocess.run(["bash", "-n", str(path)], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr


def _env(tmp_path, **extra):
    return dict(os.environ, AUDIO_MANIFEST_ROOT=str(tmp_path / "manifests"),
                FEATURE_MANIFEST_ROOT=str(tmp_path / "features"),
                SAVE_DIR=str(tmp_path / "save"), PYTHONPATH=str(REPO),
                **extra)


@pytest.mark.parametrize("stage", ["1", "3", "4"])
def test_stages_below_5_refuse(tmp_path, stage):
    res = subprocess.run(["bash", str(PORT_RECIPE), "--stage", stage],
                         env=_env(tmp_path), capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 1
    assert "not ported" in res.stderr
    assert not (tmp_path / "save").exists()


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
            env=_env(tmp_path, JAX_PLATFORMS="cpu",
                     PATH=f"{Path(sys.executable).parent}:"
                          f"{os.environ['PATH']}"),
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        lines[script.name] = res.stdout.strip().splitlines()[-1]
    assert lines["run_baseline_torch.sh"] == lines["run_baseline.sh"]
    assert lines["run_baseline.sh"].startswith("BLEU = ")
