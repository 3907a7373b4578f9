"""The port's manifest and corpus tools and ``recipes/
valide_during_train_torch.sh`` against JAX's, on the CPU.

- ``filter_manifest``: the same manifest, reference, exclusion list and
  frame bounds give JAX's TSV byte for byte (with and without a
  reference);
- ``doc_tools``: ``count_docs``' printout, ``shard_docs``' shards,
  ``split_train_valid_docs``' two files under the same ``random`` seed
  (documents and ``--lines``), and ``rm_pt``'s deletions and printout, all
  under ``tmp_path``, byte for byte;
- ``valide_during_train_torch.sh``: JAX's script with ``s2st_tpu.`` ->
  ``s2st_tpu_torch.`` and nothing else, and the ``python`` lines both run
  (recorded by a stub ``python``) equal with the package swapped.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from s2st_tpu.preprocessing import doc_tools as jdoc
from s2st_tpu.preprocessing import filter_manifest as jfilt
from s2st_tpu_torch.preprocessing import doc_tools as pdoc
from s2st_tpu_torch.preprocessing import filter_manifest as pfilt
from s2st_tpu_torch.preprocessing.manifest_utils import save_tsv

REPO = Path(__file__).resolve().parent.parent


def _rows(n=6):
    return [{"id": f"u{i}", "src_audio": f"a{i}.npy",
             "src_n_frames": str(90 * i), "src_text": f"s {i}",
             "tgt_audio": f"b{i}.npy", "tgt_n_frames": str(40 * i),
             "tgt_text": f"t {i}", "speaker": f"spk{i % 2}"}
            for i in range(1, n + 1)]


@pytest.mark.parametrize("with_reference", [True, False])
def test_filter_manifest_writes_jax_bytes(with_reference, tmp_path):
    man = tmp_path / "in.tsv"
    save_tsv(_rows(), man)
    ref = tmp_path / "ref.tsv"
    save_tsv([{"id": f"u{i}", "tgt_text": f"orig {i}", "other": "x"}
              for i in (1, 2, 4, 5, 6)], ref)
    bad = tmp_path / "bad.txt"
    bad.write_text("u2, bad case\n\nu 6\n")
    flags = ["--manifest", str(man), "--exclude-ids", str(bad),
             "--max-tgt-frames", "230", "--min-src-frames", "100"]
    if with_reference:
        flags += ["--reference-manifest", str(ref),
                  "--orig-text-column", "other"]
    outs = []
    for name, main in (("jax", jfilt.main), ("port", pfilt.main)):
        out = tmp_path / f"{name}.tsv"
        assert main(flags + ["--output", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b"\n") >= 2


def _write_docs(path, docs):
    with open(path, "w") as f:
        for i, d in enumerate(docs):
            if i:
                f.write("\n")
            for line in d:
                f.write(line + "\n")


def _both(tmp_path, fn_name, argv_for, seed=None):
    """Run a doc tool of each package on its own copy of the inputs; the
    printouts and the files each wrote (paths relative to its dir)."""
    out = {}
    for name, mod in (("jax", jdoc), ("port", pdoc)):
        d = tmp_path / name
        buf, err = io.StringIO(), io.StringIO()
        if seed is not None:
            random.seed(seed)
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            assert getattr(mod, fn_name)(argv_for(d)) == 0
        files = {str(p.relative_to(d)): p.read_bytes()
                 for p in sorted(d.rglob("*")) if p.is_file()}
        out[name] = (buf.getvalue().replace(str(d), "D"),
                     err.getvalue().replace(str(d), "D"), files)
    return out


def _corpus(d):
    d.mkdir()
    docs = [[f"d{i} l{j} " + "w " * (i + j) for j in range(1 + i % 3)]
            for i in range(11)]
    _write_docs(d / "corpus.txt", docs)
    return str(d / "corpus.txt")


@pytest.mark.parametrize("tool", ["count_docs", "shard_docs",
                                  "split_docs", "split_lines"])
def test_doc_tools_match_jax(tool, tmp_path):
    def argv_for(d):
        path = _corpus(d)
        if tool == "count_docs":
            return [path]
        if tool == "shard_docs":
            return [path, "--num-shards", "3"]
        extra = ["--lines"] if tool == "split_lines" else []
        return [path, str(d / "sample"), str(d / "rest"), "-k", "4", *extra]
    fn = {"split_docs": "split_train_valid_docs",
          "split_lines": "split_train_valid_docs"}.get(tool, tool)
    res = _both(tmp_path, fn, argv_for, seed=3)
    assert res["jax"] == res["port"]
    assert len(res["jax"][2]) >= 2 or "found 11 docs" in res["jax"][0]


@pytest.mark.parametrize("flags", [["--save-last", "1"],
                                   ["--save-every", "2", "--delete-best"],
                                   ["--delete-last", "--dry-run"]])
def test_rm_pt_matches_jax_under_tmp_path(flags, tmp_path):
    names = ("checkpoint1.npz", "checkpoint2.npz", "checkpoint3.npz",
             "checkpoint10.npz", "checkpoint_3_600.npz",
             "checkpoint_best.npz", "checkpoint_last.npz", "other.txt")

    def argv_for(d):
        for sub in ("run", "run/inner"):
            (d / sub).mkdir(parents=True)
            for name in names:
                (d / sub / name).write_bytes(b"x")
        return [str(d)] + flags
    res = _both(tmp_path, "rm_pt", argv_for)
    out, err, files = res["port"]
    assert (sorted(out.splitlines()), sorted(err.splitlines())) == (
        sorted(res["jax"][0].splitlines()), sorted(res["jax"][1].splitlines()))
    assert files == res["jax"][2]
    assert any(n.startswith("run/inner/") for n in files)


RECORDER = """#!{exe}
import json, os, sys
with open(os.environ["ARGV_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
"""


def test_valide_during_train_twin_runs_jax_lines(tmp_path):
    jax_sh = REPO / "recipes" / "valide_during_train.sh"
    port_sh = REPO / "recipes" / "valide_during_train_torch.sh"
    assert port_sh.read_text() == jax_sh.read_text().replace(
        "python -m s2st_tpu.", "python -m s2st_tpu_torch.")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "python"
    stub.write_text(RECORDER.format(exe=sys.executable))
    stub.chmod(0o755)
    lines = {}
    for script in (jax_sh, port_sh):
        log = tmp_path / f"{script.stem}.jsonl"
        env = {**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}",
               "ARGV_LOG": str(log), "SAVE_DIR": "SAVE",
               "FEATURE_MANIFEST_ROOT": "FEATS", "AUDIO_MANIFEST_ROOT": "AM",
               "asr_model_path": "ASR"}
        res = subprocess.run(["bash", str(script), "--SPLIT", "tst"],
                             env=env, capture_output=True, text=True,
                             timeout=60)
        assert res.returncode == 0, res.stderr
        lines[script.stem] = [json.loads(x)
                              for x in log.read_text().splitlines()]
    jax_lines = lines["valide_during_train"]
    assert [j[1] for j in jax_lines] == [
        "s2st_tpu.cli.average_checkpoints", "s2st_tpu.cli.generate_waveform",
        "s2st_tpu.cli.evaluate_s2s_bleu"]
    assert lines["valide_during_train_torch"] == [
        [a.replace("s2st_tpu.", "s2st_tpu_torch.") for a in j]
        for j in jax_lines]
