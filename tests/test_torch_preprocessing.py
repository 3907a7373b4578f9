"""Stages 1-2 of the recipe in s2st_tpu_torch against s2st_tpu, on the CPU.

- ``cn_text_norm.normalize``: the same text character for character.
- ``audio_manifest``: both packages' CLIs over the same seeded WAV pairs
  and metadata write byte-identical ``<split>.audio.tsv`` files (English
  and Chinese target normalisation).
- ``split_file``: ``--type split`` into N shards (fewer rows than shards
  too), then ``--type contat``, byte-identical.
- ``g2p``: the ``chars`` and ``auto`` backends (neither phonemizer is
  installed here, so ``auto`` falls back to ``chars`` in both), with and
  without ``--keep-latin-tgt``, byte-identical; naming a phonemizer that
  is missing raises the same exception type in both packages (or, where
  it is installed, both write the same file).
"""

import pytest

from s2st_tpu.preprocessing import audio_manifest as jam
from s2st_tpu.preprocessing import cn_text_norm as jtn
from s2st_tpu.preprocessing import g2p as jg2p
from s2st_tpu.preprocessing import split_file as jsplit
from s2st_tpu_torch.preprocessing import audio_manifest as pam
from s2st_tpu_torch.preprocessing import cn_text_norm as ptn
from s2st_tpu_torch.preprocessing import g2p as pg2p
from s2st_tpu_torch.preprocessing import split_file as psplit
from tests._torch_port import (TGT_SENTENCES, one_thread,  # noqa: F401
                               write_wav_pairs)


@pytest.mark.parametrize("text", TGT_SENTENCES + [
    "1/3的人在2020-01-02出生", "电话：021-12345678，共3.14元", "",
    "一二三 ABC 123", "他说:“好的”。", "第100名，-5度，+86"])
def test_cn_text_norm_matches_jax(text):
    assert ptn.normalize(text) == jtn.normalize(text)
    assert ptn.strip_punctuation(text) == jtn.strip_punctuation(text)


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*.tsv"))}


@pytest.fixture(scope="module")
def metadata(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage1")
    return root, write_wav_pairs(root, latin_row=True)


@pytest.mark.parametrize("tgt_lang", ["zh", "es"])
def test_audio_manifest_matches_jax(metadata, tgt_lang, tmp_path):
    root, specs = metadata
    for mod, out in ((jam, tmp_path / "jax"), (pam, tmp_path / "port")):
        assert mod.main(["--metadata", *specs, "--audio-root",
                         str(root / "wavs"), "--output-root", str(out),
                         "--tgt-lang", tgt_lang]) == 0
    want = _files(tmp_path / "jax")
    assert sorted(want) == ["dev.audio.tsv", "train.audio.tsv",
                            "tst.audio.tsv"]
    assert _files(tmp_path / "port") == want


@pytest.fixture(scope="module")
def manifest(metadata, tmp_path_factory):
    root, specs = metadata
    out = tmp_path_factory.mktemp("manifests")
    assert pam.main(["--metadata", *specs, "--audio-root",
                     str(root / "wavs"), "--output-root", str(out),
                     "--tgt-lang", "zh"]) == 0
    return out / "train.audio.tsv"


@pytest.mark.parametrize("n", [1, 3, 6])
def test_split_and_concat_match_jax(manifest, n, tmp_path):
    for mod, name in ((jsplit, "jax"), (psplit, "port")):
        out = tmp_path / name
        assert mod.main(["--type", "split", "--n", str(n), "--input-file",
                         str(manifest), "--output-path", str(out)]) == 0
        parts = [str(out / f"train.audio.{i}.tsv") for i in range(1, n + 1)]
        assert mod.main(["--type", "contat", "--file-part", *parts,
                         "--output-path", str(out / "cat")]) == 0
    want = _files(tmp_path / "jax")
    assert len(want) == n + 1
    assert _files(tmp_path / "port") == want
    assert want["cat/train.audio_phone.tsv"] == manifest.read_bytes()


@pytest.mark.parametrize("src,tgt,keep", [("chars", "chars", False),
                                          ("auto", "auto", False),
                                          ("auto", "chars", True)])
def test_g2p_matches_jax(manifest, src, tgt, keep, tmp_path):
    outs = []
    for mod, name in ((jg2p, "jax"), (pg2p, "port")):
        outs.append(tmp_path / f"{name}.tsv")
        assert mod.main(["--input-file", str(manifest), "--output-file",
                         str(outs[-1]), "--src-backend", src,
                         "--tgt-backend", tgt]
                        + (["--keep-latin-tgt"] if keep else [])) == 0
    want = outs[0].read_bytes()
    assert outs[1].read_bytes() == want
    rows = want.decode().splitlines()
    # the metadata's second row has Latin letters in its target text
    assert len(rows) == 1 + 4 - (not keep)


@pytest.mark.parametrize("src,tgt", [("g2p_en", "chars"),
                                     ("chars", "pypinyin")])
def test_g2p_missing_phonemizer_as_jax(manifest, src, tgt, tmp_path):
    outcomes = []
    for mod, name in ((jg2p, "jax"), (pg2p, "port")):
        out = tmp_path / f"{name}.tsv"
        try:
            mod.main(["--input-file", str(manifest), "--output-file",
                      str(out), "--src-backend", src, "--tgt-backend", tgt])
            outcomes.append(out.read_bytes())
        except ImportError as e:
            outcomes.append(type(e))
    assert outcomes[0] == outcomes[1]
