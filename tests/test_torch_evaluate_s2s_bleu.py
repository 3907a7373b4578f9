"""Stage 8 through the port against JAX's stage 8, on the CPU.

JAX's ``s2st_tpu.cli.evaluate_s2s_bleu.main`` transcribes with HF's
``Wav2Vec2ForCTC`` (``build_hf_transcriber``); the port's CLI with
``--device cpu`` transcribes with its own model from the same files. On
the same tiny random model (each of the two layouts of
``tests/test_torch_wav2vec2_ctc.py``) and the same dump of WAVs, the two
must write identical ``decode.txt`` files and print identical score lines,
under ``--scoring sacrebleu`` and ``wer``. The manifest's references hold
some of the transcripts' words, so BLEU and WER are not trivial; one row
has no WAV (an empty hypothesis keeps the lines aligned), and rows come in
the manifest's order (utt_9 before utt_10).

Also: a model that cannot be loaded exits 2, as in JAX; a hub id resolves
from a fake hub cache (``HF_HUB_CACHE``) to its snapshot; and the default
device is CUDA, which raises here.
"""

import csv
import shutil

import numpy as np
import pytest
import torch

from s2st_tpu_torch.cli import evaluate_s2s_bleu as port
from s2st_tpu_torch.data.audio_utils import write_wav
from s2st_tpu_torch.models import hf_checkpoint
from tests.test_torch_wav2vec2_ctc import make_hf_wav2vec2
from tests._torch_port import one_thread  # noqa: F401  (autouse)

UTTS = ("utt_9", "utt_10", "utt_11", "utt_2")
MISSING = "utt_11"


def _dump(root, refs):
    """The WAVs (seeded noise of 0.3-1.2 s at 16 kHz) and the manifest."""
    wav_dir = root / "dump" / "wav"
    wav_dir.mkdir(parents=True)
    r = np.random.RandomState(7)
    for i, uid in enumerate(UTTS):
        if uid != MISSING:
            write_wav(str(wav_dir / f"{uid}_pred.wav"),
                      np.clip(r.randn(4800 + 4000 * i) * 0.2, -1, 1), 16000)
    man = root / "test.audio.tsv"
    with open(man, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["id", "tgt_text"], delimiter="\t",
                           quoting=csv.QUOTE_NONE)
        w.writeheader()
        for uid in UTTS:
            w.writerow({"id": uid, "tgt_text": refs.get(uid, "a b")})
    return man, root / "dump"


@pytest.fixture(params=["group", "layer"])
def case(request, tmp_path):
    """(model dir, manifest, dump): references made of the HF
    transcripts' words, mixed with others."""
    pytest.importorskip("transformers")
    from s2st_tpu.cli.evaluate_s2s_bleu import (build_hf_transcriber,
                                                normalize_text)
    from s2st_tpu.data.audio_utils import read_wav
    model = make_hf_wav2vec2(tmp_path / "model", request.param, seed=5)
    man, dump = _dump(tmp_path, {})
    hf = build_hf_transcriber(str(model))
    refs = {}
    for i, uid in enumerate(UTTS):
        path = dump / "wav" / f"{uid}_pred.wav"
        words = normalize_text(hf(*read_wav(str(path)))).split() \
            if path.exists() else []
        refs[uid] = " ".join(words[:max(1, len(words) - i)] +
                             ["Hello,", "world!"][:i % 3])
    shutil.rmtree(dump)
    man, dump = _dump(tmp_path, refs)
    return model, man, dump


def _argv(man, dump, out, scoring, model):
    return ["--audio-manifest-file", str(man), "--decode-save-path",
            str(dump), "--out-result-file", str(out), "--scoring", scoring,
            "--asr-model-path", str(model)]


@pytest.mark.parametrize("scoring", ["sacrebleu", "wer"])
def test_port_stage8_equals_jax_stage8(case, scoring, capsys):
    from s2st_tpu.cli.evaluate_s2s_bleu import main as jax_main
    model, man, dump = case
    assert jax_main(_argv(man, dump, dump / "jax.txt", scoring, model)) == 0
    jax_out = capsys.readouterr().out.strip().splitlines()[-1]
    assert port.main(_argv(man, dump, dump / "port.txt", scoring, model)
                     + ["--device", "cpu"]) == 0
    port_out = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_out == jax_out
    assert port_out.startswith("BLEU = " if scoring == "sacrebleu"
                               else "WER: ")
    assert port_out not in ("WER: 100.00",) and not \
        port_out.startswith("BLEU = 0.00")
    want = (dump / "jax.txt").read_text()
    assert (dump / "port.txt").read_text() == want
    lines = want.splitlines()
    assert [ln.split("\t")[2] for ln in lines] == list(UTTS)
    assert lines[UTTS.index(MISSING)].split("\t")[0] == ""


def test_missing_model_exits_2(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
    man, dump = _dump(tmp_path, {})
    assert port.main(_argv(man, dump, dump / "d.txt", "wer",
                           tmp_path / "nonexistent")
                     + ["--device", "cpu"]) == 2
    assert port.main(_argv(man, dump, dump / "d.txt", "wer",
                           "facebook/not-in-the-cache")
                     + ["--device", "cpu"]) == 2


def test_hub_id_resolves_from_the_local_cache(case, tmp_path, monkeypatch,
                                              capsys):
    """``--asr-model-path org/name`` reads
    ``$HF_HUB_CACHE/models--org--name/snapshots/<refs/main>/``, as
    from_pretrained resolves it offline, and scores as the directory
    does."""
    model, man, dump = case
    repo = tmp_path / "hub" / "models--facebook--wav2vec2-large-960h-lv60-self"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abcd\n")
    shutil.copytree(model, repo / "snapshots" / "0123abcd")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    assert hf_checkpoint.resolve_model_dir(
        "facebook/wav2vec2-large-960h-lv60-self") == \
        repo / "snapshots" / "0123abcd"
    argv = _argv(man, dump, dump / "hub.txt", "wer", model)[:-2]
    assert port.main(argv + ["--device", "cpu"]) == 0   # the default id
    by_id = capsys.readouterr().out.strip().splitlines()[-1]
    assert port.main(_argv(man, dump, dump / "dir.txt", "wer", model)
                     + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == by_id
    assert (dump / "hub.txt").read_text() == (dump / "dir.txt").read_text()
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    assert hf_checkpoint.hub_cache() == tmp_path / "home" / "hub"


def test_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    man, dump = _dump(tmp_path, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main(_argv(man, dump, dump / "d.txt", "wer", tmp_path))


def test_normalize_text_matches_jax():
    from s2st_tpu.cli.evaluate_s2s_bleu import normalize_text
    for s in ("Hello, World!", "<s>A</s><unk>  it's", "a-b_c  D.E?",
              "", "   ", "O'NEIL'S (x)"):
        assert port.normalize_text(s) == normalize_text(s)
