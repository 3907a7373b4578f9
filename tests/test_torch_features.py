"""Stage 3 of the recipe in s2st_tpu_torch against s2st_tpu, on the CPU.

- ``kaldi_fbank`` and ``extract_logmel_spectrogram`` (the port's in
  float64 PyTorch on ``device="cpu"``) against JAX's numpy, atol 1e-5 on
  the log features, at lengths below one window, at exact frame
  multiples, under 513 samples (the log-mel's reflect pad is longer than
  the waveform), with silent stretches and all silent, and at 8 kHz.
- ``compute_global_cmvn`` and ``resample`` (both on the host) equal JAX's;
  ``create_zip`` and ``get_zip_manifest`` give JAX's offsets and bytes.
- ``dump_yaml`` writes what ``yaml.dump(cfg, default_flow_style=False)``
  writes, ``parse_yaml`` reads it back, and it raises on other types.
- The stage-3 CLI of each package over the same seeded WAV pairs (two
  speakers; 2 threads in the port's): byte-identical TSVs, vocabularies,
  ``speakers.txt`` and ``config.yaml`` once the output root is replaced;
  features from the zips and the GCMVN stats within 1e-5; the same with
  ``--src-sample-rate 8000`` (the ``_8k`` names).
- The port's train CLI takes one update on the port's own stage-3 output.
- Without a card the feature functions raise unless given a device.
"""

import numpy as np
import pytest
import torch
import yaml

from s2st_tpu.cli import get_feature_manifest as jcli
from s2st_tpu.data import audio_utils as jau
from s2st_tpu_torch.cli import get_feature_manifest as pcli
from s2st_tpu_torch.data import audio_utils as pau
from s2st_tpu_torch.data.data_cfg import dump_yaml, parse_yaml
from tests._torch_port import one_thread, write_wav_pairs  # noqa: F401

ATOL = 1e-5


def _wave(n, seed, silent=False):
    x = np.random.RandomState(seed).randn(n).astype(np.float32) * 0.1
    if silent:
        x[:] = 0.0
    elif n > 8:
        x[n // 4:n // 2] = 0.0
    return x


@pytest.mark.parametrize("n,sr,silent", [
    (0, 16000, False), (399, 16000, False), (400, 16000, False),
    (400 + 160 * 4, 16000, False), (3000, 16000, False),
    (3000, 16000, True), (1600, 8000, False)])
def test_kaldi_fbank_matches_jax(n, sr, silent):
    x = _wave(n, n, silent) * 2 ** 15
    want = jau.kaldi_fbank(x, sample_rate=sr)
    got = pau.kaldi_fbank(x, sample_rate=sr, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,silent", [(1, False), (100, False), (512, False),
                                      (513, False), (256 * 8, False),
                                      (4000, False), (4000, True)])
def test_logmel_matches_jax(n, silent):
    x = _wave(n, n + 1, silent)
    kw = dict(n_fft=1024, win_length=1024, hop_length=256, n_mels=80,
              f_min=20.0, f_max=8000.0)
    want = jau.extract_logmel_spectrogram(x, 16000, **kw)
    got = pau.extract_logmel_spectrogram(x, 16000, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if silent:
        assert np.all(got == np.float32(np.log(1e-5)))


def test_cmvn_resample_and_zip_match_jax(tmp_path):
    r = np.random.RandomState(3)
    feats = [r.randn(t, 80).astype(np.float32) * 3 - 5 for t in (7, 30, 1)]
    want, got = jau.compute_global_cmvn(feats), pau.compute_global_cmvn(feats)
    for key in ("mean", "std"):
        assert np.array_equal(got[key], want[key])
    x = r.randn(16000 + 17).astype(np.float32)
    assert np.array_equal(pau.resample(x, 16000, 8000),
                          jau.resample(x, 16000, 8000))
    assert pau.resample(x, 8000, 8000) is x
    npys = tmp_path / "npy"
    npys.mkdir()
    for i, f in enumerate(feats):
        np.save(npys / f"u{2 - i}.npy", f)
    jau.create_zip(npys, tmp_path / "jax.zip")
    pau.create_zip(npys, tmp_path / "port.zip")
    want = jau.get_zip_manifest(tmp_path / "jax.zip")
    got = pau.get_zip_manifest(tmp_path / "port.zip")
    assert sorted(got) == sorted(want) == ["u0", "u1", "u2"]
    for key in want:
        assert got[key].split(":")[1:] == want[key].split(":")[1:]
        assert np.array_equal(pau.get_features(got[key]),
                              np.load(npys / f"{key}.npy"))


CONFIGS = [
    {"audio_root": "/data/out", "input_feat_per_channel": 80,
     "features": {"eps": 1e-5, "win_len_t": 1024 / 16000,
                  "hop_len_t": 256 / 16000, "f_min": 20.0, "f_max": 8000.0,
                  "type": "spectrogram+melscale+log"},
     "src_transforms": {"*": ["src_global_cmvn"],
                        "_train": ["src_global_cmvn", "specaugment"]},
     "specaugment": {"time_mask_p": 1.0, "time_wrap_W": 0},
     "speaker_set_filename": "speakers.txt"},
    {"quoted": ["true", "1.5", "", "a: b", "-", "~", "null", "0x1f", "2020-1-2",
                "a #b", "it's", "x:"], "plain": ["a-b", "-x", "a:b", "?x",
                                                 "a b c", "$HOME"],
     "numbers": [1e17, 1e-20, -2.5e-7, 1.0 / 3, 0.0, -0.0, 7, -3],
     "flags": {"on": True, "off": False, "none": None}, "empty": {},
     "nothing": []},
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_dump_yaml_matches_pyyaml(cfg):
    text = dump_yaml(cfg)
    assert text == yaml.dump(cfg, default_flow_style=False)
    assert parse_yaml(text) == cfg


@pytest.mark.parametrize("bad", [{"x": np.float32(1.0)}, {"x": (1, 2)},
                                 {"x": "é"}, {1: "a"}, {"x": [{"a": 1}]},
                                 {"x": "a\nb"}])
def test_dump_yaml_raises_outside_its_types(bad):
    with pytest.raises(ValueError):
        dump_yaml(bad)


@pytest.fixture(scope="module")
def stage3(tmp_path_factory):
    """Each package's stage-3 CLI over the same seeded WAV pairs, and an
    --src-sample-rate 8000 run on the dev split: {(package, rate): root}."""
    root = tmp_path_factory.mktemp("stage3")
    specs = write_wav_pairs(root / "raw")
    from s2st_tpu_torch.preprocessing import audio_manifest
    audio_manifest.main(["--metadata", *specs, "--audio-root",
                         str(root / "raw" / "wavs"), "--output-root",
                         str(root / "manifests"), "--tgt-lang", "zh"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for pkg, main, extra in (("jax", jcli.main, []),
                                 ("port", pcli.main,
                                  ["--device", "cpu", "--num-workers", "2"])):
            for rate, splits in (("16k", ["train", "dev", "tst"]),
                                 ("8k", ["train", "dev"])):
                out[pkg, rate] = root / f"{pkg}_{rate}"
                assert main(["--audio-manifest-root", str(root / "manifests"),
                             "--output-root", str(out[pkg, rate]),
                             "--audio-suffix", ".audio.tsv",
                             "--splits", *splits]
                            + (["--src-sample-rate", "8000"]
                               if rate == "8k" else []) + extra) == 0
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("rate", ["16k", "8k"])
def test_feature_manifest_cli_matches_jax(stage3, rate):
    jax, port = stage3["jax", rate], stage3["port", rate]
    suffix = "_8k" if rate == "8k" else ""
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jax.iterdir())
    assert f"src_logmelspec80{suffix}.zip" in names
    assert f"src_gcmvn_stats{suffix}.npz" in names
    for name in names:
        if name.endswith((".zip", ".npz")):
            continue
        want = (jax / name).read_bytes().replace(str(jax).encode(),
                                                 str(port).encode())
        assert (port / name).read_bytes() == want, name
    assert "speaker_set_filename: speakers.txt" in \
        (port / "config.yaml").read_text()
    for tsv in port.glob("*.tsv"):
        for line in tsv.read_text().splitlines()[1:]:
            for col in (1, 2):
                path = line.split("\t")[col]
                np.testing.assert_allclose(
                    pau.get_features(path),
                    pau.get_features(path.replace(str(port), str(jax))),
                    atol=ATOL, rtol=0)
    for name in (f"src_gcmvn_stats{suffix}.npz", "tgt_gcmvn_stats.npz"):
        a, b = np.load(port / name), np.load(jax / name)
        for key in ("mean", "std"):
            np.testing.assert_allclose(a[key], b[key], atol=ATOL, rtol=0)


def test_port_trains_on_its_stage3_output(stage3, tmp_path):
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.train.checkpoint import load_checkpoint_file
    data = stage3["port", "16k"]
    save = tmp_path / "ckpt"
    assert train.main([
        str(data), "--config-yaml", "config.yaml", "--train-subset", "train",
        "--save-dir", str(save), "--max-tokens", "2000", "--max-update", "1",
        "--n-frames-per-step", "4", "--encoder-layers", "1",
        "--decoder-layers", "1", "--encoder-embed-dim", "16",
        "--decoder-embed-dim", "16", "--encoder-ffn-embed-dim", "32",
        "--decoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2",
        "--decoder-attention-heads", "2", "--conv-channels", "16",
        "--middle-layers", "0", "--asr-ce-weight", "0.3", "--st-ce-weight",
        "0.3", "--asr-decoder-layers", "1", "--st-decoder-layers", "1",
        "--asr-decoder-embed-dim", "16", "--st-decoder-embed-dim", "16",
        "--prenet-dim", "8", "--postnet-conv-dim", "8", "--postnet-layers",
        "2", "--disable-validation", "--device", "cpu"]) == 0
    flat, meta = load_checkpoint_file(str(save / "checkpoint_last.npz"))
    assert meta["step"] == 1
    assert all(np.isfinite(v).all() for v in flat.values()
               if v.dtype.kind == "f")


def test_feature_functions_raise_without_cuda():
    """(The CLI's refusal: tests/test_torch_imports.py.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    for fn in (lambda: pau.kaldi_fbank(np.ones(800)),
               lambda: pau.extract_logmel_spectrogram(np.ones(800), 16000)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
