"""s2st_tpu_torch generation against s2st_tpu, fp32 on the CPU.

- ``generate_features``: JAX runs ``use_flash_attention=False``, prenet
  dropout off on both sides, and an eos threshold under which some rows
  stop early, so the frames the JAX loop leaves zero must be zero here.
- ``teacher_forcing_features``.
- ``griffin_lim`` and the Griffin-Lim vocoder with fp32 compute and the
  same initial phases, drawn with ``jax.random.uniform`` as ops/dsp.py
  does (:262-263).
- The port CLI on a tiny corpus with a checkpoint the JAX trainer wrote:
  its dumped features match JAX ``generate_features``; its WAVs are PCM16;
  with JAX's pad rows in a batch, its features match JAX's CLI's.

Tolerance: atol 1e-5, rtol 1e-5 for features (fp32 on both sides; the AR
loop feeds each frame back, which keeps errors at the 1e-6 level over these
few steps); Griffin-Lim atol 1e-5 on waveforms of magnitude ~1.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.generate import speech_generator as jsg
from s2st_tpu.generate.vocoder import GriffinLimVocoder as JVocoder
from s2st_tpu.ops import dsp as jdsp
from s2st_tpu_torch.generate import speech_generator as psg
from s2st_tpu_torch.generate.vocoder import GriffinLimVocoder as PVocoder
from s2st_tpu_torch.models.jax_bridge import jax_variables
from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
from s2st_tpu_torch.ops import dsp as pdsp
from tests._torch_port import port_cfg, t
from tests.conftest import make_batch

ATOL, RTOL = 1e-5, 1e-5
MAX_ITER = 12


def close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    """2 frames a step, prenet dropout off: (JAX cfg, JAX variables, port
    model with the same weights, seeded by the port)."""
    cfg = tiny_cfg.replace(n_frames_per_step=2, prenet_dropout=0.0,
                           use_flash_attention=False)
    model = S2STTransformer(port_cfg(cfg)).init_weights(seed=3).eval()
    return cfg, jax_variables(model), model


def early_stop_threshold(eos_prob: np.ndarray, max_iter: int) -> float:
    """A threshold between two distinct eos probabilities of a run without
    stops, at the widest gap above the median, so some rows stop before
    max_iter and none sits within rounding of the threshold."""
    p = np.unique(eos_prob[:, :max_iter])
    p = p[len(p) // 2:]
    i = int(np.argmax(np.diff(p)))
    return float((p[i] + p[i + 1]) / 2)


def threshold_for(model, src, lens) -> float:
    gen_cfg = psg.GenerationConfig(max_iter=MAX_ITER, eos_prob_threshold=1.5,
                                   prenet_dropout_at_inference=False)
    free = psg.generate_features(model, gen_cfg, t(src), t(lens).long())
    r = model.cfg.n_frames_per_step
    return early_stop_threshold(free["eos_prob"].numpy()[:, ::r], MAX_ITER)


def jax_generate(cfg, v, src, lens, threshold, gcmvn=(None, None)):
    gen_cfg = jsg.GenerationConfig(max_iter=MAX_ITER,
                                   eos_prob_threshold=threshold,
                                   prenet_dropout_at_inference=False)
    return jsg.generate_features(v, cfg, gen_cfg, jnp.asarray(src),
                                 jnp.asarray(lens), gcmvn_mean=gcmvn[0],
                                 gcmvn_std=gcmvn[1])


def test_generate_features_matches_jax(setup):
    cfg, v, model = setup
    b = make_batch(cfg, b=4, seed=5)
    thr = threshold_for(model, b["src_speech"], b["src_speech_lens"])
    r = cfg.n_frames_per_step
    rs = np.random.RandomState(6)
    gcmvn = (rs.randn(cfg.output_frame_dim).astype(np.float32),
             (rs.rand(cfg.output_frame_dim) + 0.5).astype(np.float32))
    j = jax_generate(cfg, v, b["src_speech"], b["src_speech_lens"], thr,
                     gcmvn)
    j_lens = np.asarray(j["out_lens"])
    assert j_lens.min() < MAX_ITER, "no row stopped early"
    gen_cfg = psg.GenerationConfig(max_iter=MAX_ITER, eos_prob_threshold=thr,
                                   prenet_dropout_at_inference=False)
    p = psg.generate_features(model, gen_cfg, t(b["src_speech"]),
                              t(b["src_speech_lens"]).long(),
                              gcmvn_mean=gcmvn[0], gcmvn_std=gcmvn[1])
    assert np.array_equal(p["out_lens"].numpy(), j_lens)
    assert np.array_equal(p["raw_out_lens"].numpy(),
                          np.asarray(j["raw_out_lens"]))
    for key in ("feats", "eos_prob", "attn"):
        assert tuple(p[key].shape) == tuple(j[key].shape), key
        close(p[key], j[key])
    if j_lens.max() < MAX_ITER:
        # the JAX loop stopped early: every frame after it is zero
        stop = int(j_lens.max())
        assert not p["eos_prob"][:, stop * r:].any()


def test_teacher_forcing_matches_jax(setup):
    cfg, v, model = setup
    b = make_batch(cfg, b=3, seed=7)
    j = jax.jit(jsg.teacher_forcing_features, static_argnums=1)(
        v, cfg, {k: jnp.asarray(x) for k, x in b.items()})
    batch = {k: t(b[k]) for k in ("src_speech", "prev_output_tokens")}
    batch["src_speech_lens"] = t(b["src_speech_lens"]).long()
    batch["target_lengths"] = t(b["target_lengths"]).long()
    p = psg.teacher_forcing_features(model, batch)
    for key in ("feats", "eos_prob", "attn"):
        close(p[key], j[key])
    assert np.array_equal(p["raw_out_lens"].numpy(),
                          np.asarray(j["raw_out_lens"]))


def _angles(key, shape):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                         minval=-np.pi, maxval=np.pi))


@pytest.mark.parametrize("n_fft,win,hop", [(128, 128, 32), (128, 100, 25),
                                           (64, 48, 20)])
def test_griffin_lim_matches_jax(n_fft, win, hop):
    r = np.random.RandomState(n_fft + win)
    spec = np.abs(r.randn(2, n_fft // 2 + 1, 13)).astype(np.float32)
    key = jax.random.PRNGKey(win)
    j = jdsp.griffin_lim(jnp.asarray(spec), n_fft, win, hop, 4, key,
                         compute_dtype=jnp.float32)
    ang = _angles(key, (2, 13, n_fft // 2 + 1))
    p = pdsp.griffin_lim(t(spec), n_fft, win, hop, 4, init_angles=t(ang),
                         compute_dtype=torch.float32)
    assert tuple(p.shape) == tuple(j.shape)
    close(p, j)


def test_vocoder_matches_jax():
    """Mel pseudo-inverse, the log floor past each length, Griffin-Lim."""
    kw = dict(sample_rate=16000, win_size=128, hop_size=32, n_fft=128,
              n_mels=8, f_min=20.0, f_max=8000.0, spec_bwd_max_iter=3)
    r = np.random.RandomState(9)
    logmel = (r.randn(2, 15, 8) - 4.0).astype(np.float32)
    lens = np.array([15, 9])
    key = jax.random.PRNGKey(11)
    jv = JVocoder(**kw)
    np.testing.assert_allclose(
        pdsp.make_pinv_mel_basis(16000, 128, 8, 20.0, 8000.0),
        jv.pinv_basis, atol=1e-6)
    j = jv(jnp.asarray(logmel), lengths=jnp.asarray(lens), rng=key)
    # JAX draws the phases inside griffin_lim, in compute dtype fp32 here
    ang = _angles(key, (2, 15, 65))
    jg = jdsp.griffin_lim(
        jdsp.logmel_to_linear(jnp.where(jnp.arange(15)[None, :, None]
                                        < jnp.asarray(lens)[:, None, None],
                                        logmel, float(np.log(1e-5))),
                              jv.pinv_basis), 128, 128, 32, 3, key,
        compute_dtype=jnp.float32)
    pv = PVocoder(**kw)
    p = pv(t(logmel), lengths=t(lens), init_angles=t(ang))
    # the JAX vocoder runs bf16 DFT products; the port's default too
    close(p, j, atol=2e-2, rtol=0)
    p32 = pdsp.griffin_lim(
        pdsp.logmel_to_linear(torch.where(
            torch.arange(15)[None, :, None] < t(lens)[:, None, None],
            t(logmel), torch.tensor(float(np.log(1e-5)))), pv.pinv_basis),
        128, 128, 32, 3, init_angles=t(ang), compute_dtype=torch.float32)
    close(p32, jg)
    assert pv.wave_length(15) == jv.wave_length(15) == 32 * 14


TINY_FLAGS = [
    "--conv-kernel-sizes", "5,5", "--conv-channels", "16",
    "--encoder-layers", "2", "--encoder-embed-dim", "16",
    "--encoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2",
    "--middle-layers", "0,1", "--decoder-layers", "2",
    "--decoder-embed-dim", "16", "--decoder-ffn-embed-dim", "32",
    "--decoder-attention-heads", "2", "--output-frame-dim", "8",
    "--n-frames-per-step", "2", "--prenet-dim", "8", "--prenet-dropout", "0",
    "--postnet-layers", "2", "--postnet-conv-dim", "8",
    "--max-source-positions", "256", "--max-target-positions", "256",
    "--ctc-weight", "0.3", "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3",
    "--asr-decoder-layers", "1", "--asr-decoder-embed-dim", "16",
    "--st-decoder-layers", "1", "--st-decoder-embed-dim", "16",
]


@pytest.fixture(scope="module")
def cli_setup(setup, tmp_path_factory):
    """The tiny corpus, a checkpoint the JAX trainer wrote for the setup's
    weights with its flag echo, and the batch JAX's own dataset collates
    from the test split (every utterance, longest first, as the CLI)."""
    from s2st_tpu.data.data_cfg import S2STDataConfig
    from s2st_tpu.data.dictionary import Dictionary
    from s2st_tpu.data.s2st_dataset import S2STDatasetCreator
    from s2st_tpu.options import get_training_parser
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu.train.optim import adam
    from s2st_tpu.train.trainer import create_train_state
    from tests.make_tiny_corpus import make_tiny_corpus

    cfg, v, model = setup
    tmp = tmp_path_factory.mktemp("cli")
    corpus = make_tiny_corpus(tmp / "corpus")
    echo = vars(get_training_parser().parse_args(
        [str(corpus)] + TINY_FLAGS))
    echo = {k: x for k, x in echo.items()
            if isinstance(x, (bool, int, float, str, type(None)))}
    ckpt = str(tmp / "checkpoint_last.npz")
    jckpt.save_checkpoint_file(ckpt, create_train_state(v, adam()),
                               {"args": echo})
    vocab = Dictionary.load(str(corpus / "src_vocab.txt"))
    ds = S2STDatasetCreator.from_tsv(
        str(corpus), S2STDataConfig(corpus / "config.yaml"), "test", vocab,
        vocab, False, n_frames_per_step=cfg.n_frames_per_step)
    batch = ds.collate([ds[i] for i in range(len(ds))])
    ids = [ds.ids[int(i)] for i in batch["id"]]
    stats = np.load(corpus / "gcmvn_tgt.npz")
    return corpus, ckpt, batch, ids, (stats["mean"], stats["std"])


def _run_cli(corpus, ckpt, out, *extra):
    from s2st_tpu_torch.cli import generate_waveform
    return generate_waveform.main([
        str(corpus), "--config-yaml", "config.yaml", "--gen-subset", "test",
        "--path", ckpt, "--results-path", str(out), "--spec-bwd-max-iter",
        "2", "--dump-waveforms", "--dump-features", "--dump-attentions",
        "--dump-eos-probs", "--device", "cpu", *extra])


def _check_dumps(out, ids, j, hop=64):
    """Each utterance's dumps against row i of the JAX output j: features
    and eos probabilities up to its frame count, the alignment up to its
    step count, and a PCM16 WAV of hop * (frames - 1) samples."""
    raw_lens = np.asarray(j["raw_out_lens"])
    step_lens = np.asarray(j["out_lens"])
    for i, uid in enumerate(ids):
        n = raw_lens[i]
        for sub, name, ref in (("feat", f"{uid}_pred", j["feats"][i, :n]),
                               ("eos", uid, j["eos_prob"][i, :n]),
                               ("attn", uid, j["attn"][i, :step_lens[i]])):
            np.testing.assert_allclose(np.load(out / sub / f"{name}.npy"),
                                       np.asarray(ref), atol=ATOL, rtol=RTOL)
        with wave.open(str(out / "wav" / f"{uid}_pred.wav"), "rb") as w:
            assert (w.getsampwidth(), w.getnchannels(), w.getframerate()) \
                == (2, 1, 16000)
            assert w.getnframes() == hop * (n - 1)
    assert (out / "timing.json").is_file()


def test_cli_matches_jax_generate_features(setup, cli_setup, tmp_path):
    """generate_waveform with the checkpoint's flag echo setting the model;
    dumped features against JAX generate_features, WAVs PCM16."""
    cfg, v, model = setup
    corpus, ckpt, batch, ids, gcmvn = cli_setup
    src, lens = batch["src_speech"], batch["src_speech_lens"]
    thr = threshold_for(model, src, lens)
    j = jax_generate(cfg, v, src, lens, thr, gcmvn)
    j_lens = np.asarray(j["raw_out_lens"])
    assert j_lens.min() < MAX_ITER * cfg.n_frames_per_step, \
        "no row stopped early"
    assert _run_cli(corpus, ckpt, tmp_path, "--max-iter", str(MAX_ITER),
                    "--eos-prob-threshold", str(thr)) == 0
    _check_dumps(tmp_path, ids, j)


def test_cli_decodes_jax_pad_rows(setup, cli_setup, tmp_path):
    """JAX's generate_waveform collates the test split's 4 utterances into
    snap_len(4, 8) = 8 rows, 4 of them of length 0, and its decode loop
    runs until those finish too; the postnet reads two steps past each
    row's end. With weights (seed 45) and a threshold under which the real
    rows stop at different steps and the pad rows never stop, the last
    real row's final frames depend on the pad rows: the port's CLI, which
    decodes the same pad rows, serves every real row's features as JAX's
    CLI does (atol 1e-5 + rtol 1e-5, fp32)."""
    from s2st_tpu.cli import generate_waveform as jgw
    from s2st_tpu.data.dictionary import Dictionary
    from s2st_tpu.options import get_training_parser
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu.train.optim import adam
    from s2st_tpu.train.trainer import create_train_state
    from s2st_tpu_torch.cli.generate_waveform import with_pad_rows
    cfg, _, _ = setup
    corpus, _, batch, ids, _ = cli_setup
    cfg = cfg.replace(**{f"{side}_vocab_size": len(Dictionary.load(
        str(corpus / f"{side}_vocab.txt"))) for side in ("src", "tgt")})
    model = S2STTransformer(port_cfg(cfg)).init_weights(seed=45).eval()
    n = len(ids)
    src, lens = with_pad_rows(t(batch["src_speech"]),
                              t(batch["src_speech_lens"]).long())
    assert src.shape[0] == 8 and not lens[n:].any()
    free = psg.generate_features(model, psg.GenerationConfig(
        max_iter=MAX_ITER, eos_prob_threshold=1.5,
        prenet_dropout_at_inference=False), src, lens)
    eos = free["eos_prob"].numpy()[:, ::cfg.n_frames_per_step]
    real, pad = eos[:n].max(1).min(), eos[n:].max()
    assert real > pad + 0.05      # every real row stops, no pad row does
    thr = float((real + pad) / 2)
    stops = [int(np.argmax(row > thr)) + 1 for row in eos[:n]]
    assert len(set(stops)) > 1 and max(stops) < MAX_ITER, stops
    echo = vars(get_training_parser().parse_args(
        [str(corpus)] + TINY_FLAGS))
    echo = {k: x for k, x in echo.items()
            if isinstance(x, (bool, int, float, str, type(None)))}
    ckpt = str(tmp_path / "checkpoint_last.npz")
    jckpt.save_checkpoint_file(ckpt, create_train_state(
        jax_variables(model), adam()), {"args": echo})
    flags = ["--max-iter", str(MAX_ITER), "--eos-prob-threshold", str(thr)]
    assert jgw.main([str(corpus), "--config-yaml", "config.yaml",
                     "--gen-subset", "test", "--path", ckpt,
                     "--results-path", str(tmp_path / "jax"),
                     "--spec-bwd-max-iter", "2", "--dump-features",
                     *flags]) == 0
    assert _run_cli(corpus, ckpt, tmp_path / "port", *flags) == 0
    for uid, stop in zip(ids, stops):
        want = np.load(tmp_path / "jax" / "feat" / f"{uid}_pred.npy")
        got = np.load(tmp_path / "port" / "feat" / f"{uid}_pred.npy")
        assert got.shape == want.shape == (stop * cfg.n_frames_per_step,
                                           cfg.output_frame_dim), uid
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=uid)


def test_cli_teacher_forcing_matches_jax(setup, cli_setup, tmp_path):
    cfg, v, _ = setup
    corpus, ckpt, batch, ids, gcmvn = cli_setup
    db = {k: jnp.asarray(x) for k, x in batch.items()
          if isinstance(x, np.ndarray) and k != "id"}
    j = jax.jit(jsg.teacher_forcing_features, static_argnums=1)(
        v, cfg, db, gcmvn[0], gcmvn[1])
    assert _run_cli(corpus, ckpt, tmp_path, "--teacher-forcing") == 0
    _check_dumps(tmp_path, ids, j)


def test_config_yaml_reader_matches_pyyaml(tmp_path):
    """The port reads config.yaml without PyYAML; on what yaml.dump and the
    tiny corpus write it agrees with yaml.load."""
    import yaml
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig, parse_yaml
    from tests.make_tiny_corpus import make_tiny_corpus
    # the block get_feature_manifest.py writes (yaml.dump, block style)
    config = {
        "audio_root": "/data/fisher", "src_vocab_filename": "src_vocab.txt",
        "input_feat_per_channel": 80, "input_channels": 1,
        "features": {"type": "spectrogram+melscale+log", "eps": 1e-5,
                     "n_mels": 80, "n_fft": 1024, "window_fn": "hann",
                     "win_len_t": 0.064, "hop_len_t": 0.016, "f_min": 20,
                     "f_max": 8000, "sample_rate": 16000},
        "src_transforms": {"*": ["src_global_cmvn"],
                           "_train": ["src_global_cmvn", "specaugment"]},
        "src_global_cmvn": {"stats_npz_path": "/data/gcmvn_src.npz"},
        "specaugment": {"time_wrap_W": 0, "freq_mask_N": 2,
                        "time_mask_p": 1.0, "flag": True, "none": None},
    }
    text = yaml.dump(config, default_flow_style=False)
    assert parse_yaml(text) == yaml.load(text, Loader=yaml.FullLoader) \
        == config
    corpus = make_tiny_corpus(tmp_path / "corpus", n_train=1, n_dev=1,
                              n_test=1)
    text = (corpus / "config.yaml").read_text()
    assert parse_yaml(text) == yaml.load(text, Loader=yaml.FullLoader)
    cfg = S2STDataConfig(corpus / "config.yaml")
    assert cfg.transforms_for("tgt_transforms", "test", False) == \
        ["tgt_global_cmvn"]
    assert cfg.transforms_for("src_transforms", "test", False) is None


@pytest.mark.parametrize("max_tokens,batch_size", [(100, None), (64, 3),
                                                   (1000, 2)])
def test_batches_match_jax_batcher(tmp_path, max_tokens, batch_size):
    """Longest first, cut greedily under max_tokens and batch_size, as the
    JAX batcher does (data/iterators.py:54-90)."""
    from s2st_tpu.data.iterators import batch_by_size, ordered_indices
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.manifest import GenerationSplit
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus", n_train=1, n_dev=1,
                              n_test=11, seed=max_tokens)
    split = GenerationSplit(str(corpus),
                            S2STDataConfig(corpus / "config.yaml"), "test")
    lengths = split.src_n_frames
    ref = batch_by_size(ordered_indices(lengths, False, 1, 1), lengths,
                        max_tokens, batch_size)
    assert [list(map(int, b)) for b in ref] == split.batches(max_tokens,
                                                             batch_size)
