"""s2st_tpu_torch's FastSpeech2 against s2st_tpu's, fp32 on the CPU,
dropout off.

- ``bucketize``: its boundaries equal JAX's fp32 ``linspace`` bit for bit
  at the arch's pitch and energy ranges, and values exactly on every
  boundary (pitch 0.0 on the first) land in JAX's bins;
  ``length_regulator`` on rows whose durations sum below, to and past
  ``max_out``.
- A small FastSpeech2 (2 + 2 FFT layers of 16-d, 2 heads, kernel 5, 9
  pitch/energy bins, a postnet, the CTC head), one JAX ``init_fs2``
  carried over by the bridge, which gives JAX's tree back unchanged (the
  layer lists by index, the alphas as scalars, the postnet's
  statistics): the teacher-forced pass, and the free-running one with
  ``d_factor`` 2.7 and ``min_duration`` 1; ``fastspeech2_loss`` with the
  CTC term and the postnet in training, per-leaf gradients.
- The collate of the variance columns against JAX's on the same items.
- The fairseq reader: a state_dict written from the port's module gives
  the same tree through JAX's ``fs2_from_fairseq_state_dict`` and the
  port's ``fs2_from_fairseq``.
- The port's train CLI takes 2 updates of ``fastspeech2`` with a postnet,
  and JAX loads its ``checkpoint_last.npz`` strictly; then the port's
  ``generate_waveform`` gives JAX's features within each row's length,
  from the test split's text with ``--duration-factor 1.5
  --min-duration 1``.

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; the loss rtol 1e-5; gradients atol 1e-6 + rtol 1e-4, as
``tests/test_torch_train.py`` holds them, the served features too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import fastspeech2 as jf
from s2st_tpu.train import losses as jl
from s2st_tpu_torch.models import fastspeech2 as pf
from s2st_tpu_torch.models.jax_bridge import flatten_tree, jax_variables
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import one_thread  # noqa: F401
from tests.test_torch_berard import (assert_same_tree, numpy_vars,
                                     train_and_load_in_jax)
from tests.test_torch_train import close, port_batch
from tests.test_torch_xm_convtransformer import grads_with_zeros, jnp_tree

SMALL = dict(vocab_size=17, output_frame_dim=6, n_frames_per_step=2,
             encoder_layers=2, encoder_embed_dim=16,
             encoder_attention_heads=2, decoder_layers=2,
             decoder_embed_dim=16, decoder_attention_heads=2,
             fft_hidden_dim=24, fft_kernel_size=5, dropout=0.0,
             var_pred_n_bins=9, var_pred_hidden_dim=12,
             var_pred_kernel_size=3, var_pred_dropout=0.0, pitch_min=0.0,
             pitch_max=1.0, energy_min=-1.0, energy_max=1.0,
             add_postnet=True, postnet_layers=3, postnet_conv_dim=8,
             max_source_positions=64, max_target_positions=64, ctc=True)


def cfgs():
    return (jf.FS2Config(dtype=jnp.float32, **SMALL),
            pf.FS2Config(**SMALL))


@pytest.fixture(scope="module")
def fs2_vars():
    return jf.init_fs2(jax.random.PRNGKey(51), cfgs()[0])


@pytest.mark.parametrize("vmin,vmax,n_bins", [(0.0, 600.0, 256),
                                              (0.0, 5.0, 256),
                                              (50.0, 800.0, 256),
                                              (-4.0, 4.0, 256),
                                              (-1.0, 1.0, 9)])
def test_bucketize_matches_jax_on_its_boundaries(vmin, vmax, n_bins):
    """Against the boundaries of JAX's jitted forward (XLA folds them to
    constants; eager ``jnp.linspace`` rounds some of them otherwise where
    vmin is not 0)."""
    bins = np.asarray(jax.jit(lambda: jnp.linspace(vmin, vmax,
                                                   n_bins - 1))())
    np.testing.assert_array_equal(
        pf.bucket_boundaries(vmin, vmax, n_bins - 1).numpy(), bins)
    x = np.concatenate([bins, np.nextafter(bins, np.inf),
                        np.nextafter(bins, -np.inf),
                        [vmin - 1.0, vmax + 1.0, 0.0]]).astype(np.float32)
    # not the subnormal neighbours of 0.0, which XLA's CPU flushes to 0
    x = x[(x == 0) | (np.abs(x) >= np.finfo(np.float32).tiny)]
    ref = np.asarray(jax.jit(lambda v: jf._bucketize(v, vmin, vmax, n_bins))(
        jnp.asarray(x)))
    got = pf.bucketize(torch.from_numpy(x), vmin, vmax, n_bins)
    assert got.tolist() == ref.tolist()


def test_length_regulator_matches_jax():
    r = np.random.RandomState(52)
    x = r.randn(4, 6, 3).astype(np.float32)
    dur = np.array([[1, 2, 0, 3, 1, 0], [4, 4, 4, 4, 4, 4],
                    [0, 0, 0, 0, 0, 0], [2, 0, 5, 1, 1, 1]], np.int32)
    for max_out in (5, 10, 31):       # sums 7, 24, 0, 10
        ref, ref_lens = jf.length_regulator(jnp.asarray(x), jnp.asarray(dur),
                                            max_out)
        out, lens = pf.length_regulator(torch.from_numpy(x),
                                        torch.from_numpy(dur), max_out)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert lens.tolist() == np.asarray(ref_lens).tolist()


def tts_batch(seed, b=3, ts=8, tt=11):
    """Text, its variance targets (durations summing to each row's frames)
    and packed targets."""
    r = np.random.RandomState(seed)
    lens = np.array([ts] + list(r.randint(2, ts + 1, b - 1)), np.int32)
    valid = np.arange(ts)[None, :] < lens[:, None]
    tokens = np.where(valid, r.randint(4, 17, (b, ts)), 1).astype(np.int32)
    tgt_lens = np.array([tt] + list(r.randint(3, tt + 1, b - 1)), np.int32)
    dur = np.zeros((b, ts), np.int32)
    for i in range(b):
        cuts = np.sort(r.randint(0, tgt_lens[i] + 1, lens[i] - 1))
        dur[i, :lens[i]] = np.diff(np.concatenate([[0], cuts,
                                                   [tgt_lens[i]]]))
    tgt = r.randn(b, tt, 12).astype(np.float32)
    return {"src_text": tokens, "src_text_len": lens, "durations": dur,
            "pitches": np.where(valid, r.uniform(0, 1, (b, ts)), 0)
            .astype(np.float32),
            "energies": np.where(valid, r.uniform(-1, 1, (b, ts)), 0)
            .astype(np.float32),
            "tgt_speech": tgt, "target_lengths": tgt_lens}


def test_bridge_gives_jax_tree_back(fs2_vars):
    model = pf.from_jax_variables(cfgs()[1], numpy_vars(fs2_vars))
    assert_same_tree(jax_variables(model), fs2_vars)


@pytest.mark.parametrize("mode", ["teacher_forced", "free_running"])
def test_forward_matches_jax(fs2_vars, mode):
    jcfg, pcfg = cfgs()
    batch = tts_batch(53)
    tf = mode == "teacher_forced"
    kw = dict(max_out_len=11) if tf else dict(max_out_len=40, d_factor=2.7,
                                              min_duration=1)
    names = ("durations", "pitches", "energies") if tf else ()
    ref = jax.jit(lambda v, b: jf.forward(
        v, jcfg, b["src_text"], b["src_text_len"],
        **{k: b[k] for k in names}, **kw))(jnp_tree(fs2_vars),
                                           jnp_tree(batch))
    model = pf.from_jax_variables(pcfg, numpy_vars(fs2_vars)).eval()
    pb = port_batch(batch)
    with torch.no_grad():
        out = model(pb["src_text"], pb["src_text_len"],
                    **{k: pb[k] for k in names}, **kw)
    assert out["out_lens"].tolist() == np.asarray(ref["out_lens"]).tolist()
    for key in ("feat_out", "post_feat_out", "log_dur_out", "pitch_out",
                "energy_out", "ctc_logits"):
        close(out[key], ref[key], msg=key)


def test_fastspeech2_loss_matches_jax(fs2_vars):
    jcfg, pcfg = cfgs()
    batch = tts_batch(54)
    lcfg = dict(ctc_weight=0.5)

    def loss_fn(params):
        loss, ex = jl.fastspeech2_loss({"params": params,
                                        "stats": fs2_vars["stats"]}, jcfg,
                                       jl.LossConfig(**lcfg),
                                       jnp_tree(batch), rng=None, train=True)
        return loss, ex

    (j_loss, j_ex), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jnp_tree(fs2_vars["params"]))
    model = pf.from_jax_variables(pcfg, numpy_vars(fs2_vars))
    p_loss, p_ex = pl.fastspeech2_loss(model, pl.LossConfig(**lcfg),
                                       port_batch(batch), train=True)
    p_loss.backward()
    close(p_loss, j_loss, atol=0.0)
    j_log = j_ex["logging"]
    for key in ("l1_loss", "dur_loss", "pitch_loss", "energy_loss",
                "ctc_loss"):
        close(p_ex["logging"][key], j_log[key], msg=key)
    assert float(j_log["ctc_loss"]) > 0
    assert int(p_ex["sample_size"]) == int(j_ex["sample_size"]) == 3
    for key, v in flatten_tree(numpy_vars(j_ex["new_stats"])).items():
        grp, bn, leaf = key.split("::")
        close(torch.as_tensor(p_ex["new_stats"][grp][bn][leaf]), v, msg=key)
    got = grads_with_zeros(model)
    ref = {f"params::{k}": v for k, v in
           flatten_tree(numpy_vars(j_grads)).items()}
    assert sorted(got) == sorted(ref)
    for key, g in ref.items():
        close(torch.from_numpy(got[key]), g, atol=1e-6, rtol=1e-4, msg=key)


def test_variance_collate_matches_jax(tmp_path):
    from pathlib import Path
    from s2st_tpu.data.data_cfg import S2STDataConfig as JaxDataConfig
    from s2st_tpu.data.dictionary import Dictionary as JaxDictionary
    from s2st_tpu.data.s2st_dataset import S2STDatasetCreator
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus", variance_columns=True)
    names = ("src_vocab.txt", "tgt_vocab.txt")
    jds = S2STDatasetCreator.from_tsv(
        str(corpus), JaxDataConfig(Path(corpus) / "config.yaml"), "train",
        *[JaxDictionary.load(str(corpus / n)) for n in names],
        is_train_split=True)
    split = TrainSplit(str(corpus),
                       S2STDataConfig(Path(corpus) / "config.yaml"), "train",
                       *[Dictionary.load(str(corpus / n)) for n in names])
    indices = [3, 0, 7, 5]
    ref = jds.collate([jds[i] for i in indices], pad_batch=6, pad_src_txt=8)
    got = split.collate([split.item(i) for i in indices], pad_batch=6,
                        pad_src_txt=8)
    assert got["durations"].any()
    for key in ("src_text", "durations", "pitches", "energies"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key],
                                      err_msg=key)


def test_fairseq_state_dict_matches_jax():
    from s2st_tpu.models.torch_import import fs2_from_fairseq_state_dict
    from s2st_tpu_torch.models.fairseq_checkpoint import fs2_from_fairseq
    _, pcfg = cfgs()
    sd = pf.FastSpeech2(pcfg).init_weights(55).state_dict()
    assert sd["encoder.pos_emb_alpha"].shape == (1,)
    ref = fs2_from_fairseq_state_dict({k: v.numpy() for k, v in sd.items()})
    assert_same_tree(jax_variables(fs2_from_fairseq(pcfg, sd)), ref)


def test_train_cli_then_serving_matches_jax(tmp_path):
    from s2st_tpu.cli import generate_waveform as jgen
    from s2st_tpu_torch.cli import generate_waveform as pgen
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus", variance_columns=True)
    logs, loaded = train_and_load_in_jax(
        corpus, tmp_path / "ckpt",
        ["--arch", "fastspeech2", "--criterion", "fastspeech2",
         "--batch-size", "8", "--encoder-embed-dim", "16",
         "--decoder-embed-dim", "16", "--fft-hidden-dim", "32",
         "--var-pred-hidden-dim", "8", "--encoder-layers", "1",
         "--decoder-layers", "2", "--add-postnet", "--postnet-conv-dim",
         "8"])
    assert all(r["dur_loss"] > 0 for r in logs)
    assert loaded["params"]["pos_emb_alpha"].shape == ()
    argv = [str(corpus), "--config-yaml", "config.yaml", "--gen-subset",
            "test", "--path", str(tmp_path / "ckpt" / "checkpoint_last.npz"),
            "--max-iter", "48", "--duration-factor", "1.5",
            "--min-duration", "1", "--dump-features"]
    assert jgen.main(argv + ["--results-path", str(tmp_path / "jax")]) == 0
    assert pgen.main(argv + ["--results-path", str(tmp_path / "port"),
                             "--device", "cpu"]) == 0
    ref = sorted((tmp_path / "jax" / "feat").glob("*_pred.npy"))
    got = sorted((tmp_path / "port" / "feat").glob("*_pred.npy"))
    assert [p.name for p in got] == [p.name for p in ref] and len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.load(g), np.load(r), atol=1e-5,
                                   rtol=1e-5, err_msg=g.name)


@pytest.mark.parametrize("optimizer", ["adam", "adafactor"])
def test_train_cli_resumes_the_scalar_alphas(optimizer, tmp_path):
    """The alphas are (1,) in the port and () in JAX's files, their
    optimizer state too (adafactor's in JAX's layout of the leaf): a run
    stopped after 1 update resumes to 2."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.train import checkpoint as pckpt
    from tests.make_tiny_corpus import make_tiny_corpus
    from tests.test_torch_berard import CLI_FLAGS
    corpus = make_tiny_corpus(tmp_path / "corpus", n_train=8,
                              variance_columns=True)
    save = tmp_path / "ckpt"
    argv = [str(corpus), *CLI_FLAGS, "--arch", "fastspeech2", "--criterion",
            "fastspeech2", "--encoder-embed-dim", "16",
            "--decoder-embed-dim", "16", "--fft-hidden-dim", "16",
            "--var-pred-hidden-dim", "8", "--optimizer", optimizer,
            "--save-dir", str(save)]
    at = argv.index("--max-update") + 1
    for updates in ("1", "2"):
        argv[at] = updates
        assert train.main(argv) == 0
    flat, meta = pckpt.load_checkpoint_file(str(save / "checkpoint_last.npz"))
    assert meta["step"] == 2
    # the leaves and their parameter-shaped state; adafactor's unfactored
    # row and column placeholders are (1,), as optax keeps them
    scalars = [k for k in flat if k.endswith("pos_emb_alpha")
               and "v_row" not in k and "v_col" not in k]
    assert len(scalars) >= 4 and all(flat[k].shape == () for k in scalars)
