"""s2st_tpu_torch's LSTM runner and Berard against s2st_tpu's, fp32 on the
CPU, dropout off.

- The packed LSTM layer against JAX's ``_run_lstm``, both directions at
  once, every length from T down to 0 at T = 1, 2 and 9: the outputs
  (zero past each length) and each direction's final (h, c).
- Berard (2-layer input MLP, two stride-2 convs, 2 biLSTM layers of 6, a
  2-layer decoder of 12), one JAX ``init_berard`` carried over by the
  bridge, which gives JAX's tree back unchanged: the encoder's lengths
  and values for every length from T down to 1 at T = 5, 8 and 37 (its
  fp32 floor arithmetic); ``s2t_loss`` under ``--test-type st`` and
  ``asr`` with per-leaf gradients.
- The arch table of the three families of this slice (the four Berard
  sizes, ``tacotron_2``, ``tacotron2``, ``fastspeech2``): the defaults as
  JAX's ``_two_pass`` gives them, a flag given on the command line
  winning (``tacotron2`` against JAX's ``tacotron_2``: JAX's CLI knows
  only that name, and its function sets the parser's defaults).
- The port's train CLI takes 2 updates of ``s2t_berard`` (one batch of 8
  rows an epoch: a pad row has no key to attend to, and its NaN reaches
  every gradient, in JAX as here), and JAX loads its
  ``checkpoint_last.npz`` strictly into its own init's template.

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; the loss rtol 1e-5; gradients atol 1e-6 + rtol 1e-4, as
``tests/test_torch_train.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import berard as jb
from s2st_tpu.models import lstm as jlstm
from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu_torch.models import berard as pb
from s2st_tpu_torch.models import lstm as plstm
from s2st_tpu_torch.models.jax_bridge import flatten_tree, jax_variables
from tests._torch_port import one_thread  # noqa: F401
from tests.conftest import make_batch
from tests.test_torch_train import close
from tests.test_torch_xm_convtransformer import check_s2t_loss, jnp_tree

SMALL = dict(input_feat_per_channel=8, input_layers=(12, 8),
             conv_layers=((4, 3, 2), (3, 3, 2)), num_blstm_layers=2,
             lstm_size=6, decoder_embed_dim=5, decoder_num_layers=2,
             decoder_hidden_dim=12, attention_dim=7, output_layer_dim=9,
             dropout=0.0)
VOCAB = {"st": 14, "asr": 12}
TEXT = jm.S2STConfig(src_vocab_size=VOCAB["asr"],
                     tgt_vocab_size=VOCAB["st"], input_feat_per_channel=8,
                     output_frame_dim=8)


def numpy_vars(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_same_tree(port, ref):
    """Two {"params", "stats"} trees hold the same keys, shapes and
    values."""
    a, b = flatten_tree(port), flatten_tree(numpy_vars(ref))
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].shape == b[key].shape, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def torch_lstm(p):
    return [torch.from_numpy(np.array(p[k])) for k in
            ("w_ih", "w_hh", "b_ih", "b_hh")]


@pytest.mark.parametrize("t", [1, 2, 9])
def test_lstm_layer_matches_run_lstm(t):
    r = np.random.RandomState(t)
    x = r.randn(t + 1, t, 5).astype(np.float32)
    lens = np.arange(t, -1, -1, dtype=np.int32)          # T, T-1, ..., 0
    pf = jlstm._lstm_params(jax.random.PRNGKey(1), 5, 4)
    pr = jlstm._lstm_params(jax.random.PRNGKey(2), 5, 4)
    run = jax.jit(jlstm._run_lstm, static_argnames="reverse")
    of, (hf, cf) = run(pf, jnp.asarray(x), jnp.asarray(lens))
    ob, (hb, cb) = run(pr, jnp.asarray(x), jnp.asarray(lens), reverse=True)
    with torch.no_grad():
        out, (h, c) = plstm.lstm_layer(torch.from_numpy(x),
                                       torch.from_numpy(lens).long(),
                                       torch_lstm(pf), torch_lstm(pr))
    close(out, np.concatenate([of, ob], axis=-1))
    for got, ref in ((h[0], hf), (c[0], cf), (h[1], hb), (c[1], cb)):
        close(got, ref)


def berard_cfgs(test_type="st"):
    jcfg = jb.BerardConfig(vocab_size=VOCAB[test_type], dtype=jnp.float32,
                           **SMALL)
    pcfg = pb.BerardConfig(vocab_size=VOCAB[test_type], **SMALL)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def berard_vars():
    return {t: jb.init_berard(jax.random.PRNGKey(31), berard_cfgs(t)[0])
            for t in VOCAB}


def test_bridge_gives_jax_tree_back(berard_vars):
    _, pcfg = berard_cfgs("st")
    model = pb.from_jax_variables(pcfg, numpy_vars(berard_vars["st"]))
    assert_same_tree(jax_variables(model), berard_vars["st"])


def test_encoder_lengths_and_values_match_jax(berard_vars):
    jcfg, pcfg = berard_cfgs()
    variables = berard_vars["st"]
    model = pb.from_jax_variables(pcfg, numpy_vars(variables)).eval()
    encode = jax.jit(lambda v, x, n: jb.encode(v, jcfg, x, n))
    r = np.random.RandomState(32)
    for t in (5, 8, 37):
        x = r.randn(t, t, 8).astype(np.float32)
        lens = np.arange(t, 0, -1, dtype=np.int32)       # T, T-1, ..., 1
        ref = encode(jnp_tree(variables), jnp.asarray(x), jnp.asarray(lens))
        with torch.no_grad():
            out = model.encoder(torch.from_numpy(x),
                                torch.from_numpy(lens).long())
        assert out["out_lengths"].tolist() == \
            np.asarray(ref["out_lengths"]).tolist(), t
        close(out["encoder_out"], ref["encoder_out"], msg=f"T={t}")


@pytest.mark.parametrize("test_type", ["st", "asr"])
def test_berard_s2t_loss_matches_jax(berard_vars, test_type):
    jcfg, pcfg = berard_cfgs(test_type)
    model = pb.from_jax_variables(pcfg, numpy_vars(berard_vars[test_type]))
    got = check_s2t_loss(jcfg, berard_vars[test_type], model,
                         make_batch(TEXT, b=3, src_t=29, seed=33), test_type,
                         "berard")
    assert got["params::encoder::l0_rev::w_ih"].any()
    assert got["params::decoder::cell1::w_hh"].any()


ARCH_CASES = [["--arch", a] for a in (
    "s2t_berard", "s2t_berard_256_3_3", "s2t_berard_512_5_3",
    "s2t_berard_512_3_2", "tacotron_2", "fastspeech2")] + [
    ["--arch", "s2t_berard", "--attention-dim", "64", "--dropout", "0.1"],
    ["--arch", "s2t_berard_512_5_3", "--attention-dim", "32",
     "--decoder-embed-dim", "64"],
    ["--arch", "tacotron_2", "--encoder-embed-dim", "256", "--zoneout",
     "0.0", "--init-attn-c", "avg"],
    ["--arch", "fastspeech2", "--encoder-layers", "2", "--attention-dropout",
     "0.1", "--add-postnet", "--fft-kernel-size", "5"],
]
ARCH_KEYS = ("encoder_embed_dim", "decoder_embed_dim",
             "encoder_attention_heads", "decoder_attention_heads",
             "encoder_layers", "decoder_layers", "dropout",
             "attention_dropout", "encoder_dropout", "encoder_conv_layers",
             "encoder_conv_kernel_size", "input_layers", "conv_layers",
             "num_blstm_layers", "lstm_size", "decoder_num_layers",
             "decoder_hidden_dim", "attention_dim", "output_layer_dim",
             "encoder_lstm_layers", "attention_conv_dim",
             "attention_conv_kernel_size", "init_attn_c",
             "attention_use_cumprob", "zoneout", "decoder_lstm_layers",
             "decoder_lstm_dim", "fft_hidden_dim", "fft_kernel_size",
             "var_pred_n_bins", "var_pred_hidden_dim",
             "var_pred_kernel_size", "var_pred_dropout", "pitch_min",
             "pitch_max", "energy_min", "energy_max", "add_postnet")


@pytest.mark.parametrize("flags", ARCH_CASES + [["--arch", "tacotron2"]],
                         ids="-".join)
def test_arch_defaults_match_jax(flags, tmp_path):
    from s2st_tpu.options import parse_training_args
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import (apply_arch,
                                                        arch_family)
    argv = [str(tmp_path), *flags]
    got = apply_arch(train.get_parser().parse_args(argv), argv)
    jflags = ["--arch", "tacotron_2"] if flags == ["--arch", "tacotron2"] \
        else flags
    ref = parse_training_args([str(tmp_path), *jflags])
    for key in ARCH_KEYS:
        assert getattr(got, key, None) == getattr(ref, key, None), key
    assert arch_family(got) == {"s2t": "berard", "tac": "tacotron2",
                                "fas": "fastspeech2"}[flags[1][:3]]


# the tiny widths of the three families' train CLI tests
CLI_FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset", "train",
    "--optimizer", "adam", "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt",
    "--warmup-updates", "4", "--clip-norm", "1.0", "--max-update", "2",
    "--max-tokens", "100000", "--disable-validation", "--log-interval", "1",
    "--output-frame-dim", "8", "--max-source-positions", "256",
    "--max-target-positions", "64", "--device", "cpu"]


def train_and_load_in_jax(corpus, save, flags):
    """2 updates of the port's train CLI; then JAX's task builds the same
    arch from the same flags and loads checkpoint_last.npz strictly into
    its init's template. Returns (the per-update log, JAX's variables)."""
    import json
    from s2st_tpu.options import parse_training_args
    from s2st_tpu.tasks.s2s_translation import S2STranslationTask
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu_torch.cli import train
    argv = [str(corpus), *CLI_FLAGS, *flags]
    assert train.main(argv + ["--save-dir", str(save), "--log-file",
                              str(save / "log")]) == 0
    logs = [json.loads(line) for line in
            (save / "log").read_text().splitlines()]
    assert [r["num_updates"] for r in logs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["gnorm"])
               for r in logs)
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    task = S2STranslationTask.setup_task(parse_training_args(jargv))
    _, init_fn, _ = task.build_model_and_loss()
    template = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    return logs, jckpt.load_variables_any(
        str(save / "checkpoint_last.npz"), template=template)


def test_train_cli_runs_and_jax_loads_its_checkpoint(tmp_path):
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus", n_train=8)
    logs, loaded = train_and_load_in_jax(
        corpus, tmp_path / "ckpt",
        ["--arch", "s2t_berard", "--criterion", "s2t_loss", "--test-type",
         "st", "--label-smoothing", "0.1", "--batch-size", "8"])
    assert all(r["loss"] > 0 for r in logs)
    assert set(loaded["params"]["encoder"]) == {
        "input0", "input1", "conv0", "conv1", "l0", "l0_rev", "l1",
        "l1_rev", "l2", "l2_rev"}
