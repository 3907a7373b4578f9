"""s2st_tpu_torch's T2S model (the paper's pseudo-label TTS) against
s2st_tpu's, fp32 on the CPU.

The ``tiny_cfg`` spectrogram decoder (2 layers of 16-d, 2-layer postnet)
with every dropout rate at 0 as the T2S base, a text encoder of 2
conv-BatchNorm blocks (kernel 5) and 2 transformer layers, one JAX
``init_t2s`` (its BatchNorm statistics redrawn, so that eval mode reads
them) carried into the port by its JAX bridge:

- the text encoder in eval and in train mode: output, lengths and the
  BatchNorms' new running statistics;
- the training forward, ``t2s_loss`` (its logged values and new
  statistics) and per-leaf gradients;
- the text-input decode: the port's ``generate_from_encoder_out`` over
  the T2S encoder against JAX's, prenet dropout off;
- the train CLI: 2 updates of ``--arch t2s_transformer --criterion
  t2s_loss`` in each package from one init (JAX's init patched to the
  port's seeded weights): the logged losses and the running statistics
  of the encoder's BatchNorms and the postnet's; then each package's
  ``generate_waveform`` on the port's checkpoint from the test split's
  text: the same features a row;
- the arch table: ``t2s_transformer`` builds the T2S model and
  ``t2s_loss``; ``tts_transformer``, registered beside it, builds the S2ST
  model in both packages (JAX dispatches on the ``t2s_transformer``
  prefix); a T2S ``.pt`` raises in both serving CLIs;
- the fairseq reader: ``t2s_from_fairseq`` against JAX's
  ``t2s_from_fairseq_state_dict`` on a seeded fairseq-layout state dict.

Tolerances (fp32 both sides, summation order only): outputs and
statistics atol 1e-5 + rtol 1e-5; gradients atol 1e-6 + rtol 1e-4, as
``tests/test_torch_train.py`` holds them; the CLI losses as JAX logs them,
rounded to 4 decimals (atol 1e-4), the statistics as the test says; the
served features (both CLIs on one checkpoint) atol 1e-5 + rtol 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import t2s_transformer as jt2s
from s2st_tpu.train import losses as jl
from s2st_tpu_torch.models import t2s_transformer as pt2s
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import numpy_tree, one_thread, port_cfg  # noqa: F401
from tests.conftest import make_batch
from tests.test_torch_train import (NO_DROPOUT, close, jax_leaves,
                                    port_batch, port_leaves)

T2S = dict(encoder_conv_layers=2, encoder_conv_kernel_size=5,
           encoder_transformer_layers=2, encoder_dropout=0.0)


@pytest.fixture(scope="module")
def t2s(tiny_cfg):
    base = tiny_cfg.replace(ctc=False, aux_asr=False, aux_st=False,
                            middle_layers=(), **NO_DROPOUT)
    jcfg = jt2s.T2SConfig(base=base, **T2S)
    v = jt2s.init_t2s(jax.random.PRNGKey(5), jcfg)
    r = np.random.RandomState(6)
    stats = numpy_tree(v["stats"])
    for group in stats.values():
        for bn in group.values():
            bn["mean"] = r.randn(*bn["mean"].shape).astype(np.float32)
            bn["var"] = r.uniform(0.5, 2.0, bn["var"].shape).astype(
                np.float32)
            bn["count"] = np.int32(3)
    return jcfg, {"params": v["params"], "stats": stats}


def port_t2s(jcfg, variables):
    pcfg = pt2s.T2SConfig(base=port_cfg(jcfg.base), **T2S)
    return pt2s.from_jax_variables(pcfg, numpy_tree(variables)).eval()


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def close_stats(got, want):
    for bn, st in want.items():
        for key in ("mean", "var"):
            close(got[bn][key], st[key], msg=f"{bn}::{key}")
        assert int(got[bn]["count"]) == int(st["count"]), bn


@pytest.mark.parametrize("train", [False, True])
def test_encoder_matches_jax(t2s, train):
    jcfg, v = t2s
    batch = make_batch(jcfg.base, b=3, src_n=9, seed=41)
    ref = jt2s.encode(jnp_tree(v), jcfg, jnp.asarray(batch["src_text"]),
                      deterministic=True, train=train)
    model = port_t2s(jcfg, v)
    with torch.no_grad():
        out = model.encoder(torch.from_numpy(batch["src_text"]).long(),
                            train=train)
    close(out["encoder_out"], ref["encoder_out"])
    assert out["out_lengths"].tolist() == \
        np.asarray(ref["out_lengths"]).tolist()
    assert out["encoder_padding_mask"].tolist() == \
        np.asarray(ref["encoder_padding_mask"]).tolist()
    close_stats(out["new_stats"], numpy_tree(ref["new_stats"]))
    if train:   # the batch's statistics moved the running ones
        assert not np.allclose(out["new_stats"]["bn0"]["mean"],
                               v["stats"]["encoder"]["bn0"]["mean"])


def test_t2s_loss_and_grads_match_jax(t2s):
    jcfg, v = t2s
    batch = make_batch(jcfg.base, b=3, src_n=9, seed=42)
    jlcfg = jl.LossConfig(use_guided_attention_loss=True)

    def loss_fn(params):
        loss, ex = jl.t2s_loss({"params": params, "stats": v["stats"]},
                               jcfg, jlcfg, jnp_tree(batch), rng=None,
                               train=True)
        return loss, (ex["logging"], ex["new_stats"])

    (j_loss, (j_log, j_stats)), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jnp_tree(v["params"]))
    model = port_t2s(jcfg, v)
    p_loss, p_ex = pl.t2s_loss(model, pl.LossConfig(
        use_guided_attention_loss=True), port_batch(batch), train=True)
    p_loss.backward()
    close(p_loss, j_loss)
    log = p_ex["logging"]
    assert set(log) == set(j_log)
    for key in pl.MEAN_KEYS:
        close(torch.as_tensor(log[key]), j_log[key], msg=key)
    assert float(log["ctc_loss_tgt"]) == float(log["ctc_loss"]) == 0.0
    assert float(p_ex["sample_size"]) == float(j_log["sample_size"])
    j_stats = numpy_tree(j_stats)
    assert set(p_ex["new_stats"]) == set(j_stats) == {"encoder", "postnet"}
    for group in j_stats:
        close_stats(p_ex["new_stats"][group], j_stats[group])
    got = port_leaves(model, grads=True)
    ref = jax_leaves(j_grads, "params")
    assert set(got) == set(ref)
    for key, g in ref.items():
        close(torch.from_numpy(got[key]), g, atol=1e-6, rtol=1e-4, msg=key)


def test_text_input_decode_matches_jax(t2s):
    """generate_waveform's text path, below the CLI: the T2S encoder, then
    the shared AR decode, postnet and GCMVN denormalisation, prenet
    dropout off, over rows whose texts differ in length and a pad row."""
    from s2st_tpu.generate import speech_generator as jsg
    from s2st_tpu_torch.generate import speech_generator as psg
    jcfg, v = t2s
    batch = make_batch(jcfg.base, b=3, src_n=9, seed=43)
    tokens = np.concatenate([batch["src_text"], np.ones((1, 9), np.int32)])
    r = np.random.RandomState(7)
    mean, std = r.randn(8).astype(np.float32), \
        r.uniform(0.5, 2, 8).astype(np.float32)
    jv = jnp_tree(v)
    enc = jt2s.encode(jv, jcfg, jnp.asarray(tokens))
    kw = dict(max_iter=12, eos_prob_threshold=0.5,
              prenet_dropout_at_inference=False)
    ref = jsg.generate_from_encoder_out(
        {"params": jv["params"], "stats": {"postnet": jv["stats"]["postnet"]}},
        jcfg.base, jsg.GenerationConfig(**kw), enc, gcmvn_mean=mean,
        gcmvn_std=std)
    model = port_t2s(jcfg, v)
    with torch.no_grad():
        out = psg.generate_from_encoder_out(
            model, psg.GenerationConfig(**kw),
            model.encode(torch.from_numpy(tokens).long()),
            gcmvn_mean=torch.from_numpy(mean), gcmvn_std=torch.from_numpy(std))
    for key in ("feats", "eos_prob", "attn"):
        close(out[key], ref[key], msg=key)
    for key in ("raw_out_lens", "out_lens", "enc_lens"):
        assert out[key].tolist() == np.asarray(ref[key]).tolist(), key


T2S_FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset", "train",
    "--valid-subset", "dev", "--task", "s2s_translation",
    "--criterion", "t2s_loss", "--arch", "t2s_transformer",
    "--encoder-conv-layers", "2", "--encoder-conv-kernel-size", "5",
    "--encoder-transformer-layers", "1", "--encoder-dropout", "0",
    "--encoder-embed-dim", "16", "--encoder-ffn-embed-dim", "32",
    "--encoder-attention-heads", "2", "--decoder-layers", "1",
    "--decoder-embed-dim", "16", "--decoder-ffn-embed-dim", "32",
    "--decoder-attention-heads", "2", "--prenet-dim", "8",
    "--prenet-layers", "1", "--postnet-layers", "2",
    "--postnet-conv-dim", "8", "--output-frame-dim", "8",
    "--n-frames-per-step", "2", "--max-source-positions", "128",
    "--max-target-positions", "64", "--dropout", "0",
    "--attention-dropout", "0", "--activation-dropout", "0",
    "--prenet-dropout", "0", "--postnet-dropout", "0",
    "--use-guided-attention-loss", "--optimizer", "adam", "--lr", "1e-3",
    "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4",
    "--clip-norm", "1.0", "--seed", "1", "--max-tokens", "200",
    "--max-update", "2", "--disable-validation", "--log-interval", "1",
    "--log-format", "json", "--required-batch-size-multiple", "1"]
GEN_FLAGS = ["--config-yaml", "config.yaml", "--gen-subset", "test",
             "--max-iter", "10", "--spec-bwd-max-iter", "2",
             "--dump-features", "--dump-waveforms"]


def test_train_and_serve_clis_match_jax(tmp_path):
    """Both packages' T2S train CLI from one init: the logged losses of the
    2 updates, and the running statistics in checkpoint_last.npz: the
    variances and counts as the outputs are held; the means atol 2e-4, 0.1
    lr an update, since each takes in its conv's bias, whose gradient is 0
    in exact arithmetic (fp32 noise, which Adam turns into steps of up to
    lr). Then JAX's serving CLI and the port's on the port's checkpoint:
    the test split's 4 texts in JAX's batch of 8 rows (4 all PAD), the same
    features a row, and the port's WAVs."""
    from s2st_tpu.cli.generate_waveform import main as jax_gen
    from s2st_tpu.cli.train import main as jax_train
    from s2st_tpu_torch.cli import generate_waveform, train
    from s2st_tpu_torch.models.jax_bridge import jax_variables
    from s2st_tpu_torch.tasks.s2s_translation import build_model_and_loss
    from s2st_tpu_torch.train.checkpoint import load_checkpoint_file
    from tests.make_tiny_corpus import make_tiny_corpus
    from tests.test_torch_hubert import _losses
    from tests.test_torch_paper_recipes import jax_log_handlers
    corpus = make_tiny_corpus(tmp_path / "corpus")
    argv = [str(corpus), *T2S_FLAGS]
    _, model, _ = build_model_and_loss(train.get_parser().parse_args(argv),
                                       11, 11, 8)
    init = jnp_tree(jax_variables(model))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jt2s, "init_t2s", lambda *a, **k: init)
        for pkg, main, extra in (("port", train.main, ["--device", "cpu"]),
                                 ("jax", jax_train, [])):
            save = tmp_path / pkg
            with jax_log_handlers():
                assert main(argv + extra + ["--save-dir", str(save),
                                            "--log-file",
                                            str(save / "log")]) == 0, pkg
            runs[pkg] = save
    ckpt = str(runs["port"] / "checkpoint_last.npz")
    for pkg, main, extra in (
            ("port", generate_waveform.main, ["--device", "cpu"]),
            ("jax", jax_gen, [])):
        assert main([str(corpus), *GEN_FLAGS, "--path", ckpt,
                     "--results-path", str(tmp_path / f"gen_{pkg}"),
                     *extra]) == 0, pkg
        runs[f"gen_{pkg}"] = tmp_path / f"gen_{pkg}"

    want = _losses(runs["jax"] / "log", "train_inner_loss")
    got = _losses(runs["port"] / "log", "loss")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    ours = load_checkpoint_file(str(runs["port"] / "checkpoint_last.npz"))[0]
    theirs = load_checkpoint_file(str(runs["jax"] / "checkpoint_last.npz"))[0]
    assert set(ours) == set(theirs)
    stats = [k for k in theirs if k.startswith("stats::")]
    assert {k.split("::")[1] for k in stats} == {"encoder", "postnet"}
    assert int(ours["stats::encoder::bn0::count"]) == 2
    for k in stats:
        if k.endswith("::count"):
            assert int(ours[k]) == int(theirs[k]), k
        else:
            np.testing.assert_allclose(
                ours[k], theirs[k], rtol=1e-5,
                atol=2e-4 if k.endswith("::mean") else 1e-5, err_msg=k)

    port, ref = runs["gen_port"], runs["gen_jax"]
    want = sorted((ref / "feat").glob("*_pred.npy"))
    assert len(want) == 4
    assert [p.name for p in sorted((port / "feat").glob("*_pred.npy"))] \
        == [p.name for p in want]
    for w in want:
        np.testing.assert_allclose(np.load(port / "feat" / w.name),
                                   np.load(w), atol=1e-5, rtol=1e-5,
                                   err_msg=w.name)
    assert len(list((port / "wav").glob("*_pred.wav"))) == 4
    assert json.loads((port / "timing.json").read_text())


def test_arch_names_build_as_in_jax(tmp_path):
    """t2s_transformer builds the T2S model and t2s_loss in both
    packages; tts_transformer, registered beside it with the same arch
    function, builds the S2ST model (JAX's dispatch matches the
    t2s_transformer prefix only)."""
    from s2st_tpu.options import parse_training_args
    from s2st_tpu.tasks.s2s_translation import S2STranslationTask
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from s2st_tpu_torch.tasks.s2s_translation import build_model_and_loss
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus")
    for arch, cls, loss in (("t2s_transformer", pt2s.T2STransformer,
                             "t2s_loss"),
                            ("tts_transformer", S2STTransformer,
                             "s2st_loss")):
        argv = [str(corpus), *T2S_FLAGS, "--arch", arch]
        task = S2STranslationTask.setup_task(parse_training_args(argv))
        _, _, jloss = task.build_model_and_loss()
        _, model, ploss = build_model_and_loss(
            train.get_parser().parse_args(argv), 11, 11, 8)
        assert type(model) is cls and jloss.__name__ == loss == \
            ploss.__name__, arch


def test_fairseq_t2s_state_dict_matches_jax():
    """The fork's t2s_transformer names (a seeded state dict in the port
    model's layout, one BatchNorm count left out) give JAX's tree through
    both readers."""
    from s2st_tpu.models.torch_import import t2s_from_fairseq_state_dict
    from s2st_tpu_torch.models.fairseq_checkpoint import t2s_from_fairseq
    from s2st_tpu_torch.models.jax_bridge import flatten_tree, jax_variables
    base = port_cfg(jt2s.T2SConfig().base, src_vocab_size=20,
                    encoder_embed_dim=16, encoder_ffn_embed_dim=32,
                    encoder_attention_heads=2, decoder_layers=1,
                    decoder_embed_dim=16, decoder_ffn_embed_dim=32,
                    decoder_attention_heads=2, output_frame_dim=8,
                    prenet_dim=8, postnet_conv_dim=8, postnet_layers=2,
                    num_speakers=2, speaker_embed_dim=8)
    pcfg = pt2s.T2SConfig(base=base, **T2S)
    g = torch.Generator().manual_seed(8)
    sd = {k: (torch.randn(v.shape, generator=g) if v.is_floating_point()
              else torch.randint(0, 9, v.shape, generator=g))
          for k, v in pt2s.T2STransformer(pcfg).state_dict().items()}
    del sd["encoder.prenet.1.1.num_batches_tracked"]
    ref = t2s_from_fairseq_state_dict({k: v.numpy() for k, v in sd.items()})
    got = jax_variables(t2s_from_fairseq(pcfg, sd))
    want = flatten_tree(numpy_tree(ref))
    have = flatten_tree(got)
    assert set(have) == set(want)
    for k in want:
        assert np.array_equal(have[k], want[k]), k
    assert int(want["stats::encoder::bn1::count"]) == 0


def test_t2s_pt_raises_in_both_serving_clis(tmp_path):
    """A fairseq .pt is read as an S2ST checkpoint by both serving CLIs
    (JAX's load_variables_any), so a T2S file raises KeyError in both."""
    from s2st_tpu.cli.generate_waveform import main as jax_gen
    from s2st_tpu_torch.cli import generate_waveform, train
    from s2st_tpu_torch.tasks.s2s_translation import build_model_and_loss
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus")
    _, model, _ = build_model_and_loss(train.get_parser().parse_args(
        [str(corpus), *T2S_FLAGS]), 11, 11, 8)
    pt = tmp_path / "t2s.pt"
    torch.save({"model": model.state_dict()}, pt)
    model_flags = T2S_FLAGS[T2S_FLAGS.index("--arch"):
                            T2S_FLAGS.index("--use-guided-attention-loss")]
    for main, extra in ((generate_waveform.main, ["--device", "cpu"]),
                        (jax_gen, [])):
        with pytest.raises(KeyError):
            main([str(corpus), *GEN_FLAGS, "--path", str(pt),
                  "--results-path", str(tmp_path / "out"), *model_flags,
                  *extra])
