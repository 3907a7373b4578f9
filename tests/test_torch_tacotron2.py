"""s2st_tpu_torch's Tacotron2 against s2st_tpu's, fp32 on the CPU, dropout
off.

- A small Tacotron2 (16-d, 2 convs, 2 biLSTM layers, 2 x 12 zoneout LSTMs,
  attention 8 with 4 location filters of 7), one JAX ``init_tacotron2``
  carried over by the bridge, which gives JAX's tree back unchanged (the
  encoder's BatchNorm statistics under ``stats::enc_bn<i>``): the
  teacher-forced forward in eval and in training (batch statistics, the
  zoneout's interpolation: JAX's path without a key) and the new
  statistics; ``tacotron2_loss`` with guided attention, per-leaf
  gradients; ``generate_features`` over 6 steps with ``init_attn_c`` zero
  and avg, ``attention_use_cumprob`` on and off.
- The fairseq reader: a state_dict written from the port's module (with
  the reference's never-applied ``decoder.ctc_proj``) gives the same tree
  through JAX's ``tacotron2_from_fairseq_state_dict`` and the port's
  ``tacotron2_from_fairseq``.
- The port's train CLI takes 2 updates of ``tacotron_2`` with guided
  attention, and JAX loads its ``checkpoint_last.npz`` strictly; then
  JAX's ``generate_waveform`` and the port's both refuse that checkpoint
  with ``AttributeError`` (a Tacotron2 config has no
  ``max_target_positions``; ROADMAP §3).

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; the loss rtol 1e-5; gradients atol 1e-6 + rtol 1e-4, as
``tests/test_torch_train.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import tacotron2 as jt
from s2st_tpu.train import losses as jl
from s2st_tpu_torch.models import tacotron2 as pt
from s2st_tpu_torch.models.jax_bridge import flatten_tree, jax_variables
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import one_thread  # noqa: F401
from tests.test_torch_berard import (assert_same_tree, numpy_vars,
                                     train_and_load_in_jax)
from tests.test_torch_train import close, port_batch
from tests.test_torch_xm_convtransformer import grads_with_zeros, jnp_tree

SMALL = dict(vocab_size=13, encoder_dropout=0.0, encoder_embed_dim=16,
             encoder_conv_layers=2, encoder_conv_kernel_size=5,
             encoder_lstm_layers=2, attention_dim=8, attention_conv_dim=4,
             attention_conv_kernel_size=3, prenet_dropout=0.0,
             prenet_layers=2, prenet_dim=8, postnet_dropout=0.0,
             postnet_layers=3, postnet_conv_dim=8,
             postnet_conv_kernel_size=5, zoneout=0.1,
             decoder_lstm_layers=2, decoder_lstm_dim=12, output_frame_dim=6,
             n_frames_per_step=2)


def cfgs(**kw):
    return (jt.Tacotron2Config(dtype=jnp.float32, **SMALL, **kw),
            pt.Tacotron2Config(**SMALL, **kw))


@pytest.fixture(scope="module")
def tc2_vars():
    return jt.init_tacotron2(jax.random.PRNGKey(41), cfgs()[0])


def tts_batch(seed, b=3, ts=9, tt=7):
    r = np.random.RandomState(seed)
    lens = np.array([ts] + list(r.randint(2, ts + 1, b - 1)), np.int32)
    tokens = r.randint(4, 13, (b, ts)).astype(np.int32)
    tokens[np.arange(ts)[None, :] >= lens[:, None]] = 1
    tgt_lens = np.array([tt] + list(r.randint(2, tt + 1, b - 1)), np.int32)
    tgt = r.randn(b, tt, 12).astype(np.float32)
    prev = np.zeros_like(tgt)
    prev[:, 1:] = tgt[:, :-1]
    return {"src_text": tokens, "src_text_len": lens,
            "prev_output_tokens": prev, "tgt_speech": tgt,
            "target_lengths": tgt_lens}


def test_bridge_gives_jax_tree_back(tc2_vars):
    model = pt.from_jax_variables(cfgs()[1], numpy_vars(tc2_vars))
    assert_same_tree(jax_variables(model), tc2_vars)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(tc2_vars, train):
    jcfg, pcfg = cfgs()
    batch = tts_batch(42)
    ref = jax.jit(lambda v, b: jt.forward(v, jcfg, b, rng=None,
                                          deterministic=True, train=train))(
        jnp_tree(tc2_vars), jnp_tree(batch))
    model = pt.from_jax_variables(pcfg, numpy_vars(tc2_vars))
    with torch.no_grad():
        out = model(port_batch(batch), train=train)
    for key in ("feat_out", "eos_out", "attn"):
        close(out[key], ref[key], msg=key)
    close(out["post_feat_out"], ref["post_feat_out"])
    if train:
        got = flatten_tree({k: {n: {s: np.asarray(v) for s, v in st.items()}
                                for n, st in grp.items()}
                            for k, grp in out["new_stats"].items()})
        want = flatten_tree(numpy_vars(ref["new_stats"]))
        renamed = {k.replace("enc_bn", "encoder::bn"): v
                   for k, v in want.items()}
        assert sorted(got) == sorted(renamed)
        for key, v in renamed.items():
            close(torch.from_numpy(got[key]), v, msg=key)


def test_tacotron2_loss_matches_jax(tc2_vars):
    jcfg, pcfg = cfgs()
    batch = tts_batch(43)
    lkw = dict(use_guided_attention_loss=True, bce_pos_weight=5.0)

    def loss_fn(params):
        loss, ex = jl.tacotron2_loss({"params": params,
                                      "stats": tc2_vars["stats"]}, jcfg,
                                     jl.LossConfig(**lkw), jnp_tree(batch),
                                     rng=None, train=True)
        return loss, ex["logging"]

    (j_loss, j_log), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jnp_tree(tc2_vars["params"]))
    model = pt.from_jax_variables(pcfg, numpy_vars(tc2_vars))
    p_loss, p_ex = pl.tacotron2_loss(model, pl.LossConfig(**lkw),
                                     port_batch(batch), train=True)
    p_loss.backward()
    close(p_loss, j_loss, atol=0.0)
    for key in ("l1_loss", "mse_loss", "eos_loss", "attn_loss"):
        close(p_ex["logging"][key], j_log[key], msg=key)
    assert float(j_log["attn_loss"]) > 0
    got = grads_with_zeros(model)
    ref = {f"params::{k}": v for k, v in
           flatten_tree(numpy_vars(j_grads)).items()}
    assert sorted(got) == sorted(ref)
    for key, g in ref.items():
        close(torch.from_numpy(got[key]), g, atol=1e-6, rtol=1e-4, msg=key)


@pytest.mark.parametrize("init_attn_c", ["zero", "avg"])
@pytest.mark.parametrize("cumprob", [True, False])
def test_generate_features_matches_jax(init_attn_c, cumprob):
    jcfg, pcfg = cfgs(init_attn_c=init_attn_c, attention_use_cumprob=cumprob)
    variables = jt.init_tacotron2(jax.random.PRNGKey(44), jcfg)
    batch = tts_batch(45)
    ref = jax.jit(lambda v, t, n: jt.generate_features(
        v, jcfg, t, n, max_iter=6, eos_prob_threshold=0.52))(
        jnp_tree(variables), jnp.asarray(batch["src_text"]),
        jnp.asarray(batch["src_text_len"]))
    model = pt.from_jax_variables(pcfg, numpy_vars(variables)).eval()
    out = model.generate_features(torch.from_numpy(batch["src_text"]).long(),
                                  torch.from_numpy(batch["src_text_len"])
                                  .long(), max_iter=6,
                                  eos_prob_threshold=0.52)
    for key in ("feature", "eos_prob", "attn"):
        close(out[key], ref[key], msg=key)
    assert out["out_lens"].tolist() == np.asarray(ref["out_lens"]).tolist()


def test_fairseq_state_dict_matches_jax():
    from s2st_tpu.models.torch_import import tacotron2_from_fairseq_state_dict
    from s2st_tpu_torch.models.fairseq_checkpoint import \
        tacotron2_from_fairseq
    _, pcfg = cfgs()
    sd = pt.Tacotron2(pcfg).init_weights(46).state_dict()
    sd["decoder.ctc_proj.weight"] = torch.ones(13, 16)
    sd["decoder.ctc_proj.bias"] = torch.ones(13)
    ref = tacotron2_from_fairseq_state_dict({k: v.numpy()
                                             for k, v in sd.items()})
    assert_same_tree(jax_variables(tacotron2_from_fairseq(pcfg, sd)), ref)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from tests.make_tiny_corpus import make_tiny_corpus
    root = tmp_path_factory.mktemp("tacotron2")
    corpus = make_tiny_corpus(root / "corpus", n_train=8)
    logs, loaded = train_and_load_in_jax(
        corpus, root / "ckpt",
        ["--arch", "tacotron_2", "--criterion", "tacotron2",
         "--use-guided-attention-loss", "--batch-size", "8",
         "--encoder-embed-dim", "16", "--attention-dim", "8",
         "--attention-conv-dim", "4", "--decoder-lstm-dim", "16",
         "--prenet-dim", "8", "--postnet-conv-dim", "8"])
    return corpus, root / "ckpt" / "checkpoint_last.npz", logs, loaded


def test_train_cli_runs_and_jax_loads_its_checkpoint(trained):
    _, _, logs, loaded = trained
    assert all(r["attn_loss"] > 0 for r in logs)
    assert loaded["stats"]["enc_bn0"]["count"] == 2
    assert loaded["stats"]["postnet"]["bn0"]["count"] == 2


def test_generate_waveform_refuses_as_jax_does(trained, tmp_path):
    from s2st_tpu.cli import generate_waveform as jgen
    from s2st_tpu_torch.cli import generate_waveform as pgen
    corpus, ckpt, _, _ = trained
    argv = [str(corpus), "--config-yaml", "config.yaml", "--gen-subset",
            "test", "--path", str(ckpt), "--max-iter", "4"]
    with pytest.raises(AttributeError, match="max_target_positions"):
        jgen.main(argv + ["--results-path", str(tmp_path / "jax")])
    with pytest.raises(AttributeError, match="max_target_positions"):
        pgen.main(argv + ["--results-path", str(tmp_path / "port"),
                          "--device", "cpu"])
