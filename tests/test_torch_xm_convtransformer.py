"""s2st_tpu_torch's xm_transformer and ConvTransformer against s2st_tpu's,
fp32 on the CPU, dropout off.

- xm_transformer on the small HuBERT trunk of ``tests/test_torch_hubert.py``
  (3 convs, 2 layers of 16-d), 3 adaptor layers of stride 2 and a 2-layer
  16-d learned-position decoder, one JAX ``init_xm`` carried over by the
  bridge: the adaptor's values and lengths over input lengths 0 to T at
  T = 1, 2 and 37, with and without its LayerNorms; the logits;
  ``s2t_loss`` under ``--test-type st`` and ``asr`` with per-leaf
  gradients (the trunk's are 0 in both: it is frozen).
- ConvTransformer (2 encoder layers of 16-d, 8 conv channels, a 2-layer
  16-d decoder), one JAX ``init_convtransformer``: the subsampled lengths
  of every length 1 to T at T = 5, 8 and 37 (subsampling factors 3, 4 and
  4), the logits, and ``s2t_loss`` under both test types with per-leaf
  gradients.
- The arch table: the defaults of ``xm_transformer``,
  ``convtransformer``, ``convtransformer_espnet``, ``t2s_transformer`` and
  ``tts_transformer`` as JAX's ``_two_pass`` gives them, a flag given on
  the command line winning.
- The port's train CLI runs 2 updates of ``xm_transformer`` (raw
  waveforms, a small trunk by the width flags) and of
  ``convtransformer_espnet``, and JAX loads each ``checkpoint_last.npz``
  strictly into its own init's template.

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; the loss rtol 1e-5; gradients atol 1e-6 + rtol 1e-4, as
``tests/test_torch_train.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import convtransformer as jct
from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.models import xm_transformer as jxm
from s2st_tpu.train import losses as jl
from s2st_tpu_torch.models import convtransformer as pct
from s2st_tpu_torch.models import hubert as ph
from s2st_tpu_torch.models import xm_transformer as pxm
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import numpy_tree, one_thread, port_cfg  # noqa: F401
from tests.conftest import make_batch
from tests.test_torch_hubert import _JAX_TINY, LENGTHS, TINY, waveforms
from tests.test_torch_train import (NO_DROPOUT, close, jax_leaves,
                                    port_batch, port_leaves)

VOCAB = {"st": 14, "asr": 12}
TEXT = jm.S2STConfig(src_vocab_size=VOCAB["asr"],
                     tgt_vocab_size=VOCAB["st"], input_feat_per_channel=8,
                     output_frame_dim=8)
XM = dict(decoder_layers=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32,
          decoder_attention_heads=2, dropout=0.0, attention_dropout=0.0,
          activation_dropout=0.0, max_target_positions=32)


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def xm_cfgs(test_type="st", **kw):
    jcfg = jxm.XMConfig(trunk=_JAX_TINY, vocab_size=VOCAB[test_type],
                        dtype=jnp.float32, **XM, **kw)
    pcfg = pxm.XMConfig(trunk=ph.HubertConfig(**TINY),
                        vocab_size=VOCAB[test_type], **XM, **kw)
    return jcfg, pcfg


def xm_batch(seed):
    batch = make_batch(TEXT, b=3, src_n=6, tgt_n=7, seed=seed)
    batch["src_speech"] = waveforms(seed, LENGTHS)
    batch["src_speech_lens"] = LENGTHS.copy()
    return batch


def grads_with_zeros(model):
    """The port's gradients, 0 where a parameter took none (JAX's
    gradient there is 0)."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return port_leaves(model, grads=True)


def check_s2t_loss(jcfg, jvars, model, batch, test_type, module):
    jlcfg = jl.LossConfig(label_smoothing=0.1)

    def loss_fn(params):
        loss, ex = jl.s2t_loss({"params": params, "stats": {}}, jcfg, jlcfg,
                               jnp_tree(batch), rng=None, train=True,
                               test_type=test_type, forward_module=module)
        return loss, ex["logging"]

    (j_loss, j_log), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jvars["params"])
    p_loss, p_ex = pl.s2t_loss(model, pl.LossConfig(label_smoothing=0.1),
                               port_batch(batch), train=True,
                               test_type=test_type)
    p_loss.backward()
    close(p_loss, j_loss)
    for key in ("loss", "nll_loss"):
        close(torch.as_tensor(p_ex["logging"][key]), j_log[key], msg=key)
    for key in ("n_correct", "total", "sample_size"):
        assert float(p_ex["logging"][key]) == float(j_log[key]), key
    got = grads_with_zeros(model)
    ref = jax_leaves(j_grads, "params")
    assert set(got) == set(ref)
    for key, g in ref.items():
        close(torch.from_numpy(got[key]), g, atol=1e-6, rtol=1e-4, msg=key)
    return got


@pytest.fixture(scope="module")
def xm_vars():
    return {t: jxm.init_xm(jax.random.PRNGKey(21), xm_cfgs(t)[0])
            for t in VOCAB}


@pytest.mark.parametrize("layernorm", [False, True])
def test_adaptor_matches_jax(layernorm):
    jcfg, pcfg = xm_cfgs(adaptor_layernorm=layernorm)
    variables = jxm.init_xm(jax.random.PRNGKey(22), jcfg)
    model = pxm.from_jax_variables(pcfg, numpy_tree(variables)).eval()
    r = np.random.RandomState(23)
    adaptor = jax.jit(lambda p, x, n: jxm.adaptor_forward(p, jcfg, x, n))
    for t in (1, 2, 37):
        x = r.randn(t + 1, t, 16).astype(np.float32)
        lens = np.arange(t, -1, -1, dtype=np.int32)      # T, T-1, ..., 0
        ref_x, ref_len = adaptor(jnp_tree(variables["params"]["adaptor"]),
                                 jnp.asarray(x), jnp.asarray(lens))
        with torch.no_grad():
            out, out_len = model.encoder.adaptor(torch.from_numpy(x),
                                                 torch.from_numpy(lens).long())
        close(out, ref_x, msg=f"T={t}")
        assert out_len.tolist() == np.asarray(ref_len).tolist(), t


def test_xm_logits_match_jax(xm_vars):
    jcfg, pcfg = xm_cfgs("st")
    batch = xm_batch(24)
    ref = jax.jit(lambda v, b: jxm.forward(v, jcfg, b))(
        jnp_tree(xm_vars["st"]), {**jnp_tree(batch), "prev_text_tokens":
                                  batch["prev_tgt_text_tokens"]})
    model = pxm.from_jax_variables(pcfg, numpy_tree(xm_vars["st"])).eval()
    pb = port_batch(batch)
    with torch.no_grad():
        out = model(pb, pb["prev_tgt_text_tokens"])
    close(out["logits"], ref["logits"])
    close(out["encoder_out"], ref["encoder_out"])
    assert out["encoder_out_lengths"].tolist() == \
        np.asarray(ref["encoder_out_lengths"]).tolist()


@pytest.mark.parametrize("test_type", ["st", "asr"])
def test_xm_s2t_loss_matches_jax(xm_vars, test_type):
    jcfg, pcfg = xm_cfgs(test_type)
    model = pxm.from_jax_variables(pcfg, numpy_tree(xm_vars[test_type]))
    got = check_s2t_loss(jcfg, xm_vars[test_type], model, xm_batch(25),
                         test_type, "xm")
    assert not any(got[k].any() for k in got if k.startswith(
        "params::w2v::"))
    assert got["params::adaptor::conv0::w"].any()


CT_BASE = dict(src_vocab_size=VOCAB["asr"], tgt_vocab_size=VOCAB["st"],
               input_feat_per_channel=8, encoder_layers=2,
               encoder_embed_dim=16, encoder_ffn_embed_dim=32,
               encoder_attention_heads=2, decoder_ffn_embed_dim=32,
               decoder_attention_heads=2, max_source_positions=256,
               **NO_DROPOUT)
CT = dict(conv_out_channels=8, decoder_layers=2, decoder_embed_dim=16)


def ct_cfgs(test_type="st"):
    jcfg = jct.ConvTransformerConfig(
        base=jm.S2STConfig(dtype=jnp.float32, **CT_BASE), **CT)
    pcfg = pct.ConvTransformerConfig(base=port_cfg(jcfg.base),
                                     vocab_size=VOCAB[test_type], **CT)
    return jcfg, pcfg


@pytest.fixture(scope="module")
def ct_vars():
    jcfg, _ = ct_cfgs()
    return {t: jct.init_convtransformer(jax.random.PRNGKey(26), jcfg,
                                        vocab_size=v)
            for t, v in VOCAB.items()}


def test_subsampled_lengths_match_jax(ct_vars):
    jcfg, pcfg = ct_cfgs()
    model = pct.from_jax_variables(pcfg, numpy_tree(ct_vars["st"])).eval()
    r = np.random.RandomState(27)
    encode = jax.jit(lambda v, x, n: jct.encode(v, jcfg, x, n))
    for t in (5, 8, 37):     # round(T / T') = 3, 4, 4
        x = r.randn(t, t, 8).astype(np.float32)
        lens = np.arange(t, 0, -1, dtype=np.int32)       # T, T-1, ..., 1
        ref = encode(jnp_tree(ct_vars["st"]), jnp.asarray(x),
                     jnp.asarray(lens))
        with torch.no_grad():
            out = model.encoder(torch.from_numpy(x),
                                torch.from_numpy(lens).long())
        assert out["out_lengths"].tolist() == \
            np.asarray(ref["out_lengths"]).tolist(), t
        assert out["encoder_out"].shape[1] == \
            jct._conv_out_len(jct._conv_out_len(t))
        close(out["encoder_out"], ref["encoder_out"], msg=f"T={t}")


def test_convtransformer_logits_match_jax(ct_vars):
    jcfg, pcfg = ct_cfgs()
    batch = make_batch(TEXT, b=3, src_t=41, seed=28)
    ref = jax.jit(lambda v, b: jct.forward(v, jcfg, b))(
        jnp_tree(ct_vars["st"]), {**jnp_tree(batch), "prev_text_tokens":
                                  batch["prev_tgt_text_tokens"]})
    model = pct.from_jax_variables(pcfg, numpy_tree(ct_vars["st"])).eval()
    pb = port_batch(batch)
    with torch.no_grad():
        out = model(pb, pb["prev_tgt_text_tokens"])
    close(out["logits"], ref["logits"])
    assert out["encoder_out_lengths"].tolist() == \
        np.asarray(ref["encoder_out_lengths"]).tolist()


@pytest.mark.parametrize("test_type", ["st", "asr"])
def test_convtransformer_s2t_loss_matches_jax(ct_vars, test_type):
    jcfg, pcfg = ct_cfgs(test_type)
    model = pct.from_jax_variables(pcfg, numpy_tree(ct_vars[test_type]))
    check_s2t_loss(jcfg, ct_vars[test_type], model,
                   make_batch(TEXT, b=3, src_t=41, seed=29), test_type,
                   "convtransformer")


ARCH_CASES = [["--arch", a] for a in (
    "xm_transformer", "convtransformer", "convtransformer_espnet",
    "t2s_transformer", "tts_transformer")] + [
    ["--arch", "xm_transformer", "--decoder-layers", "2", "--use-hubert",
     "False"],
    ["--arch", "convtransformer_espnet", "--encoder-attention-heads", "8",
     "--attention-dropout", "0.1"],
]
ARCH_KEYS = ("encoder_embed_dim", "decoder_embed_dim", "encoder_ffn_embed_dim",
             "decoder_ffn_embed_dim", "encoder_attention_heads",
             "decoder_attention_heads", "encoder_layers", "decoder_layers",
             "dropout", "attention_dropout", "activation_dropout",
             "use_hubert", "activation_fn", "middle_layers_decoder",
             "encoder_conv_layers", "encoder_transformer_layers")


@pytest.mark.parametrize("flags", ARCH_CASES, ids="-".join)
def test_arch_defaults_match_jax(flags, tmp_path):
    from s2st_tpu.options import parse_training_args
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import apply_arch
    argv = [str(tmp_path), *flags]
    ref = parse_training_args(argv)
    got = apply_arch(train.get_parser().parse_args(argv), argv)
    for key in ARCH_KEYS:
        assert getattr(got, key) == getattr(ref, key), key


CLI_FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset", "train",
    "--criterion", "s2t_loss", "--test-type", "st", "--label-smoothing",
    "0.1", "--encoder-layers", "1", "--encoder-embed-dim", "16",
    "--encoder-ffn-embed-dim", "32", "--encoder-attention-heads", "2",
    "--decoder-layers", "1", "--decoder-embed-dim", "16",
    "--decoder-ffn-embed-dim", "32", "--decoder-attention-heads", "2",
    "--hubert-hidden", "16", "--hubert-layers", "1", "--hubert-ffn", "32",
    "--hubert-heads", "2", "--max-source-positions", "256",
    "--max-target-positions", "64", "--optimizer", "adam", "--lr", "1e-3",
    "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4",
    "--clip-norm", "1.0", "--max-update", "2", "--max-tokens", "100000",
    "--batch-size", "4", "--disable-validation", "--log-interval", "1",
    "--required-batch-size-multiple", "1", "--device", "cpu"]


@pytest.mark.parametrize("arch", ["xm_transformer", "convtransformer_espnet"])
def test_train_cli_runs_and_jax_loads_its_checkpoint(arch, tmp_path):
    import json
    from s2st_tpu.tasks.s2s_translation import S2STranslationTask
    from s2st_tpu.options import parse_training_args
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu_torch.cli import train
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus",
                              src_wav=arch == "xm_transformer")
    save = tmp_path / "ckpt"
    argv = [str(corpus), *CLI_FLAGS, "--arch", arch]
    assert train.main(argv + ["--save-dir", str(save), "--log-file",
                              str(save / "log")]) == 0
    logs = [json.loads(line) for line in
            (save / "log").read_text().splitlines()]
    assert [r["num_updates"] for r in logs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in logs)
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    task = S2STranslationTask.setup_task(parse_training_args(jargv))
    _, init_fn, _ = task.build_model_and_loss()
    template = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    loaded = jckpt.load_variables_any(str(save / "checkpoint_last.npz"),
                                      template=template)
    assert set(loaded["params"]) == ({"w2v", "adaptor", "decoder"}
                                     if arch == "xm_transformer"
                                     else {"encoder", "decoder"})
