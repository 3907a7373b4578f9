"""s2st_tpu_torch's S2T model and ``s2t_loss`` against s2st_tpu's, fp32 on
the CPU.

The tiny config of ``tests/conftest.py`` with every dropout rate at 0 as
the S2T base (2 encoder layers of 16-d), a 2-layer 16-d text decoder, one
JAX ``init_s2t`` carried into the port by its JAX bridge:

- the teacher-forced forward: logits, encoder output and lengths;
- ``s2t_loss`` for ``--test-type st`` and ``asr``: the summed loss, the
  logged values and the per-leaf gradients;
- the ``_hubert`` variant on the small frontend of
  ``tests/test_torch_hubert.py`` (patched into both packages): logits, and
  no gradient into the frontend;
- the arch table: each of the 16 S2T archs' defaults equal JAX's
  ``_two_pass`` result, and a flag given on the command line wins;
- checkpoints both ways: the port's S2T ``.npz`` loads strictly into
  JAX's ``init_s2t`` template, and JAX's into the port's model.

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; the loss (a sum over about 15 tokens) rtol 1e-5; gradients
atol 1e-6 + rtol 1e-4, as ``tests/test_torch_train.py`` holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import s2t_transformer as js2t
from s2st_tpu.train import losses as jl
from s2st_tpu_torch.models import s2t_transformer as ps2t
from s2st_tpu_torch.models.jax_bridge import (flatten_tree, jax_variables,
                                              load_jax_variables,
                                              read_jax_checkpoint,
                                              write_jax_checkpoint)
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import numpy_tree, port_cfg
from tests.conftest import make_batch
from tests.test_torch_train import (NO_DROPOUT, close, jax_leaves,
                                    port_batch, port_leaves)

DEC = dict(decoder_layers=2, decoder_embed_dim=16)


def port_s2t(jcfg, variables, vocab):
    """The port's S2T model of a JAX S2TConfig holding its variables."""
    pcfg = ps2t.S2TConfig(base=port_cfg(jcfg.base), vocab_size=vocab,
                          decoder_layers=jcfg.decoder_layers,
                          decoder_embed_dim=jcfg.decoder_embed_dim)
    model = ps2t.S2TTransformer(pcfg)
    load_jax_variables(model, numpy_tree(variables))
    return model.eval()


@pytest.fixture(scope="module")
def s2t(tiny_cfg):
    jcfg = js2t.S2TConfig(base=tiny_cfg.replace(**NO_DROPOUT), **DEC)
    vocab = {"st": tiny_cfg.tgt_vocab_size, "asr": tiny_cfg.src_vocab_size}
    variables = {k: js2t.init_s2t(jax.random.PRNGKey(3), jcfg, vocab_size=v)
                 for k, v in vocab.items()}
    return jcfg, variables, vocab


def test_forward_matches_jax(s2t):
    jcfg, variables, vocab = s2t
    batch = make_batch(jcfg.base, b=3, seed=31)
    ref = js2t.forward(variables["st"], jcfg, {
        **batch, "prev_text_tokens": batch["prev_tgt_text_tokens"]})
    model = port_s2t(jcfg, variables["st"], vocab["st"])
    pb = port_batch(batch)
    with torch.no_grad():
        out = model(pb, pb["prev_tgt_text_tokens"])
    close(out["logits"], ref["logits"])
    close(out["encoder_out"], ref["encoder_out"])
    assert out["encoder_out_lengths"].tolist() == \
        np.asarray(ref["encoder_out_lengths"]).tolist()
    assert out["logits"].shape[-1] == vocab["st"]


@pytest.mark.parametrize("test_type", ["st", "asr"])
def test_s2t_loss_and_grads_match_jax(s2t, test_type):
    jcfg, variables, vocab = s2t
    v = variables[test_type]
    batch = make_batch(jcfg.base, b=3, seed=32)
    jlcfg = jl.LossConfig(label_smoothing=0.1)

    def loss_fn(params):
        loss, ex = jl.s2t_loss({"params": params, "stats": {}}, jcfg, jlcfg,
                               jax.tree_util.tree_map(jnp.asarray, batch),
                               rng=None, train=True, test_type=test_type)
        return loss, ex["logging"]

    (j_loss, j_log), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    model = port_s2t(jcfg, v, vocab[test_type])
    p_loss, p_ex = pl.s2t_loss(model, pl.LossConfig(label_smoothing=0.1),
                               port_batch(batch), train=True,
                               test_type=test_type)
    p_loss.backward()
    close(p_loss, j_loss)
    log = p_ex["logging"]
    assert set(log) == set(j_log)
    for key in ("loss", "nll_loss"):
        close(log[key], j_log[key], msg=key)
    for key in ("n_correct", "total", "ntokens", "nsentences",
                "sample_size"):
        assert float(log[key]) == float(j_log[key]), key
    assert float(p_ex["sample_size"]) == float(batch[
        ("src" if test_type == "asr" else "tgt") + "_txt_ntokens"])
    got = port_leaves(model, grads=True)
    ref = jax_leaves(j_grads, "params")
    assert set(got) == set(ref)
    for key, g in ref.items():
        close(torch.from_numpy(got[key]), g, atol=1e-6, rtol=1e-4, msg=key)


def test_hubert_variant_matches_jax(monkeypatch):
    from s2st_tpu.models import hubert as jh
    from s2st_tpu.models import s2st_transformer as jm
    from s2st_tpu_torch.models import hubert as ph
    from tests.test_torch_hubert import (_JAX_TINY, LENGTHS, S2ST_TINY, TINY,
                                         waveforms)
    monkeypatch.setattr(jh, "HubertConfig", lambda **kw: _JAX_TINY)
    monkeypatch.setattr(ph, "frontend_config",
                        lambda cfg: ph.HubertConfig(dtype=cfg.dtype, **TINY))
    jcfg = js2t.S2TConfig(base=jm.S2STConfig(dtype=jnp.float32, **S2ST_TINY),
                          **DEC)
    variables = js2t.init_s2t(jax.random.PRNGKey(4), jcfg, vocab_size=12)
    assert "hubert" in variables["params"]
    r = np.random.RandomState(5)
    prev = r.randint(4, 12, (2, 6)).astype(np.int32)
    prev[:, 0] = 2
    prev[1, 4:] = 1
    batch = {"src_speech": waveforms(0, LENGTHS[:2]),
             "src_speech_lens": LENGTHS[:2].copy(),
             "prev_text_tokens": prev}
    ref = jax.jit(lambda v, b: js2t.forward(v, jcfg, b))(variables, batch)
    model = port_s2t(jcfg, variables, 12)
    pb = port_batch(batch)
    out = model(pb, pb["prev_text_tokens"])
    close(out["logits"], ref["logits"])
    out["logits"].float().pow(2).sum().backward()
    assert all(p.grad is None for p in model.encoder.hubert.parameters())
    assert model.encoder.subsample.conv_layers[0].weight.grad.abs().sum() > 0


ARCH_CASES = [["--arch", f"s2t_transformer{hub}{size}"]
              for hub in ("", "_hubert")
              for size in ("", "_s", "_xs", "_sp", "_m", "_mp", "_l", "_lp")
              ] + [
    ["--arch", "s2t_transformer_mp", "--dropout", "0.05"],
    ["--arch", "s2t_transformer_hubert_l", "--encoder-layers", "3"],
    ["--arch", "s2t_transformer_hubert", "--use-hubert", "False"],
]
ARCH_KEYS = ("encoder_embed_dim", "decoder_embed_dim", "encoder_ffn_embed_dim",
             "decoder_ffn_embed_dim", "encoder_attention_heads",
             "decoder_attention_heads", "encoder_layers", "decoder_layers",
             "dropout", "use_hubert", "test_type")


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


def test_checkpoints_cross_both_ways(s2t, tmp_path):
    """The port's S2T file loads strictly into JAX's init_s2t template, and
    a JAX S2T tree builds the port's model (strict), leaf for leaf."""
    from s2st_tpu.train import checkpoint as jckpt
    jcfg, variables, vocab = s2t
    pcfg = ps2t.S2TConfig(base=port_cfg(jcfg.base), vocab_size=vocab["st"],
                          **DEC)
    model = ps2t.S2TTransformer(pcfg).init_weights(7)
    path = tmp_path / "s2t.npz"
    write_jax_checkpoint(str(path), model, {"args": {}})
    template = jax.eval_shape(lambda k: js2t.init_s2t(
        k, jcfg, vocab_size=vocab["st"]), jax.random.PRNGKey(0))
    loaded = jckpt.load_variables_any(str(path), template=template)
    ours = flatten_tree(jax_variables(model)["params"])
    theirs = flatten_tree(numpy_tree(loaded["params"]))
    assert set(ours) == set(theirs)
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours)
    tree, _ = read_jax_checkpoint(str(path))
    back = ps2t.from_jax_variables(pcfg, numpy_tree(variables["st"]))
    want = jax_leaves(variables["st"]["params"], "params")
    got = port_leaves(back)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert set(tree["params"]) == {"encoder", "decoder"}
