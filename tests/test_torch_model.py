"""s2st_tpu_torch model and weight bridge against s2st_tpu, fp32 on the CPU.

- A JAX ``init_s2st`` tree loads strictly into the port model, and every
  port ``state_dict`` entry is the JAX leaf in fairseq layout
  (``to_fairseq_state_dict``).
- A ``.npz`` checkpoint written by the JAX trainer loads into the port;
  one the port writes loads back into JAX.
- ``subsample``, ``encode`` and teacher-forced ``decode`` agree with JAX.

Tolerance: atol 1e-5, rtol 1e-5 (fp32 both sides; summation order only).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.models.torch_import import to_fairseq_state_dict
from s2st_tpu.train import checkpoint as jckpt
from s2st_tpu_torch.models import config_from_args as pconf
from s2st_tpu_torch.models.jax_bridge import (jax_layout, load_jax_variables,
                                              read_jax_checkpoint,
                                              write_jax_checkpoint)
from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
from tests._torch_port import numpy_tree, port_cfg, port_model, t
from tests.conftest import make_batch

ATOL, RTOL = 1e-5, 1e-5

# the flags a JAX training run echoes into its checkpoint for tiny_cfg
TINY_ARGS = {
    "arch": "s2st_transformer", "conv_kernel_sizes": "5,5",
    "conv_channels": 16, "encoder_layers": 2, "encoder_embed_dim": 16,
    "encoder_ffn_embed_dim": 32, "encoder_attention_heads": 2,
    "middle_layers": "0,1", "decoder_layers": 2, "decoder_embed_dim": 16,
    "decoder_ffn_embed_dim": 32, "decoder_attention_heads": 2,
    "output_frame_dim": 8, "n_frames_per_step": 1, "prenet_layers": 2,
    "prenet_dim": 8, "postnet_layers": 2, "postnet_conv_dim": 8,
    "postnet_conv_kernel_size": 5, "ctc_weight": 0.3, "asr_ce_weight": 0.3,
    "st_ce_weight": 0.3, "asr_decoder_layers": 1, "asr_decoder_embed_dim": 16,
    "st_decoder_layers": 1, "st_decoder_embed_dim": 16,
    "max_source_positions": 256, "max_target_positions": 256, "fp16": False,
}


def model_flags(argv=()):
    parser = argparse.ArgumentParser()
    pconf.add_model_args(parser)
    return parser.parse_args(list(argv))


def close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def model(tiny_cfg, tiny_variables):
    return port_model(tiny_cfg, tiny_variables)


def test_bridge_matches_fairseq_export(model, tiny_variables):
    """Every port state_dict entry equals the JAX export in fairseq naming
    and layout, and the two name sets are the same."""
    ref = to_fairseq_state_dict(tiny_variables)
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for name, val in sd.items():
        assert np.array_equal(val.numpy(), np.asarray(ref[name])), name
    assert len(jax_layout(model)) == len(sd)


def test_bridge_rejects_foreign_and_missing_leaves(tiny_cfg, tiny_variables):
    v = numpy_tree(tiny_variables)
    v["params"]["decoder"]["extra"] = {"w": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="no place"):
        load_jax_variables(S2STTransformer(port_cfg(tiny_cfg)), v)
    v = numpy_tree(tiny_variables)
    del v["params"]["encoder"]["layer1"]["fc1"]["b"]
    with pytest.raises(KeyError, match="lack"):
        load_jax_variables(S2STTransformer(port_cfg(tiny_cfg)), v)


def test_jax_checkpoint_loads_into_port(tiny_cfg, tiny_variables, tmp_path):
    from s2st_tpu.train.optim import adam
    from s2st_tpu.train.trainer import create_train_state
    state = create_train_state(tiny_variables, adam())
    path = str(tmp_path / "checkpoint_last.npz")
    jckpt.save_checkpoint_file(path, state, {"args": TINY_ARGS})
    tree, meta = read_jax_checkpoint(path)
    assert meta["args"] == TINY_ARGS and meta["step"] == 0
    args = pconf.model_args_from_checkpoint(model_flags(), meta)
    cfg = pconf.build_model_config(args, tree, tiny_cfg.input_feat_per_channel)
    assert cfg == port_cfg(tiny_cfg)
    m = load_jax_variables(S2STTransformer(cfg), tree)
    ref = to_fairseq_state_dict(tiny_variables)
    for name, val in m.state_dict().items():
        assert np.array_equal(val.numpy(), np.asarray(ref[name])), name


def test_port_checkpoint_loads_into_jax(tiny_cfg, tiny_variables, tmp_path):
    m = S2STTransformer(port_cfg(tiny_cfg)).init_weights(seed=5)
    path = str(tmp_path / "port.npz")
    write_jax_checkpoint(path, m, {"args": TINY_ARGS})
    back = jckpt.load_variables_any(path, template=tiny_variables)
    ref = m.state_dict()
    for name, val in to_fairseq_state_dict(back).items():
        assert np.array_equal(np.asarray(val), ref[name].numpy()), name
    # and the same seed gives the same weights
    again = S2STTransformer(port_cfg(tiny_cfg)).init_weights(seed=5)
    for name, val in again.state_dict().items():
        assert torch.equal(val, ref[name]), name


def test_bf16_leaves_are_widened(tmp_path):
    import ml_dtypes
    x = np.array([1.5, -2.25, 3e-3], np.float32)
    path = str(tmp_path / "bf16.npz")
    np.savez(path, **{"params::a::w": x.astype(ml_dtypes.bfloat16)})
    tree, meta = read_jax_checkpoint(path)
    assert meta == {}
    np.testing.assert_array_equal(
        tree["params"]["a"]["w"],
        x.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_config_falls_back_to_command_line(tiny_cfg, tiny_variables):
    """Without a flag echo the command line's model flags decide, and the
    vocabulary sizes come from the array shapes."""
    flags = []
    for k, v in TINY_ARGS.items():
        if isinstance(v, bool):
            flags += [f"--{k.replace('_', '-')}"] if v else []
        else:
            flags += [f"--{k.replace('_', '-')}", str(v)]
    args = pconf.model_args_from_checkpoint(model_flags(flags), {})
    cfg = pconf.build_model_config(args, numpy_tree(tiny_variables),
                                   tiny_cfg.input_feat_per_channel)
    assert cfg == port_cfg(tiny_cfg)
    assert (cfg.src_vocab_size, cfg.tgt_vocab_size) == (30, 32)


@pytest.mark.parametrize("pad_extra", [0, 9])
def test_subsample(model, tiny_cfg, tiny_variables, pad_extra):
    """Frames past each length are zeroed after every conv, so extra
    padding changes nothing."""
    b = make_batch(tiny_cfg, b=3, seed=2)
    x = np.pad(b["src_speech"], ((0, 0), (0, pad_extra), (0, 0)))
    jx, jl = jm.subsample(tiny_variables["params"]["encoder"]["subsample"],
                          tiny_cfg, jnp.asarray(x),
                          jnp.asarray(b["src_speech_lens"]))
    with torch.no_grad():
        px, pl = model.encoder.subsample(t(x), t(b["src_speech_lens"]).long())
    assert np.array_equal(pl.numpy(), np.asarray(jl))
    close(px, jx)


def test_encode(model, tiny_cfg, tiny_variables):
    b = make_batch(tiny_cfg, b=3, seed=3)
    j = jm.encode(tiny_variables, tiny_cfg, jnp.asarray(b["src_speech"]),
                  jnp.asarray(b["src_speech_lens"]))
    with torch.no_grad():
        p = model.encode(t(b["src_speech"]), t(b["src_speech_lens"]).long())
    close(p["encoder_out"], j["encoder_out"])
    assert np.array_equal(p["encoder_padding_mask"].numpy(),
                          np.asarray(j["encoder_padding_mask"]))
    assert len(p["out_middle_layers"]) == len(j["out_middle_layers"]) == 2
    for a, r in zip(p["out_middle_layers"], j["out_middle_layers"]):
        close(a, r)


def test_decode_teacher_forced(model, tiny_cfg, tiny_variables):
    b = make_batch(tiny_cfg, b=3, seed=4)
    j_enc = jm.encode(tiny_variables, tiny_cfg, jnp.asarray(b["src_speech"]),
                      jnp.asarray(b["src_speech_lens"]))
    j = jm.decode(tiny_variables, tiny_cfg,
                  jnp.asarray(b["prev_output_tokens"]),
                  jnp.asarray(b["target_lengths"]), j_enc)
    with torch.no_grad():
        p_enc = model.encode(t(b["src_speech"]),
                             t(b["src_speech_lens"]).long())
        p = model.decode(t(b["prev_output_tokens"]),
                         t(b["target_lengths"]).long(), p_enc)
    for key in ("feat_out", "post_feat_out", "eos_out", "attn"):
        close(p[key], j[key])


def test_recipe_width_tree_loads(tiny_cfg):
    """At the recipe's width (12 + 6 layers, 512-d, taps 4 and 9, 1-layer
    64-d aux decoders) the port's tree has exactly the JAX tree's leaves."""
    cfg = jm.S2STConfig(middle_layers=(4, 9), n_frames_per_step=4,
                        prenet_dim=32, aux_asr=True, aux_st=True,
                        asr_decoder_layers=1, st_decoder_layers=1,
                        asr_decoder_embed_dim=64, st_decoder_embed_dim=64,
                        dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init_s2st(k, cfg),
                            jax.random.PRNGKey(0))
    m = S2STTransformer(port_cfg(cfg))
    sd = m.state_dict()
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        else:
            flat["::".join(path)] = tuple(node.shape)
    walk({"params": shapes["params"], "stats": shapes["stats"]}, [])
    table = jax_layout(m)
    assert sorted(key for _, key, _ in table) == sorted(flat)
    for name, key, kind in table:
        shape = tuple(sd[name].shape)
        if kind == "linear":
            shape = shape[::-1]
        elif kind == "conv":
            shape = (shape[2], shape[1], shape[0])
        assert shape == flat[key], (name, key)
