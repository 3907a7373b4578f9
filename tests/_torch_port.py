"""Shared helpers of the tests that hold s2st_tpu_torch against s2st_tpu:
the same tiny config on both sides and the same weights, carried across by
the port's JAX bridge. Every comparison runs fp32 on the CPU."""

import atexit
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from s2st_tpu_torch.models.jax_bridge import load_jax_variables
from s2st_tpu_torch.models.s2st_transformer import S2STConfig, S2STTransformer

# The JAX package's CLIs, which these tests and the package's own call, put
# JAX's persistent compilation cache under ~/.cache/s2st_tpu, where it
# outlives the test run. Every process that imports this module (each pytest
# worker collects it) gets a cache of its own, removed at exit, so no test
# loads an executable that an earlier run compiled: the insertion
# transformer's 8-device CPU train step, loaded from that cache, stalls in
# XLA's collective rendezvous and aborts the process
# (tests/test_insertion.py::test_insertion_e2e).
JAX_CACHE_DIR = tempfile.mkdtemp(prefix="s2st_xla_cache_")
atexit.register(shutil.rmtree, JAX_CACHE_DIR, ignore_errors=True)
os.environ["S2ST_TPU_COMPILATION_CACHE_DIR"] = JAX_CACHE_DIR


def port_cfg(jax_cfg, **overrides) -> S2STConfig:
    """The port's config with every field the JAX config shares, fp32."""
    names = {f.name for f in dataclasses.fields(S2STConfig)} - {"dtype"}
    vals = {n: getattr(jax_cfg, n) for n in names if hasattr(jax_cfg, n)}
    return S2STConfig(dtype=torch.float32, **vals).replace(**overrides)


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_model(jax_cfg, variables, **overrides) -> S2STTransformer:
    """Port model on the CPU holding the JAX variables (strict load)."""
    model = S2STTransformer(port_cfg(jax_cfg, **overrides))
    load_jax_variables(model, numpy_tree(variables))
    return model.eval()


def t(x, dtype=None):
    """numpy -> torch (CPU)."""
    out = torch.from_numpy(np.array(x, order="C"))
    return out if dtype is None else out.to(dtype)


# The small LightConv of tests/test_lightconv_model.py: 2 + 2 layers, kernels
# (3, 5), vocabulary 30.
LIGHTCONV_SMALL = dict(vocab=30, dim=16, ffn=32, heads=2, kernels=(3, 5))


def lightconv_cfgs(conv_type="lightweight", glu=True, normalize_before=False,
                   tied=False, small=LIGHTCONV_SMALL):
    """(JAX LightConvConfig, port LightConvConfig) with the same fields,
    fp32, dropout off."""
    import jax.numpy as jnp
    from s2st_tpu.models import lightconv_model as jlc
    from s2st_tpu.models import transformer_text as jtt
    from s2st_tpu_torch.models import lightconv_model as plc
    from s2st_tpu_torch.models.transformer_text import TransformerTextConfig
    s = small
    base = dict(src_vocab_size=s["vocab"], tgt_vocab_size=s["vocab"],
                encoder_layers=len(s["kernels"]),
                encoder_embed_dim=s["dim"], encoder_ffn_embed_dim=s["ffn"],
                encoder_attention_heads=s["heads"],
                encoder_normalize_before=normalize_before,
                decoder_layers=len(s["kernels"]),
                decoder_embed_dim=s["dim"], decoder_ffn_embed_dim=s["ffn"],
                decoder_attention_heads=s["heads"],
                decoder_normalize_before=normalize_before,
                dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                share_decoder_input_output_embed=tied,
                max_source_positions=256, max_target_positions=256)
    rest = dict(conv_type=conv_type, encoder_kernel_sizes=s["kernels"],
                decoder_kernel_sizes=s["kernels"], encoder_conv_dim=s["dim"],
                decoder_conv_dim=s["dim"], encoder_glu=glu, decoder_glu=glu,
                weight_dropout=0.0, input_dropout=0.0, relu_dropout=0.0)
    jcfg = jlc.LightConvConfig(
        base=jtt.TransformerTextConfig(dtype=jnp.float32, **base), **rest)
    pcfg = plc.LightConvConfig(
        base=TransformerTextConfig(dtype=torch.float32, **base), **rest)
    return jcfg, pcfg


def lightconv_port_model(pcfg, variables):
    """Port LightConv on the CPU holding the JAX variables (strict load)."""
    from s2st_tpu_torch.models.lightconv_model import LightConvModel
    model = LightConvModel(pcfg)
    load_jax_variables(model, numpy_tree(variables))
    return model.eval()
