"""s2st_tpu_torch's LightConv / DynamicConv model against
s2st_tpu/models/lightconv_model.py, fp32 on the CPU.

- The JAX bridge carries the LightConv tree both ways, strictly: every JAX
  leaf has a place in the port model and back, a missing or extra leaf or a
  wrong shape raises, and a checkpoint the port writes restores in JAX's
  ``load_text_model_ensemble``.
- ``forward`` logits against ``lc.forward`` for both conv types, GLU on and
  off, and pre-norm with a tied output projection.
- The incremental step against JAX's ``make_beam_step`` step by step (its
  log-probs and its conv-input cache), and against the port's own
  teacher-forced decode at every real position (the JAX test's check,
  tests/test_lightconv_model.py:173-194).

The JAX side runs its Pallas conv kernels in interpret mode. Tolerance: atol
1e-5, rtol 1e-5 (fp32 on both sides, sums in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import lightconv_model as jlc
from s2st_tpu_torch.models.jax_bridge import (flatten_tree, jax_variables,
                                              load_jax_variables,
                                              write_jax_checkpoint)
from s2st_tpu_torch.models.lightconv_model import LightConvModel
from tests._torch_port import (LIGHTCONV_SMALL, lightconv_cfgs,
                               lightconv_port_model, numpy_tree)

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = LIGHTCONV_SMALL["vocab"]


def batch(seed, b=3, ts=9, tt=7):
    """Left-padded sources and right-padded prev_output_tokens (EOS first)
    of varied lengths, as the collate makes them."""
    r = np.random.RandomState(seed)
    src = np.full((b, ts), 1, np.int64)
    prev = np.full((b, tt), 1, np.int64)
    for i in range(b):
        sl = r.randint(3, ts + 1) if i else ts
        src[i, ts - sl:] = np.concatenate([r.randint(4, VOCAB, sl - 1), [2]])
        tl = r.randint(2, tt + 1) if i else tt
        prev[i, 0] = 2
        prev[i, 1:tl] = r.randint(4, VOCAB, tl - 1)
    return src, prev


def jax_model(seed=0, **kw):
    jcfg, pcfg = lightconv_cfgs(**kw)
    variables = jlc.init_lightconv(jax.random.PRNGKey(seed), jcfg)
    return jcfg, pcfg, variables


VARIANTS = {
    "lightweight_glu": dict(conv_type="lightweight", glu=True),
    "lightweight_noglu": dict(conv_type="lightweight", glu=False),
    "dynamic_glu": dict(conv_type="dynamic", glu=True),
    "dynamic_noglu": dict(conv_type="dynamic", glu=False),
    "dynamic_prenorm_tied": dict(conv_type="dynamic", glu=True,
                                 normalize_before=True, tied=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bridge_round_trip_is_strict(variant):
    _, pcfg, variables = jax_model(**VARIANTS[variant])
    tree = numpy_tree(variables)
    model = lightconv_port_model(pcfg, tree)
    back = flatten_tree(jax_variables(model))
    want = flatten_tree({"params": tree["params"]})
    assert set(back) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)
    extra = numpy_tree(variables)
    extra["params"]["decoder"]["layer0"]["unused"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no place"):
        load_jax_variables(LightConvModel(pcfg), extra)
    missing = numpy_tree(variables)
    del missing["params"]["encoder"]["layer1"]["linear2"]
    with pytest.raises(KeyError, match="lack"):
        load_jax_variables(LightConvModel(pcfg), missing)
    wrong = numpy_tree(variables)
    leaf = "conv_weight" if "conv_weight" in wrong["params"]["encoder"][
        "layer0"] else "weight_linear"
    node = wrong["params"]["encoder"]["layer0"]
    node[leaf] = np.zeros((7, 7), np.float32) if leaf == "conv_weight" \
        else {"w": np.zeros((7, 7), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(LightConvModel(pcfg), wrong)


@pytest.mark.parametrize("conv_type", ["lightweight", "dynamic"])
def test_port_checkpoint_restores_in_jax(conv_type, tmp_path):
    from s2st_tpu.cli.generate import load_text_model_ensemble
    jcfg, pcfg = lightconv_cfgs(conv_type=conv_type)
    model = LightConvModel(pcfg).init_weights(seed=3)
    path = str(tmp_path / "ckpt.npz")
    write_jax_checkpoint(path, model, meta={"args": {"arch": "lightconv"}})
    (restored,) = load_text_model_ensemble(
        [path], jcfg, functools.partial(jlc.init_lightconv, cfg=jcfg))
    got = flatten_tree(numpy_tree({"params": restored["params"]}))
    want = flatten_tree(jax_variables(model))
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    jcfg, pcfg, variables = jax_model(seed=1, **VARIANTS[variant])
    model = lightconv_port_model(pcfg, variables)
    src, prev = batch(seed=2)
    want = jlc.forward(variables, jcfg,
                       {"src_tokens": jnp.asarray(src, jnp.int32),
                        "prev_output_tokens": jnp.asarray(prev, jnp.int32)},
                       deterministic=True)["logits"]
    enc_want = jlc.encode(variables, jcfg, jnp.asarray(src, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(prev))
        enc = model.encode(torch.from_numpy(src))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(enc["encoder_out"].numpy(),
                               np.asarray(enc_want["encoder_out"]), **TOL)
    np.testing.assert_array_equal(
        enc["encoder_padding_mask"].numpy(),
        np.asarray(enc_want["encoder_padding_mask"]))


@pytest.mark.parametrize("variant", ["lightweight_glu", "dynamic_noglu",
                                     "dynamic_prenorm_tied"])
def test_incremental_step_matches_jax_and_teacher_forcing(variant):
    jcfg, pcfg, variables = jax_model(seed=4, **VARIANTS[variant])
    model = lightconv_port_model(pcfg, variables)
    src, prev = batch(seed=5, b=2, ts=7, tt=6)
    enc = jlc.encode(variables, jcfg, jnp.asarray(src, jnp.int32))
    jstep = jlc.make_beam_step(variables, jcfg, enc["encoder_out"],
                               enc["encoder_padding_mask"])
    jcache = jlc.init_beam_cache(jcfg, 2)
    with torch.no_grad():
        penc = model.encode(torch.from_numpy(src))
        tf = torch.log_softmax(model.decode(
            torch.from_numpy(prev), penc["encoder_out"],
            penc["encoder_padding_mask"]), dim=-1).numpy()
        pstep = model.make_beam_step(penc["encoder_out"],
                                     penc["encoder_padding_mask"])
        pcache = model.init_beam_cache(2)
        for t in range(prev.shape[1]):
            tok = prev[:, t:t + 1]
            jlp, jcache = jstep(jnp.asarray(tok, jnp.int32), jnp.asarray(t),
                                jcache)
            plp, pcache = pstep(torch.from_numpy(tok), t, pcache)
            np.testing.assert_allclose(plp.numpy(), np.asarray(jlp),
                                       err_msg=f"t={t}", **TOL)
            for name, buf in pcache.items():
                np.testing.assert_allclose(buf.numpy(),
                                           np.asarray(jcache[name]),
                                           err_msg=f"{name} t={t}", **TOL)
            for row in range(2):
                if prev[row, t] != 1:
                    np.testing.assert_allclose(plp[row].numpy(), tf[row, t],
                                               err_msg=f"b={row} t={t}",
                                               **TOL)
