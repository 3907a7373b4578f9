"""s2st_tpu_torch layers against s2st_tpu's, fp32 on the CPU.

The same inputs (numpy, seeded) and the same weights (the port's JAX
bridge) go through both sides. Tolerance: atol 1e-5, rtol 1e-5 unless a
test says otherwise; fp32 on both sides, only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.nn import core as jcore
from s2st_tpu.nn import tacotron as jtaco
from s2st_tpu.nn import transformer as jtr
from s2st_tpu.nn.attention import cross_attn_precompute as j_cross_kv
from s2st_tpu.nn.attention import self_attn_cache_init as j_cache_init
from s2st_tpu_torch.nn import core as pcore
from s2st_tpu_torch.nn import transformer as ptr
from s2st_tpu_torch.nn.attention import (cross_attn_precompute,
                                         self_attn_cache_init)
from tests._torch_port import port_model, t

ATOL, RTOL = 1e-5, 1e-5


def close(port, ref, atol=ATOL, rtol=RTOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def pair(tiny_cfg, tiny_variables):
    """(JAX cfg, JAX variables, port model with the same weights)."""
    return tiny_cfg, tiny_variables, port_model(tiny_cfg, tiny_variables)


@pytest.mark.parametrize("n,dim", [(40, 16), (12, 7), (9, 2)])
def test_sinusoidal_table(n, dim):
    close(ptr.sinusoidal_table(n, dim, 1), jtr.sinusoidal_table(n, dim, 1),
          atol=1e-6)


def test_positions_for_lengths_and_step():
    table = jtr.sinusoidal_table(40, 16, 1)
    lens = np.array([7, 3, 0])
    close(ptr.positions_for_lengths(t(np.asarray(table)), t(lens), 9, 1),
          jtr.positions_for_lengths(table, jnp.asarray(lens), 9, 1))
    for step in (0, 5):
        close(ptr.position_at_step(t(np.asarray(table)), step, 1),
              jtr.position_at_step(table, jnp.asarray(step), 1))


def test_core_functions():
    r = np.random.RandomState(0)
    x = r.randn(2, 11, 6).astype(np.float32) * 3 + 1
    scale, bias = r.randn(6).astype(np.float32), r.randn(6).astype(np.float32)
    close(pcore.layer_norm(t(x), t(scale), t(bias)),
          jcore.layer_norm({"scale": scale, "bias": bias}, jnp.asarray(x)))
    mean, var = r.randn(6).astype(np.float32), r.rand(6).astype(np.float32)
    y, _ = jcore.batch_norm({"scale": scale, "bias": bias},
                            {"mean": mean, "var": var}, jnp.asarray(x),
                            train=False)
    close(pcore.batch_norm_eval(t(x), t(mean), t(var), t(scale), t(bias)), y)
    w = r.randn(5, 6, 4).astype(np.float32)            # JAX (K, Cin, Cout)
    b = r.randn(4).astype(np.float32)
    for stride, pad in ((1, 2), (2, 2)):
        close(pcore.conv1d(t(x), t(np.transpose(w, (2, 1, 0)).copy()), t(b),
                           stride, pad),
              jcore.conv1d({"w": w, "b": b}, jnp.asarray(x), stride, pad))
    close(pcore.glu(t(x)), jcore.glu(jnp.asarray(x)))
    for name in ("relu", "gelu", "gelu_fast", "tanh", "swish", "linear"):
        close(pcore.get_activation(name)(t(x)),
              jcore.get_activation(name)(jnp.asarray(x)))
    lens = np.array([11, 4, 0])
    assert np.array_equal(
        pcore.lengths_to_padding_mask(t(lens), 11).numpy(),
        np.asarray(jcore.lengths_to_padding_mask(jnp.asarray(lens), 11)))


def test_dropout_threshold_mask():
    """The JAX 8-bit threshold mask: keep probability quantised to 1/256,
    kept values rescaled by it. JAX and torch draw different bits, so the
    check is on the mask's statistics and values."""
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = pcore.dropout(x, 0.3, g)
    keep = (256 - round(0.3 * 256)) / 256
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / keep))
    assert abs(kept.float().mean().item() - keep) < 0.01
    assert pcore.dropout(x, 0.3, None) is x


def test_resolve_device():
    assert pcore.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pcore.resolve_device()


@pytest.mark.parametrize("normalize_before,activation",
                         [(True, "relu"), (False, "gelu")])
def test_encoder_layer(pair, normalize_before, activation):
    cfg, v, model = pair
    layer = model.encoder.transformer_layers[1]
    layer.normalize_before, layer.activation = normalize_before, activation
    r = np.random.RandomState(1)
    x = r.randn(2, 9, cfg.encoder_embed_dim).astype(np.float32)
    pad = np.arange(9)[None, :] >= np.array([[9], [5]])
    ref = jtr.encoder_layer(v["params"]["encoder"]["layer1"], jnp.asarray(x),
                            jnp.asarray(pad), cfg.encoder_attention_heads,
                            normalize_before=normalize_before,
                            activation=activation)
    with torch.no_grad():
        close(layer(t(x), t(pad)), ref)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_decoder_layer(pair, normalize_before):
    cfg, v, model = pair
    layer = model.decoder.transformer_layers[0]
    layer.normalize_before = normalize_before
    r = np.random.RandomState(2)
    x = r.randn(2, 6, cfg.decoder_embed_dim).astype(np.float32)
    enc = r.randn(2, 8, cfg.encoder_embed_dim).astype(np.float32)
    enc_pad = np.arange(8)[None, :] >= np.array([[8], [3]])
    self_pad = np.arange(6)[None, :] >= np.array([[6], [4]])
    ref, ref_w = jtr.decoder_layer(
        v["params"]["decoder"]["layer0"], jnp.asarray(x), jnp.asarray(enc),
        jnp.asarray(enc_pad), jtr.causal_mask(6), jnp.asarray(self_pad),
        cfg.decoder_attention_heads, normalize_before=normalize_before,
        need_attn=True)
    with torch.no_grad():
        out, w = layer(t(x), t(enc), t(enc_pad), t(self_pad), need_attn=True)
    close(out, ref)
    close(w, ref_w)


@pytest.mark.parametrize("normalize_before", [True, False])
def test_decoder_step_fused(pair, normalize_before):
    """Four steps with caches and precomputed cross K/V; outputs, the
    cache contents and the cross-attention weights agree."""
    cfg, v, model = pair
    layer = model.decoder.transformer_layers[1]
    jp = v["params"]["decoder"]["layer1"]
    heads, dim = cfg.decoder_attention_heads, cfg.decoder_embed_dim
    r = np.random.RandomState(3)
    enc = r.randn(2, 8, cfg.encoder_embed_dim).astype(np.float32)
    enc_pad = np.arange(8)[None, :] >= np.array([[8], [5]])
    j_lp = jtr.fuse_decoder_layer_params(jp)
    j_cache = j_cache_init(2, 6, heads, dim // heads, jnp.float32)
    j_kv = j_cross_kv(jp["cross_attn"], jnp.asarray(enc), heads)
    with torch.no_grad():
        p_lp = ptr.fuse_decoder_layer_params(layer)
        p_cache = self_attn_cache_init(2, 6, heads, dim // heads,
                                       torch.float32, "cpu")
        p_kv = cross_attn_precompute(layer.encoder_attn, t(enc))
        for step in range(4):
            x = r.randn(2, 1, dim).astype(np.float32)
            jx, j_cache, jw = jtr.decoder_layer_step_fused(
                j_lp, jnp.asarray(x), j_cache, jnp.asarray(step), j_kv,
                jnp.asarray(enc_pad), heads,
                normalize_before=normalize_before, need_attn=True)
            px, p_cache, pw = ptr.decoder_layer_step_fused(
                p_lp, t(x), p_cache, step, p_kv, t(enc_pad), heads,
                normalize_before=normalize_before, need_attn=True)
            close(px, jx)
            close(pw, jw)
            close(p_cache["k"], j_cache["k"])
            close(p_cache["v"], j_cache["v"])


def test_prenet_and_postnet(pair):
    cfg, v, model = pair
    dec = v["params"]["decoder"]
    r = np.random.RandomState(4)
    x = r.randn(2, 7, cfg.out_dim).astype(np.float32)
    ref = jtaco.prenet(dec["prenet"], jnp.asarray(x), cfg.prenet_dropout,
                       rng=None, always_dropout=False)
    with torch.no_grad():
        close(model.decoder.prenet[0](t(x), cfg.prenet_dropout, None), ref)
        stats = {k: {"mean": jnp.asarray(r.randn(s["mean"].shape[0]),
                                         jnp.float32),
                     "var": jnp.asarray(r.rand(s["var"].shape[0]) + 0.5,
                                        jnp.float32),
                     "count": s["count"]}
                 for k, s in v["stats"]["postnet"].items()}
        for i, blk in enumerate(model.decoder.postnet.convolutions):
            blk[1].running_mean.copy_(t(np.asarray(stats[f"bn{i}"]["mean"])))
            blk[1].running_var.copy_(t(np.asarray(stats[f"bn{i}"]["var"])))
        ref, _ = jtaco.postnet(dec["postnet"], stats, jnp.asarray(x),
                               kernel_size=cfg.postnet_conv_kernel_size,
                               dropout_rate=0.0, train=False)
        close(model.decoder.postnet(t(x)), ref)
