"""The port's bf16 scale factors against JAX's, bit for bit, on the CPU.

JAX multiplies bf16 activations by scales rounded to bf16: the encoder's
embedding scale is ``x * jnp.asarray(sqrt(512), x.dtype)``
(s2st_tpu/models/s2st_transformer.py:338-339), and the attention's q scale
is a weakly typed ``head_dim ** -0.5``, which takes q's dtype
(s2st_tpu/nn/attention.py:133-134). PyTorch would apply a Python float in
fp32 (sqrt(512) = 22.627 where JAX's bf16 constant is 22.625; 128 ** -0.5
0.0883883 against 0.0883789), so a few percent of the bf16 products would
round the other way. The port multiplies through ``nn.core.scaled``.

Each test runs one site of each package on the same bf16 input, made with
numpy from a seed, at the recipe's 512-d and 4 heads, and reads the scaled
tensor where the next step of each package receives it. Both sides run
eagerly, one op at a time (no XLA fusion), so the products must agree bit
for bit; each test also shows that the fp32-applied scale would not.
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.nn import attention as jattn
from s2st_tpu_torch.models import s2st_transformer as pm
from s2st_tpu_torch.nn import attention as pattn

DIM, HEADS = 512, 4


class _Captured(Exception):
    """Stops a forward once the tensor under test has been read."""


def _bf16_input(shape, seed):
    """A bf16 array (numpy, ml_dtypes) and the same values as a torch
    bf16 tensor."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    xb = x.astype(ml_dtypes.bfloat16)
    return xb, torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16)


def _as_f32(x):
    return np.asarray(x).astype(np.float32)


def _assert_bits(got: torch.Tensor, want, unrounded: torch.Tensor):
    """got equals want bit for bit; the same product with the scale
    applied in fp32 does not (so this input does show the rounding)."""
    assert got.dtype == torch.bfloat16
    want = _as_f32(want)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not np.array_equal(unrounded.float().numpy(), want)


def test_encoder_embedding_scale_matches_jax(monkeypatch):
    """The encoder's sqrt(512) on the subsampler's bf16 output, read at the
    dropout that follows (positions zeroed in both packages)."""
    b, t = 2, 40
    xb, xt = _bf16_input((b, t, DIM), seed=11)
    lengths = np.array([t, 31], np.int32)
    captured = {}

    def capture(x, *args, **kwargs):
        captured["x"] = x
        raise _Captured

    # JAX: encode() from its subsampler's output to its first dropout
    monkeypatch.setattr(jm, "subsample",
                        lambda p, cfg, x, lens: (jnp.asarray(xb), lens))
    monkeypatch.setattr(jm, "positions_for_lengths",
                        lambda table, lens, t_out, pad, dtype:
                        jnp.zeros((b, t_out, DIM), dtype))
    monkeypatch.setattr(jm, "dropout", capture)
    jcfg = jm.S2STConfig(encoder_embed_dim=DIM, encoder_layers=1,
                         encoder_attention_heads=HEADS, dtype=jnp.bfloat16)
    with pytest.raises(_Captured):
        jm.encode({"params": {"encoder": {"subsample": None}}}, jcfg,
                  jnp.zeros((b, 4 * t, 80), jnp.bfloat16),
                  jnp.asarray(lengths))
    want = captured.pop("x")

    # the port: S2STEncoder.forward from the same point
    class Subsample(torch.nn.Module):
        def forward(self, feats, lens):
            return xt, lens

    pcfg = pm.S2STConfig(encoder_embed_dim=DIM, encoder_layers=1,
                         encoder_attention_heads=HEADS,
                         encoder_ffn_embed_dim=64, conv_channels=8,
                         dtype=torch.bfloat16)
    encoder = pm.S2STEncoder(pcfg)
    encoder.subsample = Subsample()
    monkeypatch.setattr(pm, "positions_for_lengths",
                        lambda table, lens, t_out, pad, dtype:
                        torch.zeros((b, t_out, DIM), dtype=dtype))
    monkeypatch.setattr(pm, "dropout", capture)
    with pytest.raises(_Captured):
        encoder(torch.zeros((b, 4 * t, 80)), torch.from_numpy(lengths))
    _assert_bits(captured["x"], want, xt * math.sqrt(DIM))


def test_attention_q_scale_matches_jax(monkeypatch):
    """The attention's 128 ** -0.5 on q, with identity q/k/v projections
    and zero biases (exact in bf16), read where each package's mha hands q
    to its attention."""
    b, t = 2, 24
    xb, xt = _bf16_input((b, t, DIM), seed=12)
    captured = {}

    def capture(q, *args, **kwargs):
        captured["q"] = q
        raise _Captured

    eye, zero = np.eye(DIM, dtype=np.float32), np.zeros(DIM, np.float32)
    proj = {"w": jnp.asarray(eye), "b": jnp.asarray(zero)}
    monkeypatch.setattr(jattn, "attend", capture)
    with pytest.raises(_Captured):
        jattn.mha({"q": proj, "k": proj, "v": proj, "out": proj},
                  jnp.asarray(xb), jnp.asarray(xb), jnp.asarray(xb),
                  num_heads=HEADS)
    want = captured.pop("q")

    mha = pattn.MultiheadAttention(DIM, HEADS)
    with torch.no_grad():
        for lin in (mha.q_proj, mha.k_proj, mha.v_proj, mha.out_proj):
            lin.weight.copy_(torch.from_numpy(eye))
            lin.bias.zero_()
    monkeypatch.setattr(pattn, "flash_attention", capture)
    with pytest.raises(_Captured), torch.no_grad():
        mha(xt, xt, xt)
    got = captured["q"]
    assert got.shape == (b, t, HEADS, DIM // HEADS)
    _assert_bits(got, want, (xt * (DIM // HEADS) ** -0.5).unflatten(
        -1, (HEADS, DIM // HEADS)))
