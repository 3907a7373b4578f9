"""s2st_tpu_torch attention against s2st_tpu's.

The port's plain attention (the CPU path of ``flash_attention`` and
``attend``) is held against JAX ``attend`` + ``causal_mask``, the function
the TPU flash kernel computes (``attend_flash`` has no CPU path,
tools/flash_attention_parity.py:1-3). The CUDA kernel itself is held
against the plain version on the card in tests/test_torch_flash_kernel.py
(marked ``cuda``), and by chip_smoke.py at the serving shapes.

The gradient of the port's attention (the plain path, plain autograd on
the CPU) is held against ``jax.grad`` of ``attend`` in the same four cases;
the backward kernel is held against that plain autograd on the card.

Tolerance: fp32 on both sides, only the summation order differs:
atol 1e-6, rtol 1e-5 (gradients: atol 1e-5, rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.nn import attention as ja
from s2st_tpu_torch.kernels import attention as ka
from s2st_tpu_torch.nn import attention as pa
from tests.test_torch_flash_kernel import CASES, attention_inputs

ATOL, RTOL = 1e-6, 1e-5


def _jax_attend(q, k, v, kpm, causal):
    mask = ja.causal_mask(q.shape[1]) if causal else None
    return ja.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     key_padding_mask=jnp.asarray(kpm), attn_mask=mask)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_attention_matches_jax_attend(case):
    b, tq, tk, lengths, causal = CASES[case]
    q, k, v, kpm = attention_inputs(b, tq, tk, lengths)
    j_out, j_w = _jax_attend(q, k, v, kpm, causal)
    args = [torch.from_numpy(x) for x in (q, k, v, kpm)]
    ref = ka.flash_attention_reference(*args, causal=causal)
    np.testing.assert_allclose(ref.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=RTOL)
    # the port's weights-returning attend agrees as well
    attn_mask = pa.causal_mask(tq) if causal else None
    p_out, p_w = pa.attend(*args, attn_mask=attn_mask)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(p_w.numpy(), np.asarray(j_w), atol=ATOL,
                               rtol=RTOL)


def _mha_pair(seed, dim=16, heads=2, kdim=None):
    import jax
    p = ja.mha_init(jax.random.PRNGKey(seed), dim, heads, kdim=kdim,
                    vdim=kdim)
    mod = pa.MultiheadAttention(dim, heads, kdim=kdim, vdim=kdim)
    with torch.no_grad():
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("out", "out_proj")):
            lin = getattr(mod, theirs)
            lin.weight.copy_(torch.from_numpy(np.array(p[ours]["w"]).T))
            lin.bias.copy_(torch.from_numpy(np.array(p[ours]["b"])))
    return p, mod


@pytest.mark.parametrize("causal,need_weights,cross",
                         [(False, False, False), (True, False, False),
                          (False, True, True), (False, False, True)])
def test_mha_matches_jax(causal, need_weights, cross):
    kdim = 12 if cross else None
    p, mod = _mha_pair(seed=3, kdim=kdim)
    r = np.random.RandomState(4)
    x = r.randn(2, 7, 16).astype(np.float32)
    mem = r.randn(2, 10, kdim).astype(np.float32) if cross else x
    kpm = np.arange(mem.shape[1])[None, :] >= np.array([[mem.shape[1]], [4]])
    j_out, j_w = ja.mha(p, jnp.asarray(x), jnp.asarray(mem), jnp.asarray(mem),
                        2, key_padding_mask=jnp.asarray(kpm),
                        need_weights=need_weights, causal=causal)
    with torch.no_grad():
        p_out, p_w = mod(torch.from_numpy(x), torch.from_numpy(mem),
                         torch.from_numpy(mem),
                         key_padding_mask=torch.from_numpy(kpm),
                         causal=causal, need_weights=need_weights)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=1e-5,
                               rtol=RTOL)
    assert (p_w is None) == (j_w is None)
    if need_weights:
        np.testing.assert_allclose(p_w.numpy(), np.asarray(j_w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_attention_gradient_matches_jax(case):
    import jax
    b, tq, tk, lengths, causal = CASES[case]
    q, k, v, kpm = attention_inputs(b, tq, tk, lengths, seed=8)
    g = np.random.RandomState(9).randn(*q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(_jax_attend(q_, k_, v_, kpm, causal)[0] * g)

    j_grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    p_in = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ka.flash_attention(*p_in, torch.from_numpy(kpm),
                       causal=causal).backward(torch.from_numpy(g))
    for name, p_x, j_g in zip("qkv", p_in, j_grads):
        np.testing.assert_allclose(p_x.grad.numpy(), np.asarray(j_g),
                                   atol=1e-5, rtol=RTOL, err_msg=name)


# the four cases of CASES, and a causal row whose keys are all padded
PATH_CASES = {**CASES, "causal_row_without_keys": (2, 9, 9, [9, 0], True)}


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("case", list(PATH_CASES))
def test_attention_gradient_matches_jax_at_path_head_dims(case, d):
    """The plain version's autograd, the CPU side of the backward kernel,
    against jax.grad of ``attend`` (the function ``attend_flash``'s VJP
    differentiates; the Pallas kernel has no CPU path) at the head dims the
    kernels run on the paths: 16 (the aux decoders), 64 (HuBERT), 128 (the
    encoder and decoder), 4 heads, with padded keys, causal rows and rows
    without a valid key. atol 1e-5, rtol 1e-5 (fp32, summation order)."""
    import jax
    b, tq, tk, lengths, causal = PATH_CASES[case]
    q, k, v, kpm = attention_inputs(b, tq, tk, lengths, seed=d, h=4, d=d)
    g = np.random.RandomState(d + 1).randn(*q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(_jax_attend(q_, k_, v_, kpm, causal)[0] * g)

    j_grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    p_in = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    ka.flash_attention(*p_in, torch.from_numpy(kpm),
                       causal=causal).backward(torch.from_numpy(g))
    for name, p_x, j_g in zip("qkv", p_in, j_grads):
        np.testing.assert_allclose(p_x.grad.numpy(), np.asarray(j_g),
                                   atol=1e-5, rtol=RTOL, err_msg=name)


def test_mha_probability_dropout_takes_attend():
    """With a generator and a dropout rate the call drops probabilities:
    it equals ``attend`` with the same draws, and differs from the call
    without dropout (mha's gate, nn/attention.py:137-140)."""
    _, mod = _mha_pair(seed=5)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 7, 16)
                         .astype(np.float32))
    kpm = torch.tensor([[False] * 7, [False] * 4 + [True] * 3])
    with torch.no_grad():
        plain, _ = mod(x, x, x, key_padding_mask=kpm, causal=True)
        dropped, _ = mod(x, x, x, key_padding_mask=kpm, causal=True,
                         dropout_rate=0.5,
                         generator=torch.Generator().manual_seed(3))
        q = pa.split_heads(pa.linear(x, mod.q_proj.weight, mod.q_proj.bias)
                           * mod.scale, 2)
        kv = [pa.split_heads(pa.linear(x, lin.weight, lin.bias), 2)
              for lin in (mod.k_proj, mod.v_proj)]
        out, _ = pa.attend(q, *kv, kpm, pa.causal_mask(7), 0.5,
                           torch.Generator().manual_seed(3))
        ref = pa.linear(out.reshape(2, 7, 16), mod.out_proj.weight,
                        mod.out_proj.bias)
    assert torch.equal(dropped, ref)
    assert not torch.allclose(dropped, plain)
