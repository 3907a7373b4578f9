"""s2st_tpu_torch attention against s2st_tpu's.

The port's plain attention (the CPU path of ``flash_attention`` and
``attend``) is held against JAX ``attend`` + ``causal_mask``, the function
the TPU flash kernel computes (``attend_flash`` has no CPU path,
tools/flash_attention_parity.py:1-3). The CUDA kernel itself is held
against the plain version on the card in tests/test_torch_flash_kernel.py
(marked ``cuda``), and by chip_smoke.py at the serving shapes.

Tolerance: fp32 on both sides, only the summation order differs:
atol 1e-6, rtol 1e-5.
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
