"""s2st_tpu_torch's lightweight and dynamic convolutions against
s2st_tpu/ops/conv_kernels.py, fp32 on the CPU.

On the CPU the port's ``lightconv`` / ``dynamicconv`` run their plain
versions; the JAX side runs its Pallas kernels in interpret mode (as
``tests/test_conv_kernels.py`` does) and its XLA references. Cases: K in
{1, 3, 7} with every padding of {0, K//2, K-1}, H in {1, 2, 4}, T < K, and
a row of zeros (an all-pad source row, zeroed before the encoder conv).
The gradient of the port's autograd Function (its backward is the plain
version's autograd) is held against ``jax.vjp`` of the JAX reference,
which is what the Pallas functions' ``custom_vjp`` backward runs.

Tolerance: atol 1e-5, rtol 1e-5 (fp32 sums over at most 7 taps, in the same
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.ops import conv_kernels as jck
from s2st_tpu_torch.kernels import conv as pck

TOL = dict(atol=1e-5, rtol=1e-5)


def _paddings(k):
    return sorted({0, k // 2, k - 1})


CASES = [(k, pad, h) for k in (1, 3, 7) for pad in _paddings(k)
         for h in (1, 2, 4)]


def inputs(kind, b, t, c, h, k, seed, zero_row=False):
    r = np.random.RandomState(seed)
    x = r.randn(b, t, c).astype(np.float32)
    if zero_row:
        x[0] = 0.0
    shape = (h, k) if kind == "lightconv" else (b, t, h, k)
    return x, (r.randn(*shape) * 2).astype(np.float32)


def check(kind, x, w, pad, h):
    port = getattr(pck, kind)(torch.from_numpy(x), torch.from_numpy(w), pad,
                              h).numpy()
    pallas = getattr(jck, kind)(jnp.asarray(x), jnp.asarray(w), pad, h)
    ref = getattr(jck, f"{kind}_reference")(jnp.asarray(x), jnp.asarray(w),
                                            pad, h)
    np.testing.assert_allclose(port, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(port, np.asarray(ref), **TOL)
    return port


@pytest.mark.parametrize("kind", ["lightconv", "dynamicconv"])
@pytest.mark.parametrize("k,pad,h", CASES)
def test_matches_jax(kind, k, pad, h):
    x, w = inputs(kind, 2, 11, 8, h, k, seed=k * 10 + pad + h)
    check(kind, x, w, pad, h)


@pytest.mark.parametrize("kind", ["lightconv", "dynamicconv"])
@pytest.mark.parametrize("pad", [0, 3, 6])
def test_time_shorter_than_kernel(kind, pad):
    x, w = inputs(kind, 2, 4, 8, 2, 7, seed=pad)
    check(kind, x, w, pad, 2)


@pytest.mark.parametrize("kind", ["lightconv", "dynamicconv"])
def test_zero_row(kind):
    x, w = inputs(kind, 3, 9, 8, 2, 7, seed=5, zero_row=True)
    out = check(kind, x, w, 3, 2)
    assert not out[0].any()


@pytest.mark.parametrize("kind", ["lightconv", "dynamicconv"])
@pytest.mark.parametrize("pad", [1, 4])
def test_gradient_matches_jax_vjp(kind, pad):
    x, w = inputs(kind, 2, 9, 8, 2, 5, seed=pad + 7)
    g = np.random.RandomState(11).randn(2, 9, 8).astype(np.float32)
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    getattr(pck, kind)(xt, wt, pad, 2).backward(torch.from_numpy(g))
    ref = getattr(jck, f"{kind}_reference")
    _, vjp = jax.vjp(lambda a, b: ref(a, b, pad, 2), jnp.asarray(x),
                     jnp.asarray(w))
    gx, gw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), **TOL)
