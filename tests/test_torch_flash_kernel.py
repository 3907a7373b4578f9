"""The port's attention wrapper and its CUDA kernels, without JAX.

The wrapper ``kernels.attention.flash_attention`` takes the plain version
for a CPU tensor and the kernels for a CUDA tensor, with no other path: the
forward kernel, and the backward kernel for its gradient. The
``cuda``-marked tests hold each kernel against the plain version (its
autograd, for the backward) on the card and skip elsewhere. This file imports neither JAX nor ``s2st_tpu``, so on a
machine with a card and no JAX it runs as it is:

    python -m pytest tests/test_torch_flash_kernel.py --noconftest -q

Tolerances on the card: fp32 atol 1e-5 + rtol 1e-5 (fp32 sums in another
order); bf16 atol 2e-2 (the output is rounded to an 8-bit mantissa). The
gradients: fp32 atol 1e-4 + rtol 1e-4 (sums over up to 130 keys or
queries in another order); bf16 within 3e-2 of each gradient's largest
magnitude, against the plain version's autograd in fp32 on the same bf16
inputs and dO. The kernel accumulates in fp32 but, like the TPU kernel,
takes D = rowsum(dO * o) from the bf16 output o, and dS = P (dP - D)
cancels in rows whose probability sits on few keys (early causal rows),
so an elementwise bound would fail where the gradient is near 0; the plain
version run in bf16 is less exact still (it rounds dP to bf16).
"""

import numpy as np
import pytest
import torch

from s2st_tpu_torch.kernels import attention as ka

# name -> (B, Tq, Tk, key lengths, causal)
CASES = {
    "padding": (2, 9, 9, [9, 5], False),
    "causal_padding": (2, 9, 9, [9, 6], True),
    "cross": (2, 7, 11, [11, 4], False),
    "row_without_keys": (2, 9, 9, [9, 0], False),
}


def attention_inputs(b, tq, tk, lengths, seed=0, h=2, d=8):
    """numpy q (pre-scaled), k, v (B, T, H, D) fp32 and the (B, Tk) key
    padding mask, True at pad."""
    r = np.random.RandomState(seed)
    q = (r.randn(b, tq, h, d) * d ** -0.5).astype(np.float32)
    k = r.randn(b, tk, h, d).astype(np.float32)
    v = r.randn(b, tk, h, d).astype(np.float32)
    kpm = np.arange(tk)[None, :] >= np.asarray(lengths)[:, None]
    return q, k, v, kpm


@pytest.mark.parametrize("case", list(CASES))
def test_wrapper_takes_plain_version_on_cpu(case):
    b, tq, tk, lengths, causal = CASES[case]
    args = [torch.from_numpy(x)
            for x in attention_inputs(b, tq, tk, lengths, seed=1)]
    before = ka.flash_attention.launches
    out = ka.flash_attention(*args, causal=causal)
    assert ka.flash_attention.launches == before
    assert torch.equal(out, ka.flash_attention_reference(*args,
                                                         causal=causal))


def test_row_without_keys_averages_all_values():
    """attend's -1e9 replacement: a fully padded row is the mean of v."""
    q, k, v, kpm = attention_inputs(*CASES["row_without_keys"][:4])
    out = ka.flash_attention(*[torch.from_numpy(x) for x in (q, k, v, kpm)])
    np.testing.assert_allclose(out[1].numpy(),
                               np.broadcast_to(v[1].mean(0), out[1].shape),
                               atol=1e-6, rtol=1e-5)


def test_row_without_keys_gradient():
    """A row with no valid key: its dq is 0 and each value gets dO / Tk;
    padded keys get no gradient through their scores."""
    q, k, v, kpm = (torch.from_numpy(x) for x in
                    attention_inputs(*CASES["row_without_keys"][:4], seed=4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    g = torch.from_numpy(np.random.RandomState(5).randn(*q.shape)
                         .astype(np.float32))
    ka.flash_attention(q, k, v, kpm).backward(g)
    assert torch.equal(q.grad[1], torch.zeros_like(q.grad[1]))
    assert torch.equal(k.grad[1], torch.zeros_like(k.grad[1]))
    np.testing.assert_allclose(
        v.grad[1].numpy(),
        np.broadcast_to(g[1].numpy().sum(0) / q.shape[1], v.grad[1].shape),
        atol=1e-6, rtol=1e-5)
    assert torch.equal(k.grad[0][kpm[0]], torch.zeros_like(k.grad[0][kpm[0]]))


def test_wrapper_raises_off_cpu_without_cuda():
    """A tensor that is not on the CPU never quietly takes the plain path."""
    q, k, v, kpm = (torch.from_numpy(x).to("meta")
                    for x in attention_inputs(2, 9, 9, [9, 5]))
    with pytest.raises(ValueError, match="CUDA"):
        ka.flash_attention(q, k, v, kpm)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _on_card(arrays, device, dtype):
    q, k, v, kpm = (torch.from_numpy(x).to(device) for x in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), kpm


def _tolerance(dtype):
    return dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(cuda_device, case, dtype):
    b, tq, tk, lengths, causal = CASES[case]
    dt = getattr(torch, dtype)
    q, k, v, kpm = _on_card(attention_inputs(b, tq, tk, lengths, seed=2, h=4,
                                             d=128), cuda_device, dt)
    before = ka.flash_attention.launches
    out = ka.flash_attention(q, k, v, kpm, causal=causal)
    ref = ka.flash_attention_reference(q, k, v, kpm, causal=causal)
    torch.cuda.synchronize()
    assert ka.flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), **_tolerance(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 64, 72])
def test_kernel_reads_strided_heads_on_card(cuda_device, d):
    """q, k and v as slices of wider (B, T, H, 3D) and (B, T, 3H, D)
    buffers: the kernel reads them through their strides, and head_dim
    need only be a multiple of 8."""
    q, k, v, kpm = _on_card(attention_inputs(3, 70, 130, [130, 64, 1],
                                             seed=3, h=3, d=d),
                            cuda_device, torch.float32)
    wide = torch.zeros((3, 70, 3, 3 * d), device=cuda_device)
    wide[..., d:2 * d] = q
    heads = torch.zeros((3, 130, 9, d), device=cuda_device)
    heads[:, :, 0::3] = k
    heads[:, :, 2::3] = v
    qs, ks, vs = wide[..., d:2 * d], heads[:, :, 0::3], heads[:, :, 2::3]
    assert not qs.is_contiguous() and not ks.is_contiguous()
    out = ka.flash_attention(qs, ks, vs, kpm)
    ref = ka.flash_attention_reference(q, k, v, kpm)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, **_tolerance(torch.float32))


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    q, k, v, kpm = _on_card(attention_inputs(2, 9, 9, [9, 5], h=2, d=16),
                            cuda_device, torch.float32)
    with pytest.raises(TypeError):
        ka.flash_attention(q.half(), k.half(), v.half(), kpm)
    with pytest.raises(TypeError):
        ka.flash_attention(q, k.to(torch.bfloat16), v, kpm)
    with pytest.raises(ValueError, match="head_dim"):
        ka.flash_attention(q[..., :12], k[..., :12], v[..., :12], kpm)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((2, 9, 2, 136), device=cuda_device)
        ka.flash_attention(big, big, big, kpm)
    with pytest.raises(ValueError, match="unit stride"):
        ka.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2], kpm)
    with pytest.raises(ValueError, match="agree"):
        ka.flash_attention(q, k[:, :5], v, kpm)
    with pytest.raises(ValueError, match="key_padding_mask"):
        ka.flash_attention(q, k, v, kpm[:, :5])
    with pytest.raises(TypeError, match="bool"):
        ka.flash_attention(q, k, v, kpm.float())
    with pytest.raises(ValueError, match="device"):
        ka.flash_attention(q, k, v, kpm.cpu())


def _assert_grad_close(got, want, dtype, name):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=name)
    else:
        err = float((got.float() - want).abs().max())
        assert err <= 3e-2 * float(want.abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_kernel_matches_plain_on_card(cuda_device, case, dtype, d):
    """dq, dk, dv of the kernels against autograd of the plain version, at
    the two head widths of the training path (512-d / 4 heads and the aux
    decoders' 64-d / 4 heads)."""
    b, tq, tk, lengths, causal = CASES[case]
    dt = getattr(torch, dtype)
    arrays = attention_inputs(b, tq, tk, lengths, seed=6, h=4, d=d)
    g = torch.from_numpy(np.random.RandomState(7).randn(b, tq, 4, d)
                         .astype(np.float32)).to(cuda_device, dt)
    grads = []
    for fn, ref_dt in ((ka.flash_attention, dt),
                       (ka.flash_attention_reference, torch.float32)):
        q, k, v, kpm = _on_card(arrays, cuda_device, dt)
        q, k, v = (x.to(ref_dt).requires_grad_() for x in (q, k, v))
        fn(q, k, v, kpm, causal=causal).backward(g.to(ref_dt))
        grads.append((q.grad, k.grad, v.grad))
    before = ka.flash_attention.bwd_launches
    q, k, v, kpm = _on_card(arrays, cuda_device, dt)
    q.requires_grad_()
    ka.flash_attention(q, k, v, kpm, causal=causal).backward(g)
    torch.cuda.synchronize()
    assert ka.flash_attention.bwd_launches == before + 1
    for name, got, want in zip("qkv", *grads):
        assert got.dtype == dt and torch.isfinite(got).all(), name
        _assert_grad_close(got, want, dt, name)
