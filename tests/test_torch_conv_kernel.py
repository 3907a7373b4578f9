"""The port's conv wrappers and their CUDA kernels, without JAX.

``kernels.conv.lightconv`` / ``dynamicconv`` take the plain version for a
CPU tensor and the kernel (``csrc/lightconv.cu``, ``csrc/dynamicconv.cu``)
for a CUDA tensor, with no other path; a gradient goes through an autograd
Function whose backward is the plain version's autograd. The
``cuda``-marked tests hold each kernel against the plain version on the
card, at the LightConv serving path's shapes (B=64, T up to 64, C=512, H=4,
K = 3, 7, 15, 31, encoder padding K//2 and causal decoder padding K-1) and
at the edge cases (T < K, T = 1, a row of zeros, H = 1, H = C, every
padding_l, bf16 inputs with fp32 dynamic weights, non-contiguous inputs),
and at a case for each branch of the kernels' design (a K that is not
compiled in, K above a warp's 32 lanes, odd C for the one-element loads, T
that is no multiple of the block's steps or a thread's 8 outputs, B = 1,
an input that is not 16-byte aligned), and skip elsewhere. The launch plan
(block shape, load width, compiled-in K) is chosen in Python and tested
here on the CPU. This file imports neither JAX nor ``s2st_tpu``, so on a
machine with a card and no JAX it runs as it is:

    python -m pytest tests/test_torch_conv_kernel.py --noconftest -q

Tolerances on the card: fp32 atol 1e-5 + rtol 1e-5 (the same fp32 sums,
fused multiply-adds in the kernel); bf16 atol 2e-2 (the output is rounded
to an 8-bit mantissa; the inputs are the same bf16 values on both sides).
"""

import numpy as np
import pytest
import torch

from s2st_tpu_torch.kernels import conv as kc

KINDS = ("lightconv", "dynamicconv")
# name -> (B, T, C, H, K, padding_l, a row of zeros)
CASES = {
    "encoder_K3": (64, 64, 512, 4, 3, 1, False),
    "encoder_K7": (64, 64, 512, 4, 7, 3, False),
    "encoder_K15": (64, 64, 512, 4, 15, 7, False),
    "encoder_K31": (64, 64, 512, 4, 31, 15, False),
    "decoder_K3": (64, 48, 512, 4, 3, 2, False),
    "decoder_K31": (64, 48, 512, 4, 31, 30, False),
    "T_below_K": (4, 9, 512, 4, 31, 15, False),
    "T_1": (4, 1, 512, 4, 31, 30, False),
    "zero_row": (4, 33, 512, 4, 15, 7, True),
    "H_1": (4, 40, 512, 1, 7, 3, False),
    "H_C": (2, 40, 64, 64, 5, 2, False),
    "padding_0": (3, 37, 136, 8, 5, 0, False),
    "K_9": (4, 40, 512, 4, 9, 4, False),
    "K_40": (4, 45, 512, 4, 40, 20, False),
    "odd_C": (4, 37, 129, 3, 7, 3, False),
    "T_77": (3, 77, 512, 4, 31, 15, False),
    "B_1": (1, 64, 512, 4, 31, 15, False),
}


def conv_inputs(kind, b, t, c, h, k, zero_row=False, seed=0):
    """numpy x (B, T, C) and the raw weights: (H, K) for lightconv, the
    (B, T, H, K) logits for dynamicconv; fp32."""
    r = np.random.RandomState(seed)
    x = r.randn(b, t, c).astype(np.float32)
    if zero_row:
        x[-1] = 0.0          # an all-pad source row, zeroed before the conv
    shape = (h, k) if kind == "lightconv" else (b, t, h, k)
    return x, (r.randn(*shape) * 2).astype(np.float32)


def fns(kind):
    return getattr(kc, kind), getattr(kc, f"{kind}_reference")


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_takes_plain_version_on_cpu(kind):
    fn, plain = fns(kind)
    x, w = (torch.from_numpy(a) for a in conv_inputs(kind, 2, 9, 8, 2, 5))
    before = fn.launches
    out = fn(x, w, 2, 2)
    assert fn.launches == before
    assert torch.equal(out, plain(x, w, 2, 2))


@pytest.mark.parametrize("kind", KINDS)
def test_zero_row_stays_zero_and_causal_ignores_the_future(kind):
    fn, _ = fns(kind)
    x, w = conv_inputs(kind, 2, 10, 8, 2, 3, zero_row=True, seed=1)
    y1 = fn(torch.from_numpy(x), torch.from_numpy(w), 2, 2).numpy()
    assert not y1[-1].any()
    x2 = x.copy()
    x2[:, 6:] += 10.0
    y2 = fn(torch.from_numpy(x2), torch.from_numpy(w), 2, 2).numpy()
    np.testing.assert_array_equal(y1[:, :6], y2[:, :6])


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_raises_off_cpu_without_cuda(kind):
    """A tensor that is not on the CPU never quietly takes the plain path."""
    fn, _ = fns(kind)
    x, w = (torch.from_numpy(a).to("meta")
            for a in conv_inputs(kind, 2, 9, 8, 2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        fn(x, w, 2, 2)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("padding_l", [-1, 5])
def test_padding_outside_the_kernel_raises(kind, padding_l):
    fn, _ = fns(kind)
    x, w = (torch.from_numpy(a) for a in conv_inputs(kind, 2, 9, 8, 2, 5))
    with pytest.raises(ValueError, match="padding_l"):
        fn(x, w, padding_l, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_gradient_is_the_plain_versions_autograd(kind):
    """Through the autograd Function (CPU: its forward is the plain
    version) and through plain autograd: the same gradients."""
    fn, plain = fns(kind)
    x, w = conv_inputs(kind, 2, 9, 8, 2, 5, seed=2)
    g = torch.from_numpy(np.random.RandomState(3).randn(2, 9, 8)
                         .astype(np.float32))
    grads = []
    for f in (fn, plain):
        xx, ww = (torch.from_numpy(a).requires_grad_() for a in (x, w))
        f(xx, ww, 4, 2).backward(g)
        grads.append((xx.grad, ww.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


# case -> (dtype, data pointer, warps, 16-byte loads, K compiled in)
PLANS = {
    "encoder_K31": ("bfloat16", 0, 4, True, True),
    "decoder_K31": ("float32", 0, 4, True, True),
    "T_below_K": ("bfloat16", 0, 1, True, True),
    "T_1": ("bfloat16", 0, 1, True, True),
    "K_9": ("bfloat16", 0, 4, True, False),
    "K_40": ("float32", 0, 4, True, False),
    "odd_C": ("float32", 0, 4, False, True),
    "padding_0": ("bfloat16", 0, 4, True, False),
    "H_C": ("float32", 0, 4, True, False),
    "encoder_K15": ("bfloat16", 2, 4, False, True),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(PLANS))
def test_launch_plan(kind, case):
    """4 warps (64 steps) a block down to the fewest that cover T; 16-byte
    loads only where C is a multiple of 16 bytes' elements and the pointer
    is 16-byte aligned; K compiled in for 3, 7, 15 and 31 only."""
    _, t, c, h, k, _, _ = CASES[case]
    dtype, ptr, warps, vector, templated = PLANS[case]
    plan = kc.launch_plan(kind, t, c, h, k, getattr(torch, dtype), ptr)
    assert (plan["warps"], plan["vector"], plan["templated_k"]) == \
        (warps, vector, templated)
    assert plan["smem_bytes"] == kc.smem_bytes(kind, c, h, k, warps)


def test_heads_a_block_spans():
    assert kc.max_heads_in_chunk(512, 4) == 1        # 128 channels a head
    assert kc.max_heads_in_chunk(136, 8) == 3        # 17: 15 + 17 of 32
    assert kc.max_heads_in_chunk(129, 3) == 2        # 43
    assert kc.max_heads_in_chunk(64, 64) == 32       # one channel a head


def test_launch_plan_halves_the_block_to_fit_shared_memory():
    """dynamicconv at one channel a head keeps (steps x 32 heads x K) weights
    a block: at K = 50 only 2 warps fit in 227 KiB, at K = 100 one; at
    K = 300 not even one, which raises before any launch. lightconv keeps
    one row a head and takes the largest K the wrapper ever took (211) at
    any H."""
    for k, warps in ((50, 2), (100, 1)):
        plan = kc.launch_plan("dynamicconv", 100, 64, 64, k, torch.float32)
        assert plan["warps"] == warps and plan["smem_bytes"] <= 227 * 1024
        assert kc.smem_bytes("dynamicconv", 64, 64, k, 2 * warps) > \
            227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        kc.launch_plan("dynamicconv", 100, 64, 64, 300, torch.float32)
    for h in (1, 4, 512):
        assert kc.launch_plan("lightconv", 100, 512, h, 211,
                              torch.float32)["warps"] == 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _tolerance(dtype):
    return dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(cuda_device, kind, case, dtype):
    b, t, c, h, k, pad, zero_row = CASES[case]
    dt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to(cuda_device)
            for a in conv_inputs(kind, b, t, c, h, k, zero_row, seed=4))
    x = x.to(dt)
    if kind == "dynamicconv":
        w = w.to(dt)
    fn, plain = fns(kind)
    before = fn.launches
    out = fn(x, w, pad, h)
    ref = plain(x, w, pad, h)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == dt and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.float(), **_tolerance(dt))
    if zero_row:
        assert not out[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["encoder_K31", "decoder_K31"])
def test_dynamicconv_bf16_input_fp32_weights(cuda_device, case):
    b, t, c, h, k, pad, _ = CASES[case]
    x, w = (torch.from_numpy(a).to(cuda_device) for a in
            conv_inputs("dynamicconv", b, t, c, h, k, seed=5))
    x = x.to(torch.bfloat16)
    out = kc.dynamicconv(x, w, pad, h)
    ref = kc.dynamicconv_reference(x, w, pad, h)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_takes_non_contiguous_input(cuda_device, kind):
    x, w = (torch.from_numpy(a).to(cuda_device) for a in
            conv_inputs(kind, 4, 30, 256, 4, 7, seed=6))
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)   # (B, T, C) view
    assert not xt.is_contiguous()
    fn, plain = fns(kind)
    torch.testing.assert_close(fn(xt, w, 3, 4), plain(x, w, 3, 4),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_takes_unaligned_input(cuda_device, kind, dtype):
    """x contiguous but 2 elements past a 16-byte boundary: the kernel
    stages it one element a thread, with the same result."""
    b, t, c, h, k, pad, _ = CASES["encoder_K31"]
    dt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to(cuda_device) for a in
            conv_inputs(kind, 4, t, c, h, k, seed=8))
    flat = torch.empty(x.numel() + 2, dtype=dt, device=cuda_device)
    xs = flat[2:].view(x.shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    assert not kc.launch_plan(kind, t, c, h, k, dt, xs.data_ptr())["vector"]
    fn, plain = fns(kind)
    torch.testing.assert_close(fn(xs, w, pad, h).float(),
                               plain(xs, w, pad, h).float(),
                               **_tolerance(dt))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_gradient_on_card(cuda_device, kind):
    """Forward through the kernel, backward through the plain version."""
    fn, plain = fns(kind)
    x, w = conv_inputs(kind, 4, 20, 64, 4, 7, seed=7)
    g = torch.randn(4, 20, 64, device=cuda_device)
    grads = []
    for f in (fn, plain):
        xx, ww = (torch.from_numpy(a).to(cuda_device).requires_grad_()
                  for a in (x, w))
        before = fn.launches
        f(xx, ww, 6, 4).backward(g)
        assert fn.launches == before + (f is fn)
        grads.append((xx.grad, ww.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_refuses_what_it_cannot_take(cuda_device, kind):
    fn, _ = fns(kind)
    x, w = (torch.from_numpy(a).to(cuda_device)
            for a in conv_inputs(kind, 2, 9, 8, 2, 5))
    with pytest.raises(TypeError):
        fn(x.half(), w, 2, 2)
    with pytest.raises(ValueError):
        fn(x, w.cpu(), 2, 2)
    with pytest.raises(ValueError):
        fn(x[:, :, :7], w, 2, 2)
