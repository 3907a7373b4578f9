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

The bf16 kernels (tensor cores; blocks of 32 or 64 resident rows, 16 a
warp; 32-row streamed tiles; at small grids splits of the streamed loop
over groups of warps) are also held at T on both sides of those tiles,
head_dim 8 and 72 (zero-filled to 16 and 128), the key masks that
decide which tiles they skip, grids of several sizes, run-to-run
reproducibility and rows that are not 16-byte aligned. With a single key,
dq and dk are 0 in exact arithmetic, so their bound is taken from dv's
magnitude instead (the kernel's dP - D is then fp32 rounding).

The fp32 kernels (CUDA-core FMAs; blocks of 32 or 64 resident rows,
32-row streamed tiles, 16-row ones in the backward on larger grids,
head_dim 16, 64 or 128 compiled in; the backward in two launches, dQ
then dK/dV) are held the same way at fp32's
tolerances: every head_dim from 8 to 128 in steps of 8, T on both sides
of their tiles, cross-attention, the key masks that decide which tiles
they skip, B*H up to 400, the forward's row statistics against the plain
version's row max and log-sum-exp, the backward run on those statistics,
and the backward's run-to-run reproducibility.
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


def test_designs_name_the_two_launch_fp32_backward():
    """The fp32 backward is the register-tiled two-launch design; the
    scalar kernels it replaced are gone, and ``DESIGNS`` (which
    chip_smoke.py prints beside each kernel's times) no longer names
    them."""
    fp32 = ka.DESIGNS["float32"]
    assert "scalar" not in fp32
    assert "register tiles" in fp32 and "two launches" in fp32
    assert "tensor cores" in ka.DESIGNS["bfloat16"]


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
@pytest.mark.parametrize("d", [8, 64, 72, 16, 128])
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


@pytest.mark.parametrize("c,h", [(512, 4), (64, 4)])
def test_split_heads_rows_are_16_byte_aligned(c, h):
    """The main path's q, k and v are ``split_heads`` of a linear's (B, T,
    C) output: in bf16 at the recipe's widths (512-d / 4 heads and the aux
    decoders' 64-d / 4 heads) every (b, t, h) row starts 16-byte aligned,
    so the bf16 kernels' cp.async copies can take them."""
    from s2st_tpu_torch.nn.attention import split_heads
    x = torch.nn.functional.linear(torch.zeros(3, 7, c, dtype=torch.bfloat16),
                                   torch.zeros(c, c, dtype=torch.bfloat16))
    heads = split_heads(x, h)
    assert heads.shape == (3, 7, h, c // h)
    assert ka.misalignment(heads) is None
    assert ka.misalignment(split_heads(x[:, 2:], h)) is None


@pytest.mark.parametrize("c,h", [(768, 12), (512, 4), (64, 4)])
def test_split_heads_rows_are_16_byte_aligned_in_fp32(c, h):
    """The same in fp32, whose forward kernel copies rows with 16-byte
    cp.async too: the HuBERT frontend's 768-d / 12 heads (its attention runs
    in fp32) and the recipe's widths."""
    from s2st_tpu_torch.nn.attention import split_heads
    x = torch.nn.functional.linear(torch.zeros(3, 7, c), torch.zeros(c, c))
    assert ka.misalignment(split_heads(x, h)) is None
    assert ka.misalignment(split_heads(x[:, 2:], h)) is None


def test_misalignment_names_the_offending_layout():
    buf = torch.zeros(2 * 5 * 4 * 16 + 8, dtype=torch.bfloat16)
    ok = buf[:2 * 5 * 4 * 16].view(2, 5, 4, 16)
    assert ka.misalignment(ok) is None
    shifted = buf[1:1 + 2 * 5 * 4 * 16].view(2, 5, 4, 16)
    assert "data pointer" in ka.misalignment(shifted)
    wide = torch.zeros(2, 5, 4 * 16 + 4, dtype=torch.bfloat16)
    assert "batch stride" in ka.misalignment(
        wide[..., :64].unflatten(-1, (4, 16)))
    assert "time stride" in ka.misalignment(
        wide[:1, :, :64].unflatten(-1, (4, 16)))
    # a stride of a dimension of length 1 is never used
    assert ka.misalignment(wide[:1, :1, :64].unflatten(-1, (4, 16))) is None


def _bf16_case_on_card(device, b, tq, tk, kpm, causal, d, seed, h=2):
    """The bf16 kernels' forward and backward against the plain version
    (forward in bf16, atol 2e-2; gradients against its fp32 autograd, 3e-2 of
    each gradient's largest magnitude) at one geometry and key mask."""
    r = np.random.RandomState(seed)
    q = (r.randn(b, tq, h, d) * d ** -0.5).astype(np.float32)
    k = r.randn(b, tk, h, d).astype(np.float32)
    v = r.randn(b, tk, h, d).astype(np.float32)
    g = r.randn(b, tq, h, d).astype(np.float32)
    q, k, v, g = (torch.from_numpy(x).to(device, torch.bfloat16)
                  for x in (q, k, v, g))
    kpm = torch.from_numpy(np.asarray(kpm, dtype=bool)).to(device)
    out = ka.flash_attention(q, k, v, kpm, causal=causal)
    ref = ka.flash_attention_reference(q, k, v, kpm, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(),
                               **_tolerance(torch.bfloat16))
    grads = []
    for fn, dt in ((ka.flash_attention, torch.bfloat16),
                   (ka.flash_attention_reference, torch.float32)):
        leaves = [x.detach().to(dt).requires_grad_() for x in (q, k, v)]
        fn(*leaves, kpm, causal=causal).backward(g.to(dt))
        grads.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    for name, got, want in zip("qkv", *grads):
        assert got.dtype == torch.bfloat16 and torch.isfinite(got).all(), name
        if tk == 1 and name in "qk":
            # one key takes all the weight, so dq and dk are 0 in exact
            # arithmetic and 3e-2 of their largest magnitude is 0; the
            # kernel's dS = P (dP - D) is the fp32 rounding of dP - D (o = v
            # here), held to 1e-4 of dv's largest magnitude
            assert float(want.abs().max()) == 0.0, name
            err = float(got.float().abs().max())
            assert err <= 1e-4 * float(grads[1][2].abs().max()), (name, err)
        else:
            _assert_grad_close(got, want, torch.bfloat16, name)


# T on both sides of the bf16 kernels' 32-row streamed tiles and their
# blocks of 32 or 64 resident rows, and head_dim 8 and 72, which they
# zero-fill up to 16 and 128
GEOMETRY_T = [1, 32, 33, 63, 64, 65, 130, 257]
GEOMETRY_D = [8, 16, 72, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", GEOMETRY_D)
@pytest.mark.parametrize("t", GEOMETRY_T)
def test_bf16_self_attention_geometry_on_card(cuda_device, t, d, causal):
    lengths = [t, max(1, t - 37)]
    kpm = np.arange(t)[None, :] >= np.asarray(lengths)[:, None]
    _bf16_case_on_card(cuda_device, 2, t, t, kpm, causal, d, seed=t + d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", GEOMETRY_D)
@pytest.mark.parametrize("tq,tk", [(1, 257), (63, 130), (65, 1), (257, 64),
                                   (130, 63)])
def test_bf16_cross_attention_geometry_on_card(cuda_device, tq, tk, d):
    lengths = [tk, max(1, tk // 3)]
    kpm = np.arange(tk)[None, :] >= np.asarray(lengths)[:, None]
    _bf16_case_on_card(cuda_device, 2, tq, tk, kpm, False, d,
                       seed=tq + 3 * tk + d)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", GEOMETRY_D)
@pytest.mark.parametrize("b,h", [(6, 4), (12, 4)])
def test_bf16_larger_grids_on_card(cuda_device, b, h, d, causal):
    """Grids of 216 and 432 blocks of 32 rows: the bf16 kernels change
    their block shape as the grid grows (on a 132-SM card: 64-row blocks
    in 2 splits of 4 warps, then 64-row blocks of 4 warps and no split;
    the small grids of the other tests take 32-row blocks in 4 splits);
    each holds."""
    t = 257
    lengths = [max(0, t - 29 * i) for i in range(b)]  # the last rows: none
    kpm = np.arange(t)[None, :] >= np.asarray(lengths)[:, None]
    _bf16_case_on_card(cuda_device, b, t, t, kpm, causal, d, seed=b + d,
                       h=h)


@pytest.mark.cuda
def test_bf16_backward_is_bit_reproducible_on_card(cuda_device):
    """No float atomics: the splits' partial gradients are added in a fixed
    order, so two calls on the same inputs agree bit for bit."""
    t, d = 250, 128
    q, k, v, kpm = _on_card(attention_inputs(8, t, t, [t - 19 * i
                                                        for i in range(8)],
                                             seed=9, h=4, d=d),
                            cuda_device, torch.bfloat16)
    g = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    out, m, lse = ka.flash_attention_forward(q, k, v, kpm, stats=True)
    first = ka.flash_attention_backward(q, k, v, out, m, lse, g, kpm)
    for _ in range(3):
        again = ka.flash_attention_backward(q, k, v, out, m, lse, g, kpm)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _mask(pattern, t):
    """(2, t) key padding, True at pad; row 0 has every key valid."""
    kpm = np.zeros((2, t), dtype=bool)
    if pattern == "key0_padded":        # the only padded key is key 0
        kpm[1, 0] = True
    elif pattern == "length0":          # no valid key at all
        kpm[1] = True
    elif pattern == "tail_tiles_padded":  # keys 40.. padded: 3 whole tiles
        kpm[1, 40:] = True
    return kpm


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pattern", ["key0_padded", "length0",
                                     "tail_tiles_padded"])
def test_bf16_key_masks_on_card(cuda_device, pattern, causal, d):
    """The masks that decide which tiles the bf16 kernels may skip: a
    causal row whose key 0 is padded and a row without a valid key skip
    nothing (they average over every key); padded tail tiles of a row with
    valid keys are skipped, exactly."""
    _bf16_case_on_card(cuda_device, 2, 257, 257, _mask(pattern, 257), causal,
                       d, seed=d + len(pattern))


@pytest.mark.cuda
def test_bf16_refuses_unaligned_views_on_card(cuda_device):
    """A view whose rows do not start 16-byte aligned raises, forward and
    backward: the kernels copy rows with 16-byte cp.async, in bf16 and, since
    the fp32 forward streams its tiles the same way, in fp32."""
    b, t, h, d = 2, 33, 2, 16
    kpm = torch.zeros((b, t), dtype=torch.bool, device=cuda_device)
    for dt in (torch.bfloat16, torch.float32):
        extra = 64 // torch.finfo(dt).bits   # 8 bytes of elements
        wide = torch.randn(b, t, h * d + extra, device=cuda_device).to(dt)
        heads = [wide[..., i:i + h * d].unflatten(-1, (h, d))
                 for i in (0, 1, extra)]  # aligned base; shifted 2-8 bytes
        ok = torch.randn(b, t, h, d, device=cuda_device).to(dt)
        with pytest.raises(ValueError, match="16-byte"):
            ka.flash_attention(heads[0], ok, ok, kpm)  # time stride
        with pytest.raises(ValueError, match="16-byte"):
            ka.flash_attention(ok, heads[1], ok, kpm)  # data pointer
        with pytest.raises(ValueError, match="16-byte"):
            ka.flash_attention(ok, ok, heads[2], kpm)
        out, m, lse = ka.flash_attention_forward(ok, ok, ok, kpm, stats=True)
        shifted = torch.zeros(b * t * h * d + 1, dtype=dt,
                              device=cuda_device)[1:].view(b, t, h, d)
        with pytest.raises(ValueError, match="16-byte"):
            ka.flash_attention_backward(ok, ok, ok, out, m, lse, shifted, kpm)


def _fp32_case_on_card(device, b, tq, tk, kpm, causal, d, seed, h=2):
    """The fp32 forward against the plain version (atol 1e-5 + rtol 1e-5),
    its row statistics against the plain logits' row max and log-sum-exp
    (the same tolerance), and the fp32 backward kernel run on those
    statistics against the plain version's autograd (atol 1e-4 + rtol
    1e-4), at one geometry and key mask."""
    r = np.random.RandomState(seed)
    q = (r.randn(b, tq, h, d) * d ** -0.5).astype(np.float32)
    k = r.randn(b, tk, h, d).astype(np.float32)
    v = r.randn(b, tk, h, d).astype(np.float32)
    g = r.randn(b, tq, h, d).astype(np.float32)
    q, k, v, g = (torch.from_numpy(x).to(device) for x in (q, k, v, g))
    kpm = torch.from_numpy(np.asarray(kpm, dtype=bool)).to(device)
    before = ka.flash_attention.launches
    out, m, lse = ka.flash_attention_forward(q, k, v, kpm, causal, stats=True)
    ref = ka.flash_attention_reference(q, k, v, kpm, causal=causal)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        logits = logits + torch.triu(
            torch.full((tq, tk), ka.NEG_INF, device=device), diagonal=1)
    logits = logits.masked_fill(kpm[:, None, None, :], ka.NEG_INF)
    torch.cuda.synchronize()
    assert ka.flash_attention.launches == before + 1
    torch.testing.assert_close(out, ref, **_tolerance(torch.float32))
    torch.testing.assert_close(m, logits.amax(-1), **_tolerance(torch.float32))
    torch.testing.assert_close(m + lse, torch.logsumexp(logits, -1),
                               **_tolerance(torch.float32))
    got = ka.flash_attention_backward(q, k, v, out, m, lse, g, kpm, causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ka.flash_attention_reference(*leaves, kpm, causal=causal).backward(g)
    torch.cuda.synchronize()
    for name, x, leaf in zip("qkv", got, leaves):
        assert torch.isfinite(x).all(), name
        _assert_grad_close(x, leaf.grad, torch.float32, name)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_fp32_head_dims_on_card(cuda_device, d, causal):
    """Every head_dim the gate takes: 16, 64 and 128 are compiled in, the
    others zero-filled up to the next of them."""
    t = 130
    kpm = np.arange(t)[None, :] >= np.asarray([t, 93])[:, None]
    _fp32_case_on_card(cuda_device, 2, t, t, kpm, causal, d, seed=d)


# T on both sides of the fp32 forward's 64-query blocks and 32-key tiles;
# head_dim at its three compiled widths and one zero-filled
FP32_T = [1, 32, 33, 63, 64, 65, 129, 257]
FP32_D = [16, 64, 72, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", FP32_D)
@pytest.mark.parametrize("t", FP32_T)
def test_fp32_self_attention_geometry_on_card(cuda_device, t, d, causal):
    lengths = [t, max(1, t - 37)]
    kpm = np.arange(t)[None, :] >= np.asarray(lengths)[:, None]
    _fp32_case_on_card(cuda_device, 2, t, t, kpm, causal, d, seed=t + d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", FP32_D)
@pytest.mark.parametrize("tq,tk", [(1, 257), (63, 130), (65, 1), (257, 64),
                                   (130, 63)])
def test_fp32_cross_attention_geometry_on_card(cuda_device, tq, tk, d):
    lengths = [tk, max(1, tk // 3)]
    kpm = np.arange(tk)[None, :] >= np.asarray(lengths)[:, None]
    _fp32_case_on_card(cuda_device, 2, tq, tk, kpm, False, d,
                       seed=tq + 3 * tk + d)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("b,h", [(6, 4), (16, 12), (100, 4)])
def test_fp32_larger_grids_on_card(cuda_device, b, h, d, causal):
    """B*H from 24 to 400 (HuBERT's 192 among them), T'=257: rows of
    every length down to none. Here the fp32 forward takes blocks of 64
    queries; the other fp32 tests' small grids take its blocks of 32."""
    t = 257
    lengths = [max(0, t - (t * i) // (b - 1) - (i == b - 1))
               for i in range(b)]
    kpm = np.arange(t)[None, :] >= np.asarray(lengths)[:, None]
    _fp32_case_on_card(cuda_device, b, t, t, kpm, causal, d, seed=b + d,
                       h=h)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [2, 64])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("pattern", ["key0_padded", "length0",
                                     "tail_tiles_padded"])
def test_fp32_key_masks_on_card(cuda_device, pattern, causal, d, h):
    """The masks that decide which tiles the fp32 kernels may skip: a
    causal row whose key 0 is padded and a row without a valid key skip
    nothing; padded tail tiles of a row with valid keys are skipped,
    exactly. With 64 heads the backward streams 16-row tiles, with 2
    32-row ones."""
    _fp32_case_on_card(cuda_device, 2, 257, 257, _mask(pattern, 257),
                       causal, d, seed=d + len(pattern), h=h)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 32])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_fp32_backward_is_bit_reproducible_on_card(cuda_device, d, b):
    """No float atomics in fp32 either: D_i and every gradient are summed
    in a fixed order, so calls on the same inputs agree bit for bit, and
    each is two launches counted as one call (B=8 streams 32-row tiles,
    B=32 16-row ones)."""
    t = 250
    q, k, v, kpm = _on_card(attention_inputs(b, t, t, [t - (150 * i) // b
                                                        for i in range(b)],
                                             seed=10, h=4, d=d),
                            cuda_device, torch.float32)
    g = torch.randn(q.shape, device=cuda_device)
    out, m, lse = ka.flash_attention_forward(q, k, v, kpm, stats=True)
    before = ka.flash_attention.bwd_launches
    first = ka.flash_attention_backward(q, k, v, out, m, lse, g, kpm)
    for _ in range(3):
        again = ka.flash_attention_backward(q, k, v, out, m, lse, g, kpm)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    assert ka.flash_attention.bwd_launches == before + 4


# The module's route: head dims outside the kernels' contract take attend.
@pytest.mark.parametrize("d", [4, 8, 16, 72, 128, 256])
def test_head_dim_gate_follows_the_kernels_contract(d):
    """True for a multiple of 8 up to 128, the head dims ``_check`` lets
    through; false for the aux decoders' 4 (64-d, 16 heads) and the
    encoder's 256 (512-d, 2 heads), which JAX runs on its plain path."""
    assert ka.takes_head_dim(d) == (8 <= d <= 128)


# (embed_dim, heads): head_dim 4 and 256 take attend, 16 and 128 the kernel
GATE_WIDTHS = [(64, 16), (512, 2), (64, 4), (512, 4)]


def _mha(embed, heads, device, dtype, seed=0):
    from s2st_tpu_torch.nn.attention import MultiheadAttention
    torch.manual_seed(seed)
    return MultiheadAttention(embed, heads).to(device, dtype)


def _mha_by_attend(m, x, kpm, causal):
    """The module's function through the plain ``attend``, written out."""
    from s2st_tpu_torch.nn.attention import attend, causal_mask, split_heads
    from s2st_tpu_torch.nn.core import linear
    b, t, c = x.shape
    q = split_heads(linear(x, m.q_proj.weight, m.q_proj.bias) * m.scale,
                    m.num_heads)
    k = split_heads(linear(x, m.k_proj.weight, m.k_proj.bias), m.num_heads)
    v = split_heads(linear(x, m.v_proj.weight, m.v_proj.bias), m.num_heads)
    mask = causal_mask(t, x.device) if causal else None
    out, _ = attend(q, k, v, kpm, mask)
    return linear(out.reshape(b, t, c), m.out_proj.weight, m.out_proj.bias)


@pytest.mark.parametrize("embed,heads", GATE_WIDTHS)
def test_module_routes_by_head_dim_on_cpu(embed, heads, monkeypatch):
    """MultiheadAttention calls flash_attention only for a head_dim the
    kernels take, and then still matches attend."""
    from s2st_tpu_torch.nn import attention as na
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].shape[-1])
        return ka.flash_attention(*args, **kwargs)

    monkeypatch.setattr(na, "flash_attention", spy)
    m = _mha(embed, heads, "cpu", torch.float32)
    r = np.random.RandomState(8)
    x = torch.from_numpy(r.randn(2, 9, embed).astype(np.float32))
    kpm = torch.from_numpy(np.arange(9)[None, :] >= np.array([[9], [6]]))
    for causal in (False, True):
        out, _ = m(x, x, x, kpm, causal=causal)
        torch.testing.assert_close(out, _mha_by_attend(m, x, kpm, causal),
                                   atol=1e-5, rtol=1e-5)
    d = embed // heads
    assert calls == ([d, d] if ka.takes_head_dim(d) else [])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("embed,heads", GATE_WIDTHS[:2])
def test_module_takes_attend_for_head_dims_off_kernel_on_card(
        cuda_device, embed, heads, dtype, causal):
    """At head_dim 4 and 256 the module runs on the card through attend:
    no exception, no kernel launch, and attend's result; the kernel itself
    still refuses such a head_dim."""
    dt = getattr(torch, dtype)
    m = _mha(embed, heads, cuda_device, dt)
    r = np.random.RandomState(9)
    x = torch.from_numpy(r.randn(3, 21, embed).astype(np.float32)
                         ).to(cuda_device, dt)
    kpm = torch.arange(21, device=cuda_device)[None, :] >= torch.tensor(
        [[21], [13], [5]], device=cuda_device)
    before = ka.flash_attention.launches
    out, _ = m(x, x, x, kpm, causal=causal)
    ref = _mha_by_attend(m, x, kpm, causal)
    torch.cuda.synchronize()
    assert ka.flash_attention.launches == before
    assert out.dtype == dt and torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), **_tolerance(dt))
    d = embed // heads
    q = torch.zeros((3, 21, heads, d), device=cuda_device, dtype=dt)
    with pytest.raises(ValueError, match="head_dim"):
        ka.flash_attention(q, q, q, kpm)
