"""s2st_tpu_torch's training loss against s2st_tpu's, fp32 on the CPU.

Every term of ``_composite_loss`` on the same random network outputs and
batch: masked mean, label-smoothed NLL, guided attention, the EOS BCE with
its positive weight, CTC (optax's recursion, a row that cannot be aligned
included, and its gradient) and the whole ``logging`` dict.

Tolerance: fp32 on both sides, summation order only: rtol 1e-5, atol 1e-6
(CTC's values and the gradients of its alignable rows: rtol 1e-4, sums
over the time loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from s2st_tpu.train import losses as jl
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import t
from tests.conftest import make_batch

RTOL, ATOL = 1e-5, 1e-6


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def rs():
    return np.random.RandomState(0)


def test_masked_mean(rs):
    x = rs.randn(3, 5, 4).astype(np.float32)
    mask = rs.rand(3, 5, 1) > 0.4
    close(pl.masked_mean(t(x), t(mask)), jl.masked_mean(x, mask))
    empty = np.zeros_like(mask)
    close(pl.masked_mean(t(x), t(empty)), jl.masked_mean(x, empty))


@pytest.mark.parametrize("epsilon", [0.0, 0.1])
def test_label_smoothed_nll_loss(rs, epsilon):
    lp = np.asarray(jax.nn.log_softmax(rs.randn(12, 9).astype(np.float32)))
    target = rs.randint(0, 9, size=12).astype(np.int32)
    target[[2, 7]] = pl.PAD
    j = jl.label_smoothed_nll_loss(lp, target, epsilon)
    p = pl.label_smoothed_nll_loss(t(lp), t(target), epsilon)
    for a, b in zip(p, j):
        close(a, b)


def test_guided_attention_loss(rs):
    attn = rs.rand(3, 6, 8).astype(np.float32)
    src = np.array([8, 5, 3], np.int32)
    tgt = np.array([6, 4, 1], np.int32)
    close(pl.guided_attention_loss(t(attn), t(src), t(tgt), 0.4),
          jl.guided_attention_loss(attn, src, tgt, 0.4))


def test_bce_with_logits(rs):
    logits = (rs.randn(3, 7) * 4).astype(np.float32)
    targets = (rs.rand(3, 7) > 0.7).astype(np.float32)
    mask = rs.rand(3, 7) > 0.2
    close(pl.bce_with_logits(t(logits), t(targets), 5.0, t(mask)),
          jl.bce_with_logits(logits, targets, 5.0, mask))


def _ctc_case(rs):
    """Rows: plain, a repeated label, a short label, and one whose labels
    cannot be aligned to its 3 frames."""
    b, frames, n, v = 4, 9, 5, 7
    logits = rs.randn(b, frames, v).astype(np.float32)
    logit_lens = np.array([9, 8, 6, 3], np.int32)
    labels = np.full((b, n), pl.PAD, np.int32)
    label_lens = np.array([4, 3, 2, 5], np.int32)
    for i, ln in enumerate(label_lens):
        labels[i, :ln] = rs.randint(2, v, size=ln)
    labels[1, :3] = [4, 4, 5]
    return logits, logit_lens, labels, label_lens


def test_ctc_matches_optax_including_an_unalignable_row(rs):
    logits, logit_lens, labels, label_lens = _ctc_case(rs)
    logit_pad = (np.arange(logits.shape[1])[None, :]
                 >= logit_lens[:, None]).astype(np.float32)
    label_pad = (np.arange(labels.shape[1])[None, :]
                 >= label_lens[:, None]).astype(np.float32)

    def ref(lg):
        return optax.ctc_loss(lg, logit_pad, labels, label_pad, blank_id=0)

    j_val = ref(jnp.asarray(logits))
    j_grad = jax.grad(lambda lg: jnp.sum(ref(lg)))(jnp.asarray(logits))
    lg = t(logits).requires_grad_()
    p_val = pl.ctc_loss(lg, t(logit_lens), t(labels), t(label_lens))
    p_val.sum().backward()
    # the unalignable row: large and finite in both, where F.ctc_loss
    # would give inf
    assert 1e4 < float(j_val[3]) < 1e7 and np.isfinite(p_val[3].item())
    assert np.isinf(torch.nn.functional.ctc_loss(
        torch.log_softmax(t(logits)[3:4], -1).transpose(0, 1), t(labels)[3:4],
        t(logit_lens)[3:4], t(label_lens)[3:4], reduction="none")[0].item())
    close(p_val, j_val, rtol=1e-4, atol=1e-4)
    # the gradient of the alignable rows (the unalignable row's sums near
    # -1e5 keep no fp32 digits of its gradient in either package)
    close(lg.grad[:3], j_grad[:3], rtol=1e-4, atol=1e-5)


def _net_and_batch(rs, cfg, b=3):
    batch = make_batch(cfg, b=b, src_t=20, tgt_t=11, src_n=6, tgt_n=7, seed=5)
    tt, ts = batch["tgt_speech"].shape[1], 5
    enc_lens = np.array([5, 4, 2][:b], np.int32)
    net = {
        "feat_out": rs.randn(b, tt, cfg.out_dim).astype(np.float32),
        "post_feat_out": rs.randn(b, tt, cfg.out_dim).astype(np.float32),
        "eos_out": rs.randn(b, tt, 1).astype(np.float32),
        "attn": rs.dirichlet(np.ones(ts), size=(b, tt)).astype(np.float32),
        "encoder_out_lengths": enc_lens,
        "encoder_padding_mask": np.arange(ts)[None, :] >= enc_lens[:, None],
        "ctc_logits": rs.randn(b, ts, cfg.src_vocab_size).astype(np.float32),
        "asr_logits": rs.randn(b, 6, cfg.src_vocab_size).astype(np.float32),
        "st_logits": rs.randn(b, 7, cfg.tgt_vocab_size).astype(np.float32),
        "new_stats": {},
    }
    return net, batch


@pytest.mark.parametrize("sentence_avg", [False, True])
def test_composite_loss_and_logging(rs, tiny_cfg, sentence_avg):
    kw = dict(bce_pos_weight=5.0, use_guided_attention_loss=True,
              label_smoothing=0.1, ctc_weight=0.3, asr_ce_weight=0.3,
              st_ce_weight=0.3, sentence_avg=sentence_avg)
    net, batch = _net_and_batch(rs, tiny_cfg)
    j_loss, j_ex = jl._composite_loss(
        {k: v if k == "new_stats" else jnp.asarray(v) for k, v in net.items()},
        tiny_cfg, jl.LossConfig(**kw), batch)
    p_batch = {k: t(v) if isinstance(v, np.ndarray) else int(v)
               for k, v in batch.items()}
    p_net = {k: t(v) if isinstance(v, np.ndarray) else v
             for k, v in net.items()}
    p_loss, p_ex = pl.composite_loss(p_net, pl.LossConfig(**kw), p_batch)
    close(p_loss, j_loss)
    assert set(p_ex["logging"]) == set(j_ex["logging"])
    for key, ref in j_ex["logging"].items():
        close(torch.as_tensor(p_ex["logging"][key]).float(),
              np.float32(ref), rtol=1e-4 if "ctc" in key else RTOL)
    assert int(p_ex["sample_size"]) == int(j_ex["sample_size"])
    assert float(j_ex["logging"]["ctc_loss"]) > 0
