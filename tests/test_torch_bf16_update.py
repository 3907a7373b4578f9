"""One bf16 training update at the recipe's widths, s2st_tpu_torch against
s2st_tpu on the CPU.

The recipe trains under --fp16 (bf16 compute, fp32 master weights), and
the other trainer tests compute in fp32. Here both packages compute in
bf16 (JAX's ``cfg.dtype=bfloat16``, the port's ``torch.bfloat16``) with
the recipe's widths (recipes/run_baseline.sh:30-51: 512-d, 4 heads, FFN
2048, 1024 conv channels, prenet 32, 4 frames a step, 1-layer 64-d aux
decoders, CE weights 0.3, CTC off, label smoothing 0.1) cut to 1 + 1
layers with both taps at layer 0, dropout off, on 3 utterances of 120-240
source frames, from one seeded init carried across by the port's
bridge (``jax_variables``). One
update goes through each package's trainer (inverse-sqrt lr 1.5e-3, clip
1.0): JAX's grad and apply steps, the port's ``Trainer.train_step``; each
package's raw gradients come from its own loss function's backward on the
same batch.

Tolerances. bf16 keeps 8 bits of mantissa, and the two packages round at
different places (XLA fuses elementwise bf16 ops and keeps fp32 between
them, PyTorch rounds after each op; products sum in another order), so
activations differ by a few bf16 ulps; through ReLU masks and batch
statistics over 3 utterances the gradients differ by about as much as
each package's bf16 gradients differ from fp32 ones. Measured (CPU, this
batch) in brackets:
- the loss within 2e-3 relative (8e-5), the gradient norm within 1e-2
  (7e-4), and the clip does not act;
- the whole gradient within 3e-2 in relative L2 norm (1.6e-2), and no
  further from the port's fp32 gradient on the same weights than 1.5x
  JAX's bf16 gradient is (1.04x);
- each leaf's gradient within 0.15 of its L2 norm (at most 0.084, the
  prenet's first weight); leaves whose gradient is 0 in exact arithmetic
  (key-projection biases; postnet conv biases before batch norm) hold
  bf16 noise, within 1e-3 of the largest gradient element (2.6e-4);
- the parameters after the update: Adam's first step moves each by about
  lr times the sign of its gradient, so every element within 2 lr + 1e-6;
  elements whose gradient bf16 leaves near 0 may move the other way
  (|difference| > lr): at most 8 % of a leaf (3.1 %) and 2 % of all
  (0.85 %), and none where JAX's gradient is above 20 % of its leaf's
  largest (there the two differ by under lr / 2).

This check cannot show the bf16 scale rounding (``nn.core.scaled``): with
the scales applied in fp32 its numbers move by less than their noise
(tests/test_torch_bf16_scales.py holds that rounding bit for bit).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.parallel.mesh import make_mesh
from s2st_tpu.train import losses as jl
from s2st_tpu.train.optim import adam, inverse_sqrt_schedule
from s2st_tpu.train.trainer import Trainer as JaxTrainer
from s2st_tpu.train.trainer import (create_train_state, merge_params,
                                    partition_params)
from s2st_tpu_torch.models.jax_bridge import jax_variables
from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
from s2st_tpu_torch.train import losses as pl
from s2st_tpu_torch.train.optim import inverse_sqrt_schedule as port_schedule
from s2st_tpu_torch.train.trainer import Trainer
from tests._torch_port import port_cfg
from tests.conftest import make_batch
from tests.test_torch_train import jax_leaves, port_batch, port_leaves

LOSS = dict(bce_pos_weight=5.0, label_smoothing=0.1, ctc_weight=0.0,
            asr_ce_weight=0.3, st_ce_weight=0.3)
LR, CLIP = 1.5e-3, 1.0
# gradients that are 0 in exact arithmetic: a key-projection bias shifts a
# query row's scores alike, a postnet conv bias is taken out by the batch
# norm's batch mean
ZERO_GRAD = re.compile(r"(::k::b|postnet::conv\d+::b)$")


def recipe_cfg():
    return jm.S2STConfig(
        src_vocab_size=60, tgt_vocab_size=200, input_feat_per_channel=80,
        conv_kernel_sizes=(5, 5), conv_channels=1024,
        encoder_layers=1, encoder_embed_dim=512, encoder_ffn_embed_dim=2048,
        encoder_attention_heads=4, encoder_normalize_before=True,
        middle_layers=(0, 0),
        decoder_layers=1, decoder_embed_dim=512, decoder_ffn_embed_dim=2048,
        decoder_attention_heads=4, decoder_normalize_before=True,
        output_frame_dim=80, n_frames_per_step=4, prenet_dim=32,
        aux_asr=True, aux_st=True, ctc=False,
        asr_decoder_layers=1, asr_decoder_embed_dim=64,
        st_decoder_layers=1, st_decoder_embed_dim=64,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        prenet_dropout=0.0, postnet_dropout=0.0,
        max_source_positions=3000, max_target_positions=1024,
        dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def update():
    """(JAX, port) results of one update: loss, gnorm, raw gradients and
    parameters after it, as {JAX flat key: numpy}."""
    cfg = recipe_cfg()
    model = S2STTransformer(port_cfg(cfg, dtype=torch.bfloat16)
                            ).init_weights(3).train()
    variables = jax.tree_util.tree_map(jnp.asarray, jax_variables(model))
    before = jax_leaves(variables["params"], "params")
    batch = make_batch(cfg, b=3, src_t=240, tgt_t=48, src_n=24, tgt_n=12,
                       seed=5)
    assert batch["src_speech_lens"].min() >= 120

    # JAX: the trainer's grad step and apply step (train_step's path)
    tx = adam(betas=(0.9, 0.98))
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    j_tr = JaxTrainer(cfg, jl.LossConfig(**LOSS), tx,
                      inverse_sqrt_schedule(LR, 4000, LR), mesh,
                      clip_norm=CLIP)
    state = create_train_state(variables, tx)
    j_tr._build(state)
    grads, _, logging, ss = j_tr._grad_steps[None](
        state.params, state.stats, j_tr._device_batch(batch),
        jax.random.PRNGKey(0), state.step)
    diff, nondiff = partition_params(state.params)
    new_diff, _, _, gnorm, _ = j_tr._apply_step(
        diff, state.opt_state, state.step, grads, ss, jnp.float32(1.0))
    jax_out = {"loss": float(logging["loss"]), "gnorm": float(gnorm),
               "grads": jax_leaves(grads, "params"),
               "params": jax_leaves(merge_params(new_diff, nondiff),
                                    "params")}

    # the port: the loss's backward for the gradients (and in fp32 on the
    # same weights), then one update
    pb = port_batch(batch)
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        m = model if dtype == torch.bfloat16 else S2STTransformer(
            port_cfg(cfg)).init_weights(3).train()
        loss, _ = pl.s2st_loss(m, pl.LossConfig(**LOSS), pb, train=True)
        loss.backward()
        for param in m.parameters():  # a leaf the loss does not reach
            if param.grad is None:
                param.grad = torch.zeros_like(param)
        grads[dtype] = port_leaves(m, grads=True)
    model.zero_grad(set_to_none=True)
    tr = Trainer(model, pl.LossConfig(**LOSS), port_schedule(LR, 4000, LR),
                 clip_norm=CLIP)
    met = tr.train_step(pb)
    port_params = {k: v for k, v in port_leaves(model).items()
                   if k.startswith("params")}
    return jax_out, {"loss": met["loss"], "gnorm": met["gnorm"],
                     "grads": grads[torch.bfloat16], "params": port_params,
                     "first_loss": float(loss.detach()),
                     "fp32_grads": grads[torch.float32], "before": before}


def _l2(x):
    return float(np.linalg.norm(x))


def _tree(leaves, keys):
    return np.concatenate([leaves[k].ravel() for k in keys])


def test_loss_and_grad_norm(update):
    j, p = update
    assert p["first_loss"] == p["loss"]      # the same forward twice
    assert math.isclose(p["loss"], j["loss"], rel_tol=2e-3)
    assert math.isclose(p["gnorm"], j["gnorm"], rel_tol=1e-2)
    assert p["gnorm"] < CLIP             # the clip did not act


def test_gradients(update):
    j, p = update
    assert set(p["grads"]) == set(j["grads"]) == set(p["fp32_grads"])
    real = [k for k in j["grads"] if not ZERO_GRAD.search(k)]
    ref = _tree(j["grads"], real)
    got = _tree(p["grads"], real)
    fp32 = _tree(p["fp32_grads"], real)
    assert _l2(got - ref) <= 3e-2 * _l2(ref)
    assert _l2(got - fp32) <= 1.5 * _l2(ref - fp32)
    g_max = max(float(np.abs(g).max()) for g in j["grads"].values())
    for key, ref in j["grads"].items():
        err = p["grads"][key].astype(np.float32) - ref
        if ZERO_GRAD.search(key):
            assert float(np.abs(err).max()) <= 1e-3 * g_max, key
        else:
            assert _l2(err) <= 0.15 * _l2(ref) + 1e-12, (key, _l2(err),
                                                         _l2(ref))


def test_parameters_after_the_update(update):
    j, p = update
    assert set(p["params"]) == set(j["params"])
    flipped = total = 0
    for key, ref in j["params"].items():
        diff = np.abs(p["params"][key].astype(np.float32) - ref)
        assert float(diff.max()) <= 2 * LR + 1e-6, key
        if ZERO_GRAD.search(key):
            continue
        g = np.abs(j["grads"][key])
        flip = diff > LR
        assert flip.mean() <= 0.08, (key, flip.mean())
        assert float(diff[g > 0.2 * g.max()].max(initial=0.0)) < LR / 2, key
        flipped += int(flip.sum())
        total += flip.size
        if g.max() > 0:    # the update happened (a leaf off the loss: 0)
            moved = np.abs(ref - p["before"][key])
            assert float(moved.max()) > 0.5 * LR, key
    assert flipped <= 0.02 * total
