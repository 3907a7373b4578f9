"""s2st_tpu_torch's stage-5 training against s2st_tpu's, fp32 on the CPU.

The ``tiny_cfg`` model (aux ASR and ST decoders and CTC on) with every
dropout rate at 0, from the same JAX init, on the same batches:

- the training ``forward`` (``train=True``: postnet batch statistics and
  their running-stat update) against ``m.forward``;
- per-leaf gradients of ``s2st_loss`` against ``jax.value_and_grad``,
  mapped through the port's JAX bridge;
- three ``Trainer`` updates against the JAX ``Trainer``: parameters,
  postnet statistics, grad norm and lr; a non-finite gradient skips the
  update;
- the inverse-sqrt schedule as the JAX CLI builds it;
- the data: the port's dictionary and collate against the JAX dataset's;
- the port's train CLI on the tiny corpus, whose ``checkpoint_last.npz``
  loads in JAX and serves through the port's ``generate_waveform``.

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; gradients atol 1e-6 + rtol 1e-4 (backward sums over up to a
few hundred terms); parameters after Adam atol 1e-6 + rtol 1e-5 (each
update moves a parameter by about lr = 1e-3, and a relative gradient
error r moves Adam's step by at most lr * r / 4), except the leaves whose
gradient is 0 in exact arithmetic (attention key-projection biases,
postnet conv biases before batch norm): fp32 noise there, which Adam
scales to at most lr a step, so atol lr per update (and 0.1 lr per
earlier update for the postnet's running means, which take the conv bias
in at momentum 0.1).
"""

import argparse
import json
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
from s2st_tpu.train.trainer import create_train_state
from s2st_tpu_torch.models.jax_bridge import _to_jax, flatten_tree, jax_layout
from s2st_tpu_torch.train import losses as pl
from s2st_tpu_torch.train.optim import schedule_from_args
from s2st_tpu_torch.train.trainer import Trainer
from tests._torch_port import numpy_tree, port_model
from tests.conftest import make_batch

NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  prenet_dropout=0.0, postnet_dropout=0.0)
LOSS = dict(bce_pos_weight=5.0, label_smoothing=0.1, ctc_weight=0.3,
            asr_ce_weight=0.3, st_ce_weight=0.3)


@pytest.fixture(scope="module")
def cfg(tiny_cfg):
    return tiny_cfg.replace(**NO_DROPOUT)


def train_batch(cfg, seed, b=3):
    """A ``make_batch`` batch whose source text every row's CTC frames can
    align: an unalignable row's value is optax's log(0) = -1e5 sum, whose
    gradient keeps no fp32 digits in either package
    (tests/test_torch_losses.py holds that row's value)."""
    batch = make_batch(cfg, b=b, src_n=4, seed=seed)
    frames = jm.subsampled_length(cfg, batch["src_speech_lens"])
    for i, n in enumerate(batch["src_text_len"]):
        labels = batch["src_text"][i, :n]
        assert n + np.sum(labels[1:] == labels[:-1]) <= frames[i], seed
    return batch


def port_batch(batch):
    """numpy batch -> the port's: int64 ids and lengths, int counts."""
    out = {}
    for k, v in batch.items():
        if np.ndim(v) == 0:
            out[k] = int(v)
        elif np.issubdtype(np.asarray(v).dtype, np.integer):
            out[k] = torch.from_numpy(np.asarray(v, np.int64))
        else:
            out[k] = torch.from_numpy(np.array(v, order="C"))
    return out


def close(port, ref, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref),
                               atol=atol, rtol=rtol, err_msg=msg)


def port_leaves(model, grads=False):
    """{JAX flat key: numpy} of the model's parameters (or their grads)
    and postnet statistics, in the JAX layout."""
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    out = {}
    for name, key, kind in jax_layout(model):
        t = named[name]
        if grads:
            if not key.startswith("params"):
                continue
            t = t.grad
        out[key] = _to_jax(t, kind)
    return out


def jax_leaves(tree, prefix):
    return {f"{prefix}::{k}": np.asarray(v)
            for k, v in flatten_tree(numpy_tree(tree)).items()}


def test_forward_train_matches_jax(cfg, tiny_variables):
    batch = train_batch(cfg, seed=21)
    j = jax.jit(lambda v, bt: jm.forward(v, cfg, bt, rng=None,
                                         deterministic=True, train=True))(
        tiny_variables, batch)
    model = port_model(cfg, tiny_variables)
    with torch.no_grad():
        p = model(port_batch(batch), train=True)
    for key in ("feat_out", "post_feat_out", "eos_out", "attn",
                "ctc_logits", "asr_logits", "st_logits"):
        close(p[key], j[key], msg=key)
    assert np.array_equal(p["encoder_padding_mask"].numpy(),
                          np.asarray(j["encoder_padding_mask"]))
    new = jax_leaves(j["new_stats"]["postnet"], "postnet")
    got = {f"postnet::{k}": v
           for k, v in flatten_tree(p["new_stats"]["postnet"]).items()}
    assert set(got) == set(new)
    for key, ref in new.items():
        close(got[key].float(), ref.astype(np.float32), msg=key)


def test_loss_grads_match_jax(cfg, tiny_variables):
    batch = train_batch(cfg, seed=22)
    jlcfg = jl.LossConfig(**LOSS)

    def loss_fn(params):
        loss, ex = jl.s2st_loss({"params": params,
                                 "stats": tiny_variables["stats"]},
                                cfg, jlcfg, jax.tree_util.tree_map(
                                    jnp.asarray, batch), rng=None, train=True)
        return loss, ex["logging"]

    (j_loss, j_log), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tiny_variables["params"])
    model = port_model(cfg, tiny_variables)
    p_loss, p_ex = pl.s2st_loss(model, pl.LossConfig(**LOSS),
                                port_batch(batch), train=True)
    p_loss.backward()
    close(p_loss, j_loss)
    for key in ("l1_loss", "mse_loss", "eos_loss", "ctc_loss",
                "aux_asr_loss", "aux_st_loss"):
        close(p_ex["logging"][key], j_log[key], rtol=1e-4, msg=key)
    got = port_leaves(model, grads=True)
    ref = jax_leaves(j_grads, "params")
    assert set(got) == set(ref)
    for key, g in ref.items():
        close(torch.from_numpy(got[key]), g, atol=1e-6, rtol=1e-4, msg=key)


# leaves whose gradient is 0 in exact arithmetic: a key-projection bias
# shifts every score of a query row alike (softmax ignores it), and a
# postnet conv bias is taken out again by the batch norm's batch mean. Both
# packages hold fp32 noise there, which Adam scales up to at most lr a step.
ZERO_GRAD = re.compile(r"(::k::b|postnet::conv\d+::b)$")
# the running mean takes that conv bias in at momentum 0.1 from the next
# update on
BN_MEAN = re.compile(r"postnet::bn\d+::mean$")


def _cli_args(**kw):
    args = dict(lr="1e-3", lr_scheduler="inverse_sqrt", warmup_updates=2,
                warmup_init_lr=-1.0)
    args.update(kw)
    return argparse.Namespace(**args)


def test_three_updates_match_jax_trainer(cfg, tiny_variables):
    clip, lr = 0.125, 1e-3  # the first of the three norms is above the clip
    variables = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                       tiny_variables)
    tx = adam(betas=(0.9, 0.98))
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    # as the JAX CLI builds it: warmup_init_lr = lr (cli/train.py:108)
    j_tr = JaxTrainer(cfg, jl.LossConfig(**LOSS), tx,
                      inverse_sqrt_schedule(lr, 2, lr), mesh, clip_norm=clip)
    state = create_train_state(variables, tx)
    model = port_model(cfg, tiny_variables)
    p_tr = Trainer(model, pl.LossConfig(**LOSS),
                   schedule_from_args(_cli_args()), clip_norm=clip)
    clipped = 0
    for i in range(3):
        batch = train_batch(cfg, seed=30 + i)
        state, j_met = j_tr.train_step(state, [batch],
                                       jax.random.PRNGKey(i))
        p_met = p_tr.train_step(port_batch(batch))
        for key in ("loss", "gnorm", "lr", "sample_size"):
            assert math.isclose(p_met[key], float(j_met[key]), rel_tol=1e-4,
                                abs_tol=1e-7), (i, key)
        clipped += p_met["gnorm"] > clip
        assert p_tr.step == int(state.step) == i + 1
        ref = jax_leaves(state.params, "params")
        ref.update(jax_leaves(state.stats, "stats"))
        got = port_leaves(model)
        assert set(got) == set(ref)
        for key, r in ref.items():
            atol = lr * (i + 1) if ZERO_GRAD.search(key) \
                else 1e-6 + 0.1 * lr * i if BN_MEAN.search(key) else 1e-6
            close(torch.from_numpy(got[key]), r, atol=atol, rtol=1e-5,
                  msg=f"update {i + 1}: {key}")
    assert 0 < clipped < 3  # both sides of the clip were taken


def test_nonfinite_grad_skips_the_update(cfg, tiny_variables):
    model = port_model(cfg, tiny_variables)
    tr = Trainer(model, pl.LossConfig(**LOSS),
                 schedule_from_args(_cli_args()), clip_norm=1.0)
    before = {k: v.clone() for k, v in model.named_parameters()}
    bn0 = model.decoder.postnet.convolutions[0][1]
    stats_before = bn0.running_mean.clone()
    batch = make_batch(cfg, b=2, seed=23)
    batch["tgt_speech"] = batch["tgt_speech"] * np.inf
    met = tr.train_step(port_batch(batch))
    assert not math.isfinite(met["gnorm"])
    assert tr.step == 0 and tr.optimizer.count == 0
    for k, v in model.named_parameters():
        assert torch.equal(v, before[k]), k
    assert all(torch.count_nonzero(m) == 0 for m in tr.optimizer.mu)
    # the statistics come from the step either way, as in JAX
    assert not torch.equal(bn0.running_mean, stats_before)
    # and the next good batch takes update 1 with update 1's lr
    met = tr.train_step(port_batch(make_batch(cfg, b=2, seed=24)))
    assert tr.step == 1 and met["lr"] == schedule_from_args(_cli_args())(1)


@pytest.mark.parametrize("warmup_init_lr", [-1.0, 0.0, 2e-4])
def test_schedule_as_the_jax_cli_builds_it(warmup_init_lr):
    """A negative --warmup-init-lr (the default) holds the lr flat during
    warmup in the JAX CLI, where fairseq ramps from 0."""
    lr, warmup = 1.5e-3, 4000
    args = _cli_args(lr=str(lr), warmup_updates=warmup,
                     warmup_init_lr=warmup_init_lr)
    init = warmup_init_lr if warmup_init_lr >= 0 else lr   # cli/train.py:108
    ref = inverse_sqrt_schedule(lr, warmup_updates=warmup,
                                warmup_init_lr=init)
    port = schedule_from_args(args)
    for n in (1, 2, 100, 3999, 4000, 4001, 10000, 100000):
        assert math.isclose(port(n), float(ref(n)), rel_tol=1e-6), n
    if warmup_init_lr < 0:
        assert port(1) == port(3999) == lr


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.make_tiny_corpus import make_tiny_corpus
    return make_tiny_corpus(tmp_path_factory.mktemp("train_corpus"))


def test_dictionary_and_collate_match_jax(corpus):
    from pathlib import Path
    from s2st_tpu.data.data_cfg import S2STDataConfig as JaxDataConfig
    from s2st_tpu.data.dictionary import Dictionary as JaxDictionary
    from s2st_tpu.data.s2st_dataset import S2STDatasetCreator
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit
    dicts, jdicts = [], []
    for name in ("src_vocab.txt", "tgt_vocab.txt"):
        dicts.append(Dictionary.load(str(Path(corpus) / name)))
        jdicts.append(JaxDictionary.load(str(Path(corpus) / name)))
        assert dicts[-1].symbols == jdicts[-1].symbols
    jds = S2STDatasetCreator.from_tsv(
        str(corpus), JaxDataConfig(Path(corpus) / "config.yaml"), "train",
        *jdicts, is_train_split=True, n_frames_per_step=2)
    split = TrainSplit(str(corpus),
                       S2STDataConfig(Path(corpus) / "config.yaml"), "train",
                       *dicts, n_frames_per_step=2)
    for line in ("hola mundo", "hello unknown you", ""):
        assert np.array_equal(dicts[1].encode_line(line),
                              jdicts[1].encode_line(line))
    indices = [3, 0, 7, 5]
    ref = jds.collate([jds[i] for i in indices])
    got = split.collate_indices(indices)
    assert got["id"] == [int(i) for i in ref["id"]]
    for key in ("src_speech", "src_speech_lens", "prev_output_tokens",
                "tgt_speech", "target_lengths", "src_text", "src_text_len",
                "tgt_text", "tgt_text_len", "prev_src_text_tokens",
                "prev_tgt_text_tokens"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=1e-6,
                                   rtol=1e-6, err_msg=key)
    for key in ("ntokens", "src_txt_ntokens", "tgt_txt_ntokens",
                "nsentences"):
        assert got[key] == ref[key], key
    # every utterance in exactly one batch of each epoch, orders differ
    epochs = [split.batches(200, None, epoch) for epoch in (1, 2)]
    for batches in epochs:
        assert sorted(i for b in batches for i in b) == list(range(len(split)))
        assert all(len(b) * max(split.src_n_frames[b]) <= 200
                   for b in batches)
    assert epochs[0] != epochs[1]


TINY_FLAGS = [
    "--output-frame-dim", "8", "--n-frames-per-step", "2",
    "--encoder-layers", "2", "--decoder-layers", "2",
    "--encoder-embed-dim", "16", "--decoder-embed-dim", "16",
    "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32",
    "--encoder-attention-heads", "2", "--decoder-attention-heads", "2",
    "--conv-channels", "16", "--middle-layers", "0,1",
    "--asr-decoder-layers", "1", "--st-decoder-layers", "1",
    "--asr-decoder-embed-dim", "16", "--st-decoder-embed-dim", "16",
    "--prenet-dim", "8", "--postnet-conv-dim", "8", "--postnet-layers", "2",
    "--max-source-positions", "256", "--max-target-positions", "256",
]


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """checkpoint_last.npz of 2 updates of the port's train CLI on the
    tiny corpus, with the recipe's stage-5 flags at tiny widths."""
    from s2st_tpu_torch.cli import train
    save = tmp_path_factory.mktemp("train_cli") / "ckpt"
    argv = [str(corpus), "--config-yaml", "config.yaml", "--train-subset",
            "train", "--save-dir", str(save), "--max-tokens", "200",
            "--max-update", "2", "--task", "s2s_translation", "--criterion",
            "s2st_loss", "--arch", "s2st_transformer", "--clip-norm", "1.0",
            "--bce-pos-weight", "5.0", "--dropout", "0.1",
            "--attention-dropout", "0.1", "--activation-dropout", "0.01",
            "--encoder-normalize-before", "--decoder-normalize-before",
            "--optimizer", "adam", "--lr", "1e-3", "--lr-scheduler",
            "inverse_sqrt", "--warmup-updates", "4", "--seed", "1",
            "--update-freq", "1", "--eval-inference", "--disable-validation",
            "--label-smoothing", "0.1", "--asr-ce-weight", "0.3",
            "--st-ce-weight", "0.3", "--ctc-weight", "0.3",
            "--report-accuracy", "--log-format", "json", "--device", "cpu",
            *TINY_FLAGS]
    assert train.main(argv) == 0
    return save / "checkpoint_last.npz"


def test_train_cli_checkpoint_loads_in_jax_and_serves(corpus, trained,
                                                      tmp_path):
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu_torch.cli import generate_waveform
    from s2st_tpu_torch.models.jax_bridge import read_jax_checkpoint
    path = trained
    flat, meta = jckpt.load_checkpoint_file(str(path))
    assert meta["step"] == 2 and meta["args"]["n_frames_per_step"] == 2
    jcfg = jm.S2STConfig(
        src_vocab_size=11, tgt_vocab_size=11, input_feat_per_channel=8,
        conv_channels=16, encoder_layers=2, encoder_embed_dim=16,
        encoder_ffn_embed_dim=32, encoder_attention_heads=2,
        middle_layers=(0, 1), decoder_layers=2, decoder_embed_dim=16,
        decoder_ffn_embed_dim=32, decoder_attention_heads=2,
        output_frame_dim=8, n_frames_per_step=2, prenet_dim=8,
        postnet_layers=2, postnet_conv_dim=8, ctc=True, aux_asr=True,
        aux_st=True, asr_decoder_layers=1, asr_decoder_embed_dim=16,
        st_decoder_layers=1, st_decoder_embed_dim=16,
        max_source_positions=256, max_target_positions=256)
    template = jax.eval_shape(lambda k: jm.init_s2st(k, jcfg),
                              jax.random.PRNGKey(0))
    loaded = jckpt.load_variables_any(str(path), template=template)
    tree, _ = read_jax_checkpoint(str(path))
    ref = jax_leaves(tree["params"], "params")
    got = jax_leaves(loaded["params"], "params")
    assert set(got) == set(ref) == {k for k in flat if k.startswith("params")}
    for key, v in ref.items():
        assert np.array_equal(got[key], v), key
    count = flatten_tree(numpy_tree(loaded["stats"]))["postnet::bn0::count"]
    assert int(count) == 2

    out = tmp_path / "gen"
    assert generate_waveform.main([
        str(corpus), "--config-yaml", "config.yaml", "--gen-subset", "test",
        "--path", str(path), "--results-path", str(out), "--max-iter", "6",
        "--spec-bwd-max-iter", "2", "--dump-waveforms", "--dump-features",
        "--device", "cpu"]) == 0
    feats = sorted((out / "feat").glob("*_pred.npy"))
    assert len(feats) == 4 and len(list((out / "wav").glob("*.wav"))) == 4
    for f in feats:
        arr = np.load(f)
        assert arr.shape[1] == 8 and np.isfinite(arr).all()
    assert json.loads((out / "timing.json").read_text())


def test_train_cli_checkpoint_serves_in_jax_generate_waveform(
        corpus, trained, tmp_path):
    """The JAX package's own serving CLI reads the port's checkpoint and
    rebuilds the model from its flag echo."""
    from s2st_tpu.cli import generate_waveform as jgen
    out = tmp_path / "jax_gen"
    assert jgen.main([
        str(corpus), "--config-yaml", "config.yaml", "--gen-subset", "test",
        "--task", "s2s_translation", "--path", str(trained),
        "--results-path", str(out), "--max-iter", "6",
        "--spec-bwd-max-iter", "2", "--dump-features"]) == 0
    feats = sorted((out / "feat").glob("*_pred.npy"))
    assert len(feats) == 4
    for f in feats:
        arr = np.load(f)
        assert arr.shape[1] == 8 and np.isfinite(arr).all()


@pytest.mark.parametrize("warp", [0, 5])
def test_spec_augment_matches_jax(warp):
    """The train split's SpecAugment (the recipe config's 'ld' policy, and
    with a time warp) draws as JAX's does from the same RandomState."""
    from s2st_tpu.data.feature_transforms import SpecAugment
    from s2st_tpu_torch.data.manifest import spec_augment
    conf = {"freq_mask_N": 2, "freq_mask_F": 27, "time_mask_N": 2,
            "time_mask_T": 100, "time_mask_p": 1.0, "time_warp_W": warp}
    x = np.random.RandomState(1).randn(230, 80).astype(np.float32)
    ref = SpecAugment.from_config_dict(conf)(x, rng=np.random.RandomState(3))
    got = spec_augment(x, conf, np.random.RandomState(3))
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, x)
