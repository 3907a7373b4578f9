"""s2st_tpu_torch's HuBERT waveform frontend against s2st_tpu's, on the CPU.

The same inputs, from seeded numpy, through both packages, dropout off:

- ``extract_features`` of a tiny frontend (3 convs of 16 channels, 2
  layers of 16-d, 2 heads, pos_conv k=8 in 2 groups, as
  ``tests/test_hubert.py``) on three rows of 1600, 1200 and 650 samples:
  outputs and ``out_lengths``, in fp32 and in bf16;
- the fairseq ``.pt`` import: one file with ``weight_g``/``weight_v`` and a
  plain-dict ``cfg``, read by the port and by JAX's ``load_torch_hubert``
  into equal leaves; the same file's trunk against the torch oracle of
  ``tests/test_hubert.py``; a ``cfg`` pickled from a module that is not
  installed (as omegaconf's DictConfig is on the card's machine);
- ``S2STTransformer`` with ``use_hubert``: ``encode`` and ``forward`` on a
  (B, L) batch; the frontend gets no gradient and the encoder does; one
  ``Trainer`` update leaves the frontend as it was (Adam's moments 0), and
  with weight decay moves it as JAX's decayed weights do;
- the data path: one epoch of the train split of a waveform corpus (a
  ``src_orig`` column, SpecAugment on the targets) batches, pads and
  collates to JAX's arrays;
- the CLIs on that corpus: the port's and JAX's ``train --use-hubert True
  --load-pretrained-hubert-from`` for 2 updates from one init (losses per
  update, the validation's values, final state), the frontend unchanged;
  each package reads the other's ``checkpoint_last.npz``; the port's
  ``--eval-inference`` validation over waveform batches; ``generate_waveform`` and
  ``generate_for_s2st --scoring wer`` with ``--use-hubert True`` give
  JAX's features and lines.

Tolerances. fp32: atol 1e-5 + rtol 1e-5 (sums in another order). bf16: both
packages cast the waveform to bf16 before the first convolution and take
the GroupNorm in bf16, then compute in fp32 (the GroupNorm's fp32 affine
promotes, in JAX as in the port); outputs agree within atol 1e-3 (measured
2.4e-6: both round the same values), against a difference of more than 1e-2
from the fp32 path. The CLI losses and validation values: JAX logs them
rounded to 4 decimals, so atol 1e-4; the final state as ``tests/test_torch_train_runtime.py`` holds
it, with the parameters within 1e-5 (see the test).
"""

import contextlib
import csv
import io
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from s2st_tpu.models import hubert as jh
from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu_torch.models import hubert as ph
from s2st_tpu_torch.models.jax_bridge import (flatten_tree, jax_variables,
                                              load_jax_variables,
                                              read_jax_checkpoint)
from tests._torch_port import numpy_tree, port_model, t

TINY = dict(conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
            encoder_layers=2, encoder_embed_dim=16, encoder_ffn_embed_dim=32,
            encoder_attention_heads=2, conv_pos=8, conv_pos_groups=2)
ATOL, RTOL = 1e-5, 1e-5
BF16_ATOL = 1e-3
LENGTHS = np.array([1600, 1200, 650], np.int32)


class Holder(nn.Module):
    """A frontend under ``encoder.hubert``, where the JAX bridge maps it."""

    def __init__(self, cfg):
        super().__init__()
        self.encoder = nn.Module()
        self.encoder.hubert = ph.HubertModel(cfg)


def port_frontend(params, dtype=torch.float32) -> ph.HubertModel:
    holder = Holder(ph.HubertConfig(dtype=dtype, **TINY))
    load_jax_variables(holder, {"params": {"hubert": numpy_tree(params)},
                                "stats": {}})
    return holder.encoder.hubert.eval()


def waveforms(seed=0, lengths=LENGTHS):
    r = np.random.RandomState(seed)
    src = (r.randn(len(lengths), int(lengths.max())) * 0.1).astype(np.float32)
    for i, n in enumerate(lengths):
        src[i, n:] = 0.0
    return src


@pytest.fixture(scope="module")
def jax_params():
    return jh.init_hubert(jax.random.PRNGKey(0), jh.HubertConfig(**TINY))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_features_matches_jax(jax_params, dtype):
    src = waveforms()
    ref, ref_lens = jh.extract_features(
        jax_params, jh.HubertConfig(dtype=getattr(jnp, dtype), **TINY),
        jnp.asarray(src), jnp.asarray(LENGTHS))
    model = port_frontend(jax_params, getattr(torch, dtype))
    with torch.no_grad():
        got, lens = model.extract_features(t(src), t(LENGTHS).long())
    assert lens.tolist() == np.asarray(ref_lens).tolist() == [79, 59, 32]
    # past the GroupNorm both compute in fp32 (the affine promotes)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    ref = np.asarray(ref)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=BF16_ATOL, rtol=0)
        with torch.no_grad():
            fp32, _ = port_frontend(jax_params).extract_features(
                t(src), t(LENGTHS).long())
        assert np.abs(fp32.numpy() - got.numpy()).max() > 1e-2


def test_output_length_is_jax_formula():
    cfg, jcfg = ph.HubertConfig(), jh.HubertConfig()
    for n in (0, 399, 400, 16000, 160000, 123457):
        assert cfg.output_length(n) == jcfg.output_length(n)
    assert cfg.output_length(160000) == 499
    lens = torch.tensor([0, 400, 16000])
    assert cfg.output_length(lens).tolist() == [
        jcfg.output_length(n) for n in (0, 400, 16000)]


# --------------------------------------------------------------------------
# the fairseq checkpoint
# --------------------------------------------------------------------------

def _cfg_dict(conv_layers, d, layers, ffn, heads, conv_pos, groups):
    spec = "[" + ", ".join(f"({a}, {b}, {c})" for a, b, c in conv_layers) \
        + "]"
    return {"model": {"conv_feature_layers": spec, "encoder_layers": layers,
                      "encoder_embed_dim": d, "encoder_ffn_embed_dim": ffn,
                      "encoder_attention_heads": heads, "conv_pos": conv_pos,
                      "conv_pos_groups": groups, "layer_norm_first": False}}


@pytest.fixture(scope="module")
def oracle_pt(tmp_path_factory):
    """tests/test_hubert.py's torch oracle saved in fairseq's layout
    (weight_g/weight_v, split q/k/v) with the pretraining leaves and a
    plain-dict cfg."""
    from tests.test_hubert import CFG, TorchOracle, _fairseq_state_dict
    torch.manual_seed(0)
    oracle = TorchOracle(CFG).eval()
    sd = _fairseq_state_dict(oracle)
    d = CFG.encoder_embed_dim
    sd["mask_emb"] = torch.rand(d)
    sd["label_embs_concat"] = torch.rand(5, 4)
    sd["final_proj.weight"] = torch.randn(4, d)
    sd["final_proj.bias"] = torch.zeros(4)
    path = tmp_path_factory.mktemp("pt") / "hubert_tiny.pt"
    torch.save({"model": sd, "cfg": _cfg_dict(
        CFG.conv_layers, d, CFG.encoder_layers, CFG.encoder_ffn_embed_dim,
        CFG.encoder_attention_heads, CFG.conv_pos, CFG.conv_pos_groups)},
        str(path))
    return path, oracle


def test_pt_import_matches_jax(oracle_pt):
    path, oracle = oracle_pt
    sd, cfg = ph.load_torch_hubert(str(path))
    jparams, jcfg = jh.load_torch_hubert(str(path))
    assert cfg == ph.HubertConfig(**TINY)
    for name in TINY:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    holder = Holder(cfg)
    # the pretraining leaves ride along, as in JAX's tree
    holder.encoder.hubert.carry_pretraining(
        {k: tuple(v.shape) for k, v in sd.items()})
    holder.encoder.hubert.load_state_dict(sd, strict=True)
    got = flatten_tree(jax_variables(holder)["params"]["hubert"])
    ref = flatten_tree(numpy_tree(jparams))
    assert set(got) == set(ref)
    assert {"mask_emb", "final_proj::w", "final_proj::b", "label_embs"} \
        <= set(got)
    for key, v in got.items():
        # the weight-norm fold: the same fp32 ops, summed in another order
        tol = 1e-6 if key.startswith("pos_conv") else 0.0
        np.testing.assert_allclose(v, ref[key], atol=tol, rtol=tol,
                                   err_msg=key)
    # and the trunk computes what the torch oracle computes
    src = waveforms(seed=1)
    with torch.no_grad():
        want, want_lens = oracle.extract(t(src), t(LENGTHS).long())
        out, lens = holder.encoder.hubert.extract_features(
            t(src), t(LENGTHS).long())
    assert lens.tolist() == want_lens.tolist()
    for row, n in enumerate(lens.tolist()):
        np.testing.assert_allclose(out[row, :n].numpy(),
                                   want[row, :n].numpy(), atol=2e-4)


FAKE_OMEGACONF = '''
class Node:
    def __init__(self, val):
        self._val = val

    def __getstate__(self):
        return {"_val": self._val, "_parent": None}


class DictConfig:
    def __init__(self, content):
        self._content = {k: DictConfig(v) if isinstance(v, dict) else Node(v)
                         for k, v in content.items()}

    def __getstate__(self):
        return {"_content": self._content, "_metadata": Node(None),
                "_parent": None}
'''


def test_pt_cfg_from_a_module_that_is_not_installed(oracle_pt, tmp_path,
                                                    monkeypatch):
    """fairseq pickles its cfg as omegaconf's DictConfig; the card's
    machine has no omegaconf. A cfg of such a shape, pickled from a module
    that is then removed, still gives the checkpoint's config."""
    path, _ = oracle_pt
    state = torch.load(str(path), weights_only=False)
    (tmp_path / "fake_omegaconf_mod.py").write_text(FAKE_OMEGACONF)
    monkeypatch.syspath_prepend(str(tmp_path))
    import fake_omegaconf_mod
    plain = state["cfg"]["model"]
    big = dict(plain, encoder_layers=7, conv_feature_layers="[(512, 10, 5)]"
               " + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2")
    state["cfg"] = fake_omegaconf_mod.DictConfig({"model": big})
    ckpt = tmp_path / "omega.pt"
    torch.save(state, str(ckpt))
    monkeypatch.delitem(sys.modules, "fake_omegaconf_mod")
    monkeypatch.setattr(sys, "path", [p for p in sys.path
                                      if p != str(tmp_path)])
    with pytest.raises(ModuleNotFoundError):
        torch.load(str(ckpt), weights_only=False)
    cfg = ph.config_from_torch_ckpt(str(ckpt))
    assert cfg.encoder_layers == 7 and cfg.conv_layers == ph.BASE_CONV_LAYERS
    assert cfg.encoder_embed_dim == plain["encoder_embed_dim"]


# --------------------------------------------------------------------------
# the S2ST model with the frontend
# --------------------------------------------------------------------------

S2ST_TINY = dict(
    src_vocab_size=10, tgt_vocab_size=10, input_feat_per_channel=8,
    conv_kernel_sizes=(5,), conv_channels=16, encoder_layers=1,
    encoder_embed_dim=16, encoder_ffn_embed_dim=32,
    encoder_attention_heads=2, decoder_layers=1, decoder_embed_dim=16,
    decoder_ffn_embed_dim=32, decoder_attention_heads=2,
    output_frame_dim=8, prenet_layers=1, prenet_dim=8, prenet_dropout=0.0,
    postnet_layers=1, postnet_conv_dim=8, middle_layers=(), ctc=False,
    aux_asr=False, aux_st=False, use_hubert=True, hubert_hidden=16,
    max_source_positions=128, max_target_positions=64, dropout=0.0,
    attention_dropout=0.0, activation_dropout=0.0, postnet_dropout=0.0)


@pytest.fixture
def s2st(monkeypatch):
    """(JAX cfg, JAX variables, port model with them) with the tiny
    frontend patched into both packages, as tests/test_hubert.py does."""
    monkeypatch.setattr(jh, "HubertConfig", lambda **kw: _JAX_TINY)
    monkeypatch.setattr(ph, "frontend_config",
                        lambda cfg: ph.HubertConfig(dtype=cfg.dtype, **TINY))
    cfg = jm.S2STConfig(dtype=jnp.float32, **S2ST_TINY)
    variables = jm.init_s2st(jax.random.PRNGKey(0), cfg)
    return cfg, variables, port_model(cfg, variables)


_JAX_TINY = jh.HubertConfig(**TINY)


def s2st_batch(seed=0):
    r = np.random.RandomState(seed)
    return {"src_speech": waveforms(seed, LENGTHS[:2]),
            "src_speech_lens": LENGTHS[:2].copy(),
            "prev_output_tokens": r.randn(2, 9, 8).astype(np.float32),
            "target_lengths": np.array([9, 7], np.int32),
            "tgt_speech": r.randn(2, 9, 8).astype(np.float32)}


def test_s2st_with_hubert_matches_jax(s2st):
    cfg, variables, model = s2st
    assert "hubert" in variables["params"]
    b = s2st_batch()
    ref_enc = jm.encode(variables, cfg, jnp.asarray(b["src_speech"]),
                        jnp.asarray(b["src_speech_lens"]))
    ref = jm.forward(variables, cfg, b, deterministic=True)
    pb = {k: t(v) for k, v in b.items()}
    for k in ("src_speech_lens", "target_lengths"):
        pb[k] = pb[k].long()
    with torch.no_grad():
        enc = model.encode(pb["src_speech"], pb["src_speech_lens"])
        out = model(pb)
    assert enc["out_lengths"].tolist() == \
        np.asarray(ref_enc["out_lengths"]).tolist()
    np.testing.assert_allclose(enc["encoder_out"].numpy(),
                               np.asarray(ref_enc["encoder_out"]),
                               atol=ATOL, rtol=RTOL)
    for key in ("feat_out", "post_feat_out", "eos_out"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)
    # the frozen frontend gets no gradient, the encoder does
    loss = model(pb)["feat_out"].float().pow(2).sum()
    loss.backward()
    assert all(p.grad is None for p in model.encoder.hubert.parameters())
    enc_grads = [p.grad for n, p in model.encoder.named_parameters()
                 if not n.startswith("hubert.")]
    assert sum(float(g.abs().sum()) for g in enc_grads if g is not None) > 0


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_trainer_keeps_the_frontend_frozen(s2st, weight_decay):
    """One update: the frontend's gradients count as zeros (Adam's moments
    stay 0); without weight decay it is bit-unchanged, with it each leaf
    is decayed by lr * wd as JAX's decayed weights decay it."""
    from s2st_tpu_torch.train.losses import LossConfig
    from s2st_tpu_torch.train.trainer import Trainer
    _, _, model = s2st
    model.train()
    before = {n: p.detach().clone()
              for n, p in model.encoder.hubert.named_parameters()}
    lr = 1e-3
    trainer = Trainer(model, LossConfig(), lambda step: lr,
                      weight_decay=weight_decay)
    b = s2st_batch(seed=2)
    batch = {k: t(v) for k, v in b.items()}
    for k in ("src_speech_lens", "target_lengths"):
        batch[k] = batch[k].long()
    batch["src_text"] = batch["tgt_text"] = torch.ones((2, 3), dtype=torch.long)
    metrics = trainer.train_step(batch)
    assert np.isfinite(metrics["loss"]) and metrics["gnorm"] > 0
    names = [n for n, _ in model.named_parameters()]
    for i, name in enumerate(names):
        if not name.startswith("encoder.hubert."):
            continue
        p = model.get_parameter(name)
        assert not trainer.optimizer.mu[i].any()
        assert not trainer.optimizer.nu[i].any()
        old = before[name[len("encoder.hubert."):]]
        if weight_decay == 0.0:
            assert torch.equal(p, old), name
        else:
            torch.testing.assert_close(p, old * (1 - lr * weight_decay),
                                       atol=1e-7, rtol=1e-6)


# --------------------------------------------------------------------------
# the data path and the CLIs on a waveform corpus
# --------------------------------------------------------------------------

def wave_corpus(root):
    """make_tiny_corpus with source WAVs, moved to a ``src_orig`` column
    (``src_audio`` then names a feature file the frontend never reads),
    and SpecAugment on both sides of the train split, which the waveform
    source must skip."""
    from tests.make_tiny_corpus import make_tiny_corpus
    from tests.test_torch_iterators import SPECAUGMENT
    corpus = make_tiny_corpus(root, src_wav=True)
    for split in ("train", "dev", "test"):
        tsv = corpus / f"{split}.tsv"
        with open(tsv, encoding="utf-8") as f:
            rows = list(csv.DictReader(f, delimiter="\t",
                                       quoting=csv.QUOTE_NONE))
        for row in rows:
            row["src_orig"], row["src_audio"] = row["src_audio"], \
                row["tgt_audio"]
        with open(tsv, "w", newline="", encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t",
                               quoting=csv.QUOTE_NONE)
            w.writeheader()
            w.writerows(rows)
    cfg = (corpus / "config.yaml").read_text()
    cfg = cfg[:cfg.index("tgt_transforms:")] + SPECAUGMENT + \
        cfg[cfg.index("tgt_global_cmvn:\n  stats_npz_path"):]
    (corpus / "config.yaml").write_text(cfg)
    return corpus


def test_waveform_batches_match_jax(tmp_path):
    """One epoch of the train split: the batches, their static pads (the
    time pad counts samples) and every collated array equal JAX's."""
    from s2st_tpu.data import iterators as jit_
    from s2st_tpu.data.data_cfg import S2STDataConfig as JaxDataConfig
    from s2st_tpu.data.dictionary import Dictionary as JaxDictionary
    from s2st_tpu.data.s2st_dataset import S2STDatasetCreator
    from s2st_tpu_torch.data import iterators as pit
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit
    from tests.test_torch_iterators import assert_batch_equal
    corpus = wave_corpus(tmp_path / "corpus")
    jcfg = JaxDataConfig(corpus / "config.yaml")
    jcfg.set_use_hubert(True)
    pcfg = S2STDataConfig(corpus / "config.yaml")
    pcfg.set_use_hubert(True)
    names = ("src_vocab.txt", "tgt_vocab.txt")
    jds = S2STDatasetCreator.from_tsv(
        str(corpus), jcfg, "train",
        *[JaxDictionary.load(str(corpus / f)) for f in names],
        is_train_split=True, n_frames_per_step=2)
    split = TrainSplit(str(corpus), pcfg, "train",
                       *[Dictionary.load(str(corpus / f)) for f in names],
                       n_frames_per_step=2)
    kw = dict(max_tokens=200, seed=1, required_batch_size_multiple=8)
    got = list(pit.EpochBatchIterator(split, **kw).next_epoch_itr())
    ref = list(jit_.EpochBatchIterator(jds, **kw).next_epoch_itr())
    assert len(got) == len(ref) > 1
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g["src_speech"].dim() == 2, "a (B, L) waveform source"
        assert g["src_speech"].shape[1] % 16 == 0      # snap_len of samples
        assert_batch_equal(g, r, msg=f"batch {i}")
    wav = split.source(0)
    assert wav.ndim == 1 and 0 < np.abs(wav).max() <= 1.0


HUBERT_FLAGS = ["--use-hubert", "True", "--hubert-hidden", "16",
                "--hubert-layers", "1", "--hubert-ffn", "32",
                "--hubert-heads", "2"]


def frontend_pt(path, seed=11):
    """A hubert-base-spec frontend of the HUBERT_FLAGS widths in fairseq's
    layout: pos_conv as weight_g/weight_v, a pretraining leaf, a plain
    cfg. Returns the trunk the file holds."""
    cfg = ph.HubertConfig(encoder_embed_dim=16, encoder_layers=1,
                          encoder_ffn_embed_dim=32, encoder_attention_heads=2)
    model = ph.HubertModel(cfg).init_weights(
        torch.Generator().manual_seed(seed))
    sd = dict(model.state_dict())
    w = sd.pop("encoder.pos_conv.0.weight")
    g = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv.0.weight_g"] = g
    sd["encoder.pos_conv.0.weight_v"] = w * 3.0
    sd["mask_emb"] = torch.rand(16)
    torch.save({"model": sd, "cfg": _cfg_dict(
        cfg.conv_layers, 16, 1, 32, 2, cfg.conv_pos, cfg.conv_pos_groups)},
        str(path))
    return ph.load_torch_hubert(str(path))[0]


@pytest.fixture(scope="module")
def hubert_cli(tmp_path_factory):
    """The waveform corpus, a fairseq .pt of the frontend and an init
    checkpoint (port-initialised, its frontend the .pt's, the flag echo of
    the CLI runs below)."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    root = tmp_path_factory.mktemp("hubert_cli")
    corpus = wave_corpus(root / "corpus")
    pt = root / "hubert.pt"
    trunk = frontend_pt(pt)
    args = train.get_parser().parse_args(
        [str(corpus), *TRAIN_FLAGS, "--load-pretrained-hubert-from", str(pt)])
    model = S2STTransformer(model_config(args, 11, 11, 8)).init_weights(5)
    model.encoder.hubert.carry_pretraining(
        {k: tuple(v.shape) for k, v in trunk.items()})
    model.encoder.hubert.load_state_dict(trunk, strict=True)
    init = root / "init.npz"
    write_jax_checkpoint(str(init), model, {"args": train.args_echo(args)})
    return corpus, pt, init, trunk, root


def _train_flags():
    """The recipe's stage-5 flags at tiny widths with dropout off, and no
    CTC: the frontend's 320x and the subsampler's 4x leave 3-6 frames of
    these 0.2-0.5 s utterances, too few to align their phones, and an
    unalignable row's loss of 1e5 scale drowns the comparison in noise."""
    from tests.test_torch_train import TINY_FLAGS
    return [
        "--config-yaml", "config.yaml", "--train-subset", "train",
        "--task", "s2s_translation", "--criterion", "s2st_loss",
        "--arch", "s2st_transformer", "--max-tokens", "200",
        "--batch-size", "4", "--max-update", "2", "--clip-norm", "1.0",
        "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt",
        "--warmup-updates", "4", "--seed", "1", "--valid-subset", "dev",
        "--log-interval", "1", "--log-format", "json", "--dropout", "0",
        "--attention-dropout", "0", "--activation-dropout", "0",
        "--prenet-dropout", "0", "--postnet-dropout", "0",
        "--bce-pos-weight", "5.0", "--label-smoothing", "0.1",
        "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3",
        *TINY_FLAGS, *HUBERT_FLAGS]


TRAIN_FLAGS = _train_flags()


def _losses(log_file, key):
    """``key`` of each JSON record of a log file (JAX's lines carry a
    time stamp and logger name before the record; others are text)."""
    out = []
    for line in log_file.read_text().splitlines():
        body = line.rsplit(" | ", 1)[-1]
        if body.startswith("{") and key in json.loads(body):
            out.append(json.loads(body)[key])
    return out


def test_train_cli_matches_jax_and_keeps_the_frontend(hubert_cli):
    """2 updates of both train CLIs from one init with
    --load-pretrained-hubert-from: the same losses, validation line and
    final state; the frontend and its zero moments unchanged in both
    files; each package reads the other's checkpoint_last.npz."""
    from s2st_tpu.cli.train import main as jax_train
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.s2st_transformer import from_jax_variables
    from s2st_tpu_torch.train import checkpoint as pckpt
    from tests.test_torch_train_runtime import assert_state_close
    corpus, pt, init, trunk, root = hubert_cli
    common = [str(corpus), *TRAIN_FLAGS, "--load-pretrained-hubert-from",
              str(pt), "--restore-file", str(init), "--reset-optimizer",
              "--reset-dataloader"]
    jdir, pdir = root / "jax", root / "port"
    jdir.mkdir()
    assert jax_train(common + ["--save-dir", str(jdir), "--log-file",
                               str(jdir / "log.txt")]) == 0
    assert train.main(common + ["--save-dir", str(pdir), "--log-file",
                                str(root / "port_log.jsonl"),
                                "--device", "cpu"]) == 0
    want = _losses(jdir / "log.txt", "train_inner_loss")
    got = _losses(root / "port_log.jsonl", "loss")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # one validation, where the second update ends the run: JAX's JSON
    # record (--log-format json) holds the port's values to 4 decimals
    ref = _losses(jdir / "log.txt", "valid_loss")
    got = _losses(root / "port_log.jsonl", "valid")
    assert len(got) == 1 and len(ref) >= 1
    jrec = next(json.loads(line.rsplit(" | ", 1)[-1]) for line in
                (jdir / "log.txt").read_text().splitlines()
                if '"valid_loss"' in line)
    assert {"valid_" + k for k in got[0]} == set(jrec)
    for k, v in got[0].items():
        np.testing.assert_allclose(v, jrec["valid_" + k], atol=1e-4,
                                   rtol=0, err_msg=k)
    jflat = pckpt.load_checkpoint_file(str(jdir / "checkpoint_last.npz"))[0]
    pflat = pckpt.load_checkpoint_file(str(pdir / "checkpoint_last.npz"))[0]
    # parameters within 1e-5, 1 % of an update's lr step: over 3-6 frames
    # a few FFN gradient elements cancel to within a few % of their fp32
    # noise (2 of 2 x 512 elements moved 6e-6 and 8e-6 here)
    assert_state_close(pflat, jflat, 2, params_atol=1e-5)
    init_flat = pckpt.load_checkpoint_file(str(init))[0]
    hub = [k for k in init_flat if k.startswith("params::hubert::")]
    assert len(hub) == len(trunk)
    for key in hub:
        for flat in (jflat, pflat):
            assert np.array_equal(flat[key], init_flat[key]), key
            for m in ("mu", "nu"):
                assert not flat[pckpt.opt_key(m, key)].any(), key

    # the port reads JAX's file (strict), JAX the port's
    args = train.get_parser().parse_args([str(corpus), *TRAIN_FLAGS])
    from_jax_variables(model_config(args, 11, 11, 8), read_jax_checkpoint(
        str(jdir / "checkpoint_last.npz"))[0])
    jcfg = jm.S2STConfig(
        src_vocab_size=11, tgt_vocab_size=11, input_feat_per_channel=8,
        conv_channels=16, encoder_layers=2, encoder_embed_dim=16,
        encoder_ffn_embed_dim=32, encoder_attention_heads=2,
        middle_layers=(0, 1), decoder_layers=2, decoder_embed_dim=16,
        decoder_ffn_embed_dim=32, decoder_attention_heads=2,
        output_frame_dim=8, n_frames_per_step=2, prenet_dim=8,
        postnet_layers=2, postnet_conv_dim=8, aux_asr=True,
        aux_st=True, asr_decoder_layers=1, asr_decoder_embed_dim=16,
        st_decoder_layers=1, st_decoder_embed_dim=16, use_hubert=True,
        hubert_hidden=16, hubert_layers=1, hubert_ffn=32, hubert_heads=2,
        max_source_positions=256, max_target_positions=256)
    template = jax.eval_shape(lambda k: jm.init_s2st(k, jcfg),
                              jax.random.PRNGKey(0))
    # JAX's tree as its train CLI builds it: the .pt's leaves replace the
    # frontend (cli/train.py:171-177), then the file is restored strictly
    params = dict(template["params"])
    params["hubert"] = jh.load_torch_hubert(str(pt))[0]
    loaded = jckpt.load_variables_any(
        str(pdir / "checkpoint_last.npz"),
        template={"params": params, "stats": template["stats"]})
    got = flatten_tree(numpy_tree(loaded["params"]))
    assert set("params::" + k for k in got) == \
        {k for k in pflat if k.startswith("params::")}
    for key, v in got.items():
        assert np.array_equal(v, pflat["params::" + key]), key


def test_train_cli_loads_the_pt_trunk_and_validates(hubert_cli):
    """A run without the init checkpoint loads the .pt's trunk into the
    frontend and keeps it, and validates with --eval-inference over
    waveform batches."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.s2st_transformer import from_jax_variables
    corpus, pt, _, trunk, root = hubert_cli
    args = train.get_parser().parse_args([str(corpus), *TRAIN_FLAGS])
    fresh = root / "fresh"
    assert train.main([str(corpus), *TRAIN_FLAGS, "--max-update", "1",
                       "--load-pretrained-hubert-from", str(pt),
                       "--eval-inference", "--spec-bwd-max-iter", "2",
                       "--max-target-positions", "64",
                       "--best-checkpoint-metric", "mcd_loss",
                       "--log-file", str(fresh / "log.jsonl"),
                       "--save-dir", str(fresh), "--device", "cpu"]) == 0
    stats = [json.loads(line)["valid"] for line in
             (fresh / "log.jsonl").read_text().splitlines()
             if '"valid"' in line]
    assert len(stats) == 1 and all(
        np.isfinite(stats[0][k]) for k in ("loss", "mcd_loss", "ins_rate",
                                           "del_rate"))
    model = from_jax_variables(model_config(args, 11, 11, 8),
                               read_jax_checkpoint(
                                   str(fresh / "checkpoint_last.npz"))[0])
    assert set(model.encoder.hubert.state_dict()) == set(trunk)
    for name, value in model.encoder.hubert.state_dict().items():
        assert torch.equal(value, trunk[name]), name


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return [line for line in buf.getvalue().splitlines()
            if re.match(r"^[STHDP]-|^Generate ", line)]


def test_serving_clis_match_jax_with_use_hubert(hubert_cli, tmp_path):
    """Stage 7's generate_waveform and stage 10's generate_for_s2st
    --scoring wer with --use-hubert True, from the init checkpoint: the
    port's dumped features are JAX's (fp32, no prenet dropout in the
    checkpoint's flag echo, no early stop), and its lines JAX's."""
    from s2st_tpu.cli import generate_for_s2st as jgen_s2t
    from s2st_tpu.cli import generate_waveform as jgen
    from s2st_tpu_torch.cli import generate_for_s2st, generate_waveform
    corpus, _, init, _, _ = hubert_cli
    flags = [str(corpus), "--config-yaml", "config.yaml", "--gen-subset",
             "test", "--task", "s2s_translation", "--path", str(init),
             "--use-hubert", "True"]
    wave = ["--max-iter", "6", "--eos-prob-threshold", "1.5",
            "--spec-bwd-max-iter", "2", "--dump-features"]
    assert jgen.main(flags + wave + ["--results-path",
                                     str(tmp_path / "jax")]) == 0
    assert generate_waveform.main(flags + wave + [
        "--results-path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    ids = [row.split("\t")[0] for row in
           (corpus / "test.tsv").read_text().splitlines()[1:]]
    assert len(ids) == 4
    for uid in ids:
        got = np.load(tmp_path / "port" / "feat" / f"{uid}_pred.npy")
        want = np.load(tmp_path / "jax" / "feat" / f"{uid}_pred.npy")
        assert got.shape == want.shape == (12, 8)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=uid)
    s2t = ["--max-tokens", "50000", "--beam", "5", "--scoring", "wer",
           "--wer-lowercase", "--wer-remove-punct"]
    want = _stdout(jgen_s2t.main, flags + s2t)
    got = _stdout(generate_for_s2st.main, flags + s2t + ["--device", "cpu"])
    assert got == want
    assert sum(line.startswith("H-") for line in got) == 4
    assert got[-1].startswith("Generate test with beam=5: WER: ")
