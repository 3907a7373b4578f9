"""Serving left-outs of s2st_tpu_torch against s2st_tpu, fp32 on the CPU.

- int8 KV cache: ``quantize_kv`` bit for bit (ties rounded half to even,
  zero rows); the port's ``generate_features`` with
  ``kv_cache_dtype="int8"`` against JAX's at a fixed step count (no row
  stops, prenet dropout off); both CLIs' ``--kv-cache-dtype int8``
  features.
- ``utterance_cmvn`` with each ``norm_means``/``norm_vars`` against JAX's
  transform; the port's ``FeatureTransforms`` raises only on names JAX
  does not register.
- ``--model-overrides`` wins over the checkpoint's echo and the command
  line, as JAX's ``model_args_from_checkpoint``; both CLIs serve the same
  features with it.
- ``--speaker-to-id``: the speaker count and the embeddings' shapes JAX's
  task builds, a training batch's speaker ids as JAX's dataset collates
  them, the forward with speakers, a train CLI update that writes
  ``embed_speaker``, and both CLIs serving a speaker checkpoint (JAX's
  stage 7 passes no speaker to the decode; the port does the same).

Tolerances: atol 1e-5 + rtol 1e-5 on features (fp32 both sides); the
int8 path dequantises the same int8 codes, so it holds the same bound.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.generate import speech_generator as jsg
from s2st_tpu.nn import attention as jattn
from s2st_tpu_torch.generate import speech_generator as psg
from s2st_tpu_torch.models.jax_bridge import jax_variables
from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
from s2st_tpu_torch.nn import attention as pattn
from tests._torch_port import one_thread, port_cfg, t  # noqa: F401
from tests.conftest import make_batch
from tests.test_torch_generate import TINY_FLAGS, threshold_for

ATOL = RTOL = 1e-5
MAX_ITER = 10


def close(port, ref, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=msg)


def test_quantize_kv_matches_jax():
    r = np.random.RandomState(0)
    x = r.randn(3, 5, 2, 16).astype(np.float32)
    x[0, 0, 0] = 0.0                          # a zero row: scale 0
    x[1, 1, 1, :2] = [127.0, 0.5]             # 0.5 * 127 / 127: a tie
    x[1, 1, 1, 2] = -1.5
    jq, js = jattn.quantize_kv(jnp.asarray(x))
    pq, ps = pattn.quantize_kv(t(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert np.array_equal(pq.numpy(), np.asarray(jq))
    assert np.array_equal(ps.numpy(), np.asarray(js))
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = pattn.dequantize_kv(pq, ps, dtype).float().numpy()
        want = np.asarray(jattn.dequantize_kv(jq, js, jdt), np.float32)
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def setup(tiny_cfg):
    cfg = tiny_cfg.replace(n_frames_per_step=2, prenet_dropout=0.0,
                           use_flash_attention=False)
    model = S2STTransformer(port_cfg(cfg)).init_weights(seed=5).eval()
    return cfg, jax_variables(model), model


def test_int8_decode_matches_jax(setup):
    cfg, v, model = setup
    b = make_batch(cfg, b=3, seed=11)
    want = jax.jit(jsg.generate_features, static_argnums=(1, 2))(
        v, cfg, jsg.GenerationConfig(max_iter=MAX_ITER,
                                     eos_prob_threshold=1.5,
                                     prenet_dropout_at_inference=False,
                                     kv_cache_dtype="int8"),
        jnp.asarray(b["src_speech"]), jnp.asarray(b["src_speech_lens"]))
    got = psg.generate_features(
        model, psg.GenerationConfig(max_iter=MAX_ITER,
                                    eos_prob_threshold=1.5,
                                    prenet_dropout_at_inference=False,
                                    kv_cache_dtype="int8"),
        t(b["src_speech"]), t(b["src_speech_lens"]).long())
    bf = psg.generate_features(
        model, psg.GenerationConfig(max_iter=MAX_ITER,
                                    eos_prob_threshold=1.5,
                                    prenet_dropout_at_inference=False),
        t(b["src_speech"]), t(b["src_speech_lens"]).long())
    assert np.array_equal(got["out_lens"].numpy(), [MAX_ITER] * 3)
    for key in ("feats", "eos_prob", "attn"):
        close(got[key].numpy(), want[key], msg=key)
    # int8 moved the features: the caches really were quantised
    assert float((got["feats"] - bf["feats"]).abs().max()) > 1e-4


def _utterance_cmvn_cfg(tmp_path, block):
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    path = tmp_path / "config.yaml"
    path.write_text("utterance_cmvn:\n" + "".join(
        f"  {k}: {str(v).lower()}\n" for k, v in block.items())
        if block else "input_channels: 1\n")
    return S2STDataConfig(path)


@pytest.mark.parametrize("means,vars_", [(True, True), (True, False),
                                         (False, True), (None, None)])
def test_utterance_cmvn_matches_jax(tmp_path, means, vars_):
    from s2st_tpu.data.feature_transforms import \
        CompositeAudioFeatureTransform
    from s2st_tpu_torch.data.manifest import FeatureTransforms
    block = {} if means is None else {"norm_means": means,
                                      "norm_vars": vars_}
    x = (np.random.RandomState(4).randn(23, 8) * 3 + 1).astype(np.float32)
    x[:, 2] = 5.0                                # a constant channel
    want = CompositeAudioFeatureTransform.from_config_dict(
        ["utterance_cmvn"], {"utterance_cmvn": block})(x)
    got = FeatureTransforms(_utterance_cmvn_cfg(tmp_path, block),
                            ["utterance_cmvn"])(x)
    assert got.dtype == np.float32
    close(got, want)


def test_feature_transforms_raise_on_unregistered_names(tmp_path):
    from s2st_tpu.data.feature_transforms import get_feature_transform
    from s2st_tpu_torch.data.manifest import FeatureTransforms
    cfg = _utterance_cmvn_cfg(tmp_path, {})
    for name in ("global_cmvn", "utterance_cmvn", "specaugment"):
        get_feature_transform(name)
    with pytest.raises(KeyError):
        get_feature_transform("delta_deltas")
    with pytest.raises(NotImplementedError):
        FeatureTransforms(cfg, ["delta_deltas"])


@pytest.mark.parametrize("cli", ["generate_waveform", "generate_for_s2st",
                                 "generate"])
def test_model_overrides_match_jax(tmp_path, cli):
    """The merged namespace of each package on one JAX checkpoint, through
    each port CLI that takes --model-overrides (JAX's generation parser):
    the echo over the command line except run-time keys, the overrides
    over both."""
    import importlib
    from s2st_tpu.options import get_generation_parser
    from s2st_tpu.options import model_args_from_checkpoint as jmargs
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu_torch.models.config_from_args import \
        model_args_from_checkpoint as pmargs
    parser = importlib.import_module(f"s2st_tpu_torch.cli.{cli}").get_parser()
    from s2st_tpu_torch.models.jax_bridge import read_jax_checkpoint
    ckpt = str(tmp_path / "c.npz")
    meta = {"args": {"encoder_layers": 3, "dropout": 0.3, "max_tokens": 9,
                     "fp16": True}}
    np.savez(ckpt, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                          np.uint8))
    assert jckpt.peek_meta(ckpt) == meta
    for overrides in ("{}", "{'encoder_layers': 5, 'max_tokens': 7}",
                      "  {'fp16': False}  "):
        argv = ["d", "--path", ckpt, "--results-path", "o",
                "--encoder-layers", "2", "--max-tokens", "11",
                "--model-overrides", overrides]
        want = jmargs(get_generation_parser().parse_args(argv))
        got = pmargs(parser.parse_args(argv), read_jax_checkpoint(ckpt)[1])
        for key in ("encoder_layers", "dropout", "max_tokens", "fp16"):
            assert getattr(got, key) == getattr(want, key), (overrides, key)


def test_speaker_batches_and_model_match_jax(tmp_path):
    """--speaker-to-id: JAX's task and dataset against the port's
    TrainSplit and model config, then the forward with the batch's
    speakers."""
    from s2st_tpu.data.data_cfg import S2STDataConfig as JCfg
    from s2st_tpu.data.dictionary import Dictionary as JDict
    from s2st_tpu.data.s2st_dataset import S2STDatasetCreator
    from s2st_tpu.models import s2st_transformer as jm
    from s2st_tpu.options import get_training_parser
    from s2st_tpu.tasks.s2s_translation import S2STranslationTask
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit
    from s2st_tpu_torch.models.config_from_args import (model_config,
                                                        speaker_to_id)
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus", n_train=6, n_dev=1,
                              n_test=1)
    tsv = corpus / "train.tsv"
    lines = tsv.read_text().splitlines()
    lines = [lines[0]] + [line.replace("\tspk0", f"\t{s}") for line, s in
                          zip(lines[1:], ["a", "b", "zz", "b", "a", "a"])]
    tsv.write_text("\n".join(lines) + "\n")
    spk = json.dumps({"a": 0, "b": 2})
    flags = [str(corpus), "--speaker-to-id", spk, "--speaker-embed-dim",
             "16", "--n-frames-per-step", "2"] + TINY_FLAGS
    jargs = get_training_parser().parse_args(flags)
    jtask = S2STranslationTask.setup_task(jargs)
    jcfg = jtask.build_model_config()
    pargs = train.get_parser().parse_args(flags + ["--device", "cpu"])
    dicts = [Dictionary.load(str(corpus / f"{s}_vocab.txt"))
             for s in ("src", "tgt")]
    pcfg = model_config(pargs, len(dicts[0]), len(dicts[1]), 8,
                        num_speakers=3)
    assert jcfg.num_speakers == pcfg.num_speakers == 3
    assert jcfg.speaker_embed_dim == pcfg.speaker_embed_dim == 16
    jdicts = [JDict.load(str(corpus / f"{s}_vocab.txt"))
              for s in ("src", "tgt")]
    jds = S2STDatasetCreator.from_tsv(
        str(corpus), JCfg(corpus / "config.yaml"), "train", *jdicts,
        is_train_split=False, n_frames_per_step=2,
        speaker_to_id=speaker_to_id(pargs))
    split = TrainSplit(str(corpus), S2STDataConfig(corpus / "config.yaml"),
                       "train", *dicts, n_frames_per_step=2,
                       speaker_to_id=speaker_to_id(pargs))
    ref = jds.collate([jds[i] for i in range(6)], pad_batch=8)
    got = split.collate([split.item(i) for i in range(6)], pad_batch=8)
    assert got["speaker"].tolist() == ref["speaker"].tolist()
    assert sorted(got["speaker"][:6].tolist()) == [0, 0, 0, 0, 2, 2]
    # the forward with these speakers, on the same weights
    jcfg = jcfg.replace(dtype=jnp.float32, prenet_dropout=0.0)
    model = S2STTransformer(port_cfg(jcfg)).init_weights(seed=3)
    v = jax_variables(model)
    assert v["params"]["encoder"]["embed_speaker"]["w"].shape == (3, 16)
    batch = {k: np.asarray(x) for k, x in ref.items()
             if isinstance(x, np.ndarray) and k != "id"}
    want = jax.jit(lambda v, b: jm.forward(v, jcfg, b, deterministic=True))(
        v, {k: jnp.asarray(x) for k, x in batch.items()})
    with torch.no_grad():
        out = model.eval()({k: torch.from_numpy(x).long()
                            if x.dtype.kind == "i" else torch.from_numpy(x)
                            for k, x in batch.items()})
        without = model({k: torch.from_numpy(x).long()
                          if x.dtype.kind == "i" else torch.from_numpy(x)
                          for k, x in batch.items() if k != "speaker"})
    for key in ("feat_out", "post_feat_out", "eos_out"):
        close(out[key].numpy(), want[key], msg=key)
    assert float((without["feat_out"] - out["feat_out"]).abs().max()) > 1e-3


def test_train_cli_writes_speaker_embeddings(tmp_path):
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.train.checkpoint import load_checkpoint_file
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(tmp_path / "corpus", n_train=4, n_dev=1,
                              n_test=1)
    save = tmp_path / "ckpt"
    argv = [str(corpus), "--save-dir", str(save), "--max-tokens", "200",
            "--speaker-to-id", '{"spk0": 1}', "--speaker-embed-dim", "16",
            "--disable-validation", "--device", "cpu"] + TINY_FLAGS
    assert train.main(argv + ["--max-update", "1"]) == 0
    flat, meta = load_checkpoint_file(str(save / "checkpoint_last.npz"))
    assert flat["params::encoder::embed_speaker::w"].shape == (2, 16)
    assert flat["params::decoder::embed_speaker::w"].shape == (2, 16)
    assert meta["args"]["speaker_to_id"] == '{"spk0": 1}'
    # training resumes from it, speaker embeddings and their Adam state
    assert train.main(argv + ["--max-update", "2"]) == 0
    assert load_checkpoint_file(str(save / "checkpoint_last.npz"))[1][
        "step"] == 2


# ---------------------------------------------------------------------------
# both CLIs
# ---------------------------------------------------------------------------

def serving_setup(root, jax_cfg, seed, speakers=0, vocoder_block=None):
    """The tiny corpus (with a ``vocoder:`` block appended to config.yaml
    where given), a port model of jax_cfg at the corpus's vocabulary sizes
    (seeded), its JAX checkpoint with TINY_FLAGS' echo, and a decode
    threshold under which the test split's rows stop at different steps.
    Returns (corpus, checkpoint, model, threshold)."""
    from s2st_tpu.data.dictionary import Dictionary
    from s2st_tpu.options import get_training_parser
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu.train.optim import adam
    from s2st_tpu.train.trainer import create_train_state
    from s2st_tpu_torch.data.manifest import GenerationSplit
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from tests.make_tiny_corpus import make_tiny_corpus
    corpus = make_tiny_corpus(root / "corpus", n_train=2, n_dev=1, n_test=5)
    if vocoder_block:
        with open(corpus / "config.yaml", "a") as f:
            f.write("vocoder:\n" + "".join(f"  {k}: {v}\n" for k, v in
                                           vocoder_block.items()))
    cfg = jax_cfg.replace(num_speakers=speakers, speaker_embed_dim=16,
                          speaker_embed_dim_dec=16, **{
                              f"{side}_vocab_size": len(Dictionary.load(
                                  str(corpus / f"{side}_vocab.txt")))
                              for side in ("src", "tgt")})
    model = S2STTransformer(port_cfg(cfg)).init_weights(seed=seed).eval()
    echo = vars(get_training_parser().parse_args(
        [str(corpus), "--speaker-embed-dim", "16"] + TINY_FLAGS))
    echo = {k: x for k, x in echo.items()
            if isinstance(x, (bool, int, float, str, type(None)))}
    ckpt = str(root / "checkpoint_last.npz")
    jckpt.save_checkpoint_file(ckpt, create_train_state(
        jax_variables(model), adam()), {"args": echo})
    split = GenerationSplit(str(corpus), S2STDataConfig(corpus /
                                                        "config.yaml"),
                            "test", 2)
    batch = split.collate(list(range(5)))
    thr = threshold_for(model, batch["src_speech"].numpy(),
                        batch["src_speech_lens"].numpy())
    return corpus, ckpt, model, thr


def run_both_clis(corpus, ckpt, out, *flags):
    """JAX's and the port's generate_waveform on the test split with the
    same flags; returns {package: results root}."""
    from s2st_tpu.cli import generate_waveform as jgw
    from s2st_tpu_torch.cli import generate_waveform as pgw
    argv = [str(corpus), "--config-yaml", "config.yaml", "--gen-subset",
            "test", "--path", ckpt, "--spec-bwd-max-iter", "2",
            "--dump-features", "--dump-waveforms", *flags]
    roots = {"jax": out / "jax", "port": out / "port"}
    assert jgw.main(argv + ["--results-path", str(roots["jax"])]) == 0
    assert pgw.main(argv + ["--results-path", str(roots["port"]),
                            "--device", "cpu"]) == 0
    return roots


def assert_same_features(roots, n=5):
    names = sorted(p.name for p in (roots["jax"] / "feat").iterdir())
    assert len(names) == n
    assert sorted(p.name for p in (roots["port"] / "feat").iterdir()) \
        == names
    lengths = set()
    for name in names:
        want = np.load(roots["jax"] / "feat" / name)
        got = np.load(roots["port"] / "feat" / name)
        assert got.shape == want.shape, name
        close(got, want, msg=name)
        lengths.add(len(want))
    return lengths


@pytest.fixture(scope="module")
def cli_case(setup, tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    return root, serving_setup(root, setup[0], seed=45)


def test_cli_int8_kv_cache_matches_jax(cli_case):
    root, (corpus, ckpt, _, thr) = cli_case
    roots = run_both_clis(corpus, ckpt, root / "int8", "--kv-cache-dtype",
                          "int8", "--max-iter", str(MAX_ITER),
                          "--eos-prob-threshold", str(thr))
    assert len(assert_same_features(roots)) > 1


def test_cli_model_overrides_match_jax(cli_case):
    """{'max_target_positions': 12} caps the decode at 12 // 2 = 6 steps
    (12 frames) in both packages."""
    root, (corpus, ckpt, _, thr) = cli_case
    roots = run_both_clis(corpus, ckpt, root / "overrides",
                          "--model-overrides",
                          "{'max_target_positions': 12}", "--max-iter",
                          str(MAX_ITER), "--eos-prob-threshold", "1.5")
    assert assert_same_features(roots) == {12}


def test_cli_speaker_checkpoint_matches_jax(setup, tmp_path):
    corpus, ckpt, model, thr = serving_setup(tmp_path, setup[0], seed=46,
                                             speakers=2)
    assert model.encoder.embed_speaker is not None
    roots = run_both_clis(corpus, ckpt, tmp_path, "--speaker-to-id",
                          '{"spk0": 1}', "--max-iter", str(MAX_ITER),
                          "--eos-prob-threshold", str(thr))
    assert_same_features(roots)


def test_speaker_args_parse_as_jax():
    from s2st_tpu_torch.models.config_from_args import (add_speaker_args,
                                                        num_speakers)
    p = argparse.ArgumentParser()
    add_speaker_args(p)
    assert num_speakers(p.parse_args([])) == 0
    assert num_speakers(p.parse_args(["--speaker-to-id", "{}"])) == 0
    assert num_speakers(p.parse_args(
        ["--speaker-to-id", '{"a": 4, "b": 1}'])) == 5
