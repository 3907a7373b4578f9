"""The port's CLIs compute fp32 as fp32: each turns TF32 off.

PyTorch runs cuDNN's fp32 convolutions in TF32 by default, which keeps
about three decimal digits, so an fp32 run of the HuBERT frontend's convs
or the fbank path's subsampler and postnet would leave the fp32 agreement
with JAX that the port is held to. Each case sets both TF32 flags True
(``monkeypatch`` restores them for the other tests), runs one CLI's
``main`` on the tiny corpus of that CLI's own CPU tests, and requires both
flags False afterwards.
"""

import pytest
import torch

from tests.make_tiny_corpus import make_tiny_corpus
from tests.test_torch_aux_generate import CLI_MODEL
from tests.test_torch_text_generate import (GEN_FLAGS, _jax_checkpoint,
                                            _write_text_corpus)
from tests.test_torch_train import TINY_FLAGS


@pytest.fixture(scope="module")
def speech(tmp_path_factory):
    """The tiny fbank corpus and a port-initialised checkpoint with its
    flag echo (as ``tests/test_torch_aux_generate.py`` builds them)."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    root = tmp_path_factory.mktemp("tf32_speech")
    corpus = make_tiny_corpus(root / "corpus", n_test=2)
    args = train.get_parser().parse_args([str(corpus), *CLI_MODEL])
    model = S2STTransformer(model_config(args, 11, 11, 8)).init_weights(7)
    ckpt = root / "checkpoint.npz"
    write_jax_checkpoint(str(ckpt), model, {"args": train.args_echo(args)})
    return corpus, ckpt


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    """The text CLI's corpus (binarized by JAX's preprocess) and a
    lightweight-conv checkpoint (as ``tests/test_torch_text_generate.py``
    builds them)."""
    from s2st_tpu.cli.preprocess import main as preprocess
    root = tmp_path_factory.mktemp("tf32_text")
    _write_text_corpus(root, n_test=2)
    assert preprocess(["--source-lang", "de", "--target-lang", "en",
                       "--trainpref", str(root / "train"), "--testpref",
                       str(root / "test"), "--destdir", str(root / "bin"),
                       "--workers", "1"]) == 0
    ckpt = root / "checkpoint.npz"
    _jax_checkpoint(root / "bin", "lightweight", ckpt)
    return root / "bin", ckpt


def _train(request, out):
    from s2st_tpu_torch.cli.train import main
    corpus, _ = request.getfixturevalue("speech")
    return main([str(corpus), "--config-yaml", "config.yaml",
                 "--train-subset", "train", "--save-dir", str(out),
                 "--max-tokens", "200", "--max-update", "1", "--task",
                 "s2s_translation", "--criterion", "s2st_loss", "--arch",
                 "s2st_transformer", "--optimizer", "adam", "--lr", "1e-3",
                 "--disable-validation", "--device", "cpu", *TINY_FLAGS])


def _generate_waveform(request, out):
    from s2st_tpu_torch.cli.generate_waveform import main
    corpus, ckpt = request.getfixturevalue("speech")
    return main([str(corpus), "--config-yaml", "config.yaml", "--gen-subset",
                 "test", "--path", str(ckpt), "--results-path", str(out),
                 "--max-iter", "4", "--spec-bwd-max-iter", "2", "--device",
                 "cpu"])


def _generate_for_s2st(request, out):
    from s2st_tpu_torch.cli.generate_for_s2st import main
    corpus, ckpt = request.getfixturevalue("speech")
    return main([str(corpus), "--config-yaml", "config.yaml", "--gen-subset",
                 "test", "--task", "s2s_translation", "--path", str(ckpt),
                 "--max-tokens", "50000", "--beam", "2", "--scoring", "wer",
                 "--results-path", str(out), "--device", "cpu"])


def _generate(request, out):
    from s2st_tpu_torch.cli.generate import main
    corpus, ckpt = request.getfixturevalue("text")
    return main([str(corpus), *GEN_FLAGS, "--path", str(ckpt),
                 "--results-path", str(out), "--device", "cpu"])


CLIS = {"train": _train, "generate_waveform": _generate_waveform,
        "generate_for_s2st": _generate_for_s2st, "generate": _generate}


@pytest.mark.parametrize("cli", list(CLIS))
def test_cli_turns_tf32_off(cli, request, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert CLIS[cli](request, tmp_path / "out") == 0
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
