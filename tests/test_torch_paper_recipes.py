"""The paper's training recipes through s2st_tpu_torch against s2st_tpu, on
the CPU: ``recipes/run_pretraining.sh``, ``run_mix_tuning.sh`` and
``run_prompt_tuning.sh`` and their port twins ``recipes/*_torch.sh``.

- Each port script runs JAX's ``train`` lines with ``s2st_tpu.`` ->
  ``s2st_tpu_torch.`` (both run with a ``python`` on the PATH that records
  its arguments), ``bash -n`` passes, and every line's flags are accepted
  by the port's parser, as by JAX's.
- The reference's faults, at the recipe's widths (512-d, 12 + 6 layers,
  4 x 80-d frames), raise the same class in both packages: one
  ``--speaker-embed-dim`` sizes both speaker tables, so prompt tuning's 512
  and mix-tuning's default 64 meet a shape error in the first forward
  (``TypeError``); a strict warm start of a speaker model from a
  checkpoint without speaker tables raises ``KeyError``.
- Prompt tuning where JAX builds it (encoder width = frame width =
  speaker width = 16): the warm start of encoder and decoder from a
  speaker checkpoint, then two updates of the recipe's loss against JAX's
  ``Trainer``: losses, grad norms, parameters.
- Two train-CLI runs of each package, 2 updates each from one init (JAX's
  init is patched to return the port's seeded weights): ``--arch
  s2t_transformer --criterion s2t_loss --test-type st`` with its
  validation by loss, then the S2ST fine-tune over ``train_a,train_b,
  train_c`` resampled with ``sampling_alpha`` 0.5 (one update an epoch,
  so each update has its epoch's draw), warm-started with
  ``--load-pretrained-encoder-from`` the port's S2T checkpoint: per-update
  losses and the validation's values. The port resumes from JAX's S2T
  ``checkpoint_last.npz``, and JAX restores the port's, optimizer state
  included.

Tolerances: the CLI losses as JAX logs them, rounded to 4 decimals (atol
1e-4); the Trainer's as ``tests/test_torch_train.py`` holds them (loss,
grad norm rel 1e-4; parameters atol 1e-6 + rtol 1e-5, but lr a step for
the leaves whose gradient is 0 in exact arithmetic and for the elements
whose gradient is below 1e-5, where the gradients' own tolerance, atol
1e-6, moves Adam's step g / (|g| + eps) by more than 1e-6).
"""

import contextlib
import json
import logging
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.models import s2t_transformer as js2t
from s2st_tpu_torch.cli import train
from s2st_tpu_torch.models.jax_bridge import jax_variables
from tests._torch_port import one_thread  # noqa: F401
from tests.test_torch_hubert import _losses
from tests.test_torch_train import TINY_FLAGS

REPO = Path(__file__).resolve().parent.parent
RECIPES = ("run_pretraining", "run_mix_tuning", "run_prompt_tuning")

# records the module and flags of each python line of a recipe
RECORDER = """#!{exe}
import json, os, sys
with open(os.environ["ARGV_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
"""


def recipe_lines(name: str, tmp_path: Path) -> list:
    """The argv of each ``python`` line the recipe runs."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    stub = bindir / "python"
    stub.write_text(RECORDER.format(exe=sys.executable))
    stub.chmod(0o755)
    log = tmp_path / f"{name}.jsonl"
    env = {**os.environ, "PATH": f"{bindir}:{os.environ['PATH']}",
           "ARGV_LOG": str(log), "FEATURE_MANIFEST_ROOT": "FEATS",
           "SAVE_DIR": "SAVE", "hubert_path": "HUBERT.pt",
           "pretrained": "PRETRAINED.npz"}
    res = subprocess.run(["bash", str(REPO / "recipes" / f"{name}.sh")],
                         env=env, capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return [json.loads(line) for line in log.read_text().splitlines()]


@pytest.mark.parametrize("name", RECIPES)
def test_port_recipe_runs_jax_lines_and_its_flags_parse(name, tmp_path):
    from s2st_tpu.options import parse_training_args
    from s2st_tpu_torch.models.config_from_args import apply_arch
    port_script = REPO / "recipes" / f"{name}_torch.sh"
    res = subprocess.run(["bash", "-n", str(port_script)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    jax_lines = recipe_lines(name, tmp_path)
    port_lines = recipe_lines(f"{name}_torch", tmp_path)
    assert len(jax_lines) == len(port_lines) >= 1
    for j, p in zip(jax_lines, port_lines):
        assert j[:2] == ["-m", "s2st_tpu.cli.train"]
        assert p == ["-m", "s2st_tpu_torch.cli.train"] + j[2:]
        argv = p[2:]
        args = apply_arch(train.get_parser().parse_args(argv), argv)
        ref = parse_training_args(argv)
        for key in ("arch", "criterion", "test_type", "use_hubert",
                    "train_subset", "load_pretrained_encoder_from",
                    "load_pretrained_decoder_from", "speaker_to_id",
                    "speaker_embed_dim", "encoder_embed_dim",
                    "decoder_embed_dim", "label_smoothing", "lr"):
            assert getattr(args, key) == getattr(ref, key), (name, key)


def recipe_width_args(name: str, tmp_path: Path, line: int):
    """The port's parsed flags of a recipe's train line."""
    from s2st_tpu_torch.models.config_from_args import apply_arch
    argv = recipe_lines(f"{name}_torch", tmp_path)[line][2:]
    return apply_arch(train.get_parser().parse_args(argv), argv)


def jax_cfg(args, speakers):
    from s2st_tpu.options import build_model_config
    return build_model_config(args, 100, 100, speakers).replace(
        dtype=jnp.float32)


def empty_port_model(args, speakers):
    """The port's recipe-width model with uninitialised weights (shapes
    are all a fault needs)."""
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    cfg = model_config(args, 100, 100, 80, speakers).replace(
        dtype=torch.float32)
    with torch.device("meta"):
        model = S2STTransformer(cfg)
    return model.to_empty(device="cpu"), cfg


@pytest.mark.parametrize("name,line", [("run_prompt_tuning", 0),
                                       ("run_mix_tuning", 1)])
def test_speaker_width_fault_raises_in_both(name, line, tmp_path):
    from tests.conftest import make_batch
    args = recipe_width_args(name, tmp_path, line)
    args.use_hubert = False          # the fault is the speaker tables'
    jcfg = jax_cfg(args, 2)
    assert (jcfg.encoder_embed_dim, jcfg.out_dim) == (512, 320)
    assert jcfg.speaker_embed_dim == (512 if "prompt" in name else 64)
    batch = make_batch(jcfg, b=2, src_t=40, tgt_t=10)
    batch["speaker"] = np.array([0, 1], np.int32)
    template = jax.eval_shape(lambda k: jm.init_s2st(k, jcfg),
                              jax.random.PRNGKey(0))
    with pytest.raises(TypeError):
        jax.eval_shape(lambda v, b: jm.forward(v, jcfg, b), template, batch)
    model, _ = empty_port_model(args, 2)
    from tests.test_torch_train import port_batch
    with pytest.raises(TypeError), torch.no_grad():
        model(port_batch(batch))


def test_strict_warm_start_fault_raises_in_both(tmp_path):
    """Prompt tuning's --load-pretrained-encoder-from a checkpoint of the
    recipe's model without speakers, into the speaker model."""
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.train.checkpoint import load_pretrained_component
    args = recipe_width_args("run_prompt_tuning", tmp_path, 0)
    pretrained, _ = empty_port_model(args, 0)
    path = tmp_path / "pretrained.npz"
    write_jax_checkpoint(str(path), pretrained)
    del pretrained
    jcfg = jax_cfg(args, 1)
    template = jax.eval_shape(lambda k: jm.init_s2st(k, jcfg),
                              jax.random.PRNGKey(0))
    with pytest.raises(KeyError, match="embed_speaker"):
        jckpt.load_pretrained_component(template, str(path), "encoder")
    model, _ = empty_port_model(args, 1)
    with pytest.raises(KeyError, match="embed_speaker"):
        load_pretrained_component(model, str(path), "encoder")


def test_prompt_tuning_where_jax_builds_it(tiny_cfg, tmp_path):
    from s2st_tpu.parallel.mesh import make_mesh
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu.train import losses as jl
    from s2st_tpu.train.optim import adam, inverse_sqrt_schedule
    from s2st_tpu.train.trainer import Trainer as JaxTrainer
    from s2st_tpu.train.trainer import create_train_state
    from s2st_tpu_torch.train import losses as pl
    from s2st_tpu_torch.train.checkpoint import (load_pretrained_component,
                                                 opt_key, state_flat)
    from s2st_tpu_torch.train.optim import schedule_from_args
    from s2st_tpu_torch.train.trainer import Trainer
    from tests._torch_port import port_model
    from tests.test_torch_train import (BN_MEAN, NO_DROPOUT, ZERO_GRAD,
                                        _cli_args, jax_leaves, port_batch,
                                        port_leaves, train_batch)
    from tests.test_torch_warm_start import save_npz
    cfg = tiny_cfg.replace(n_frames_per_step=2, num_speakers=2,
                           speaker_embed_dim=16, speaker_embed_dim_dec=16,
                           **NO_DROPOUT)
    assert cfg.encoder_embed_dim == cfg.out_dim == cfg.speaker_embed_dim
    path = save_npz(tmp_path / "pretrained.npz",
                    jm.init_s2st(jax.random.PRNGKey(1), cfg))
    variables = jm.init_s2st(jax.random.PRNGKey(0), cfg)
    model = port_model(cfg, variables)
    for comp in ("encoder", "decoder"):
        variables = jckpt.load_pretrained_component(variables, path, comp)
        load_pretrained_component(model, path, comp)
    loss = dict(bce_pos_weight=5.0, label_smoothing=0.1, ctc_weight=1.0,
                asr_ce_weight=1.0, st_ce_weight=1.0)
    lr, clip = 5e-4, 1.0
    tx = adam(betas=(0.9, 0.98))
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    j_tr = JaxTrainer(cfg, jl.LossConfig(**loss), tx,
                      inverse_sqrt_schedule(lr, 4, lr), mesh, clip_norm=clip)
    # committed to the mesh as JAX's CLI does, so that one step compiles
    state = j_tr.place_state(create_train_state(variables, tx))
    p_tr = Trainer(model, pl.LossConfig(**loss), schedule_from_args(
        _cli_args(lr=str(lr), warmup_updates=4)), clip_norm=clip)
    noisy = {}
    for i in range(2):
        batch = train_batch(cfg, seed=40 + i)
        batch["speaker"] = np.array([1, 0, 1], np.int32)
        state, j_met = j_tr.train_step(state, [batch], jax.random.PRNGKey(i))
        p_met = p_tr.train_step(port_batch(batch))
        for key in ("loss", "gnorm", "lr", "sample_size"):
            assert math.isclose(p_met[key], float(j_met[key]), rel_tol=1e-4,
                                abs_tol=1e-7), (i, key)
        ref = jax_leaves(state.params, "params")
        ref.update(jax_leaves(state.stats, "stats"))
        got = port_leaves(model)
        assert set(got) == set(ref)
        assert "params::encoder::embed_speaker::w" in got
        flat = state_flat(p_tr)
        for key, r in ref.items():
            atol = lr * (i + 1) if ZERO_GRAD.search(key) \
                else 1e-6 + 0.1 * lr * i if BN_MEAN.search(key) else 1e-6
            if key.startswith("params"):
                # Adam's step g / (|g| + eps) of an element whose gradient
                # is below 1e-5 moves by more than 1e-6 within the
                # gradients' own tolerance (atol 1e-6): up to lr a step
                rms = np.sqrt(flat[opt_key("nu", key)] / (1 - 0.98 ** (i + 1)))
                noisy[key] = noisy.get(key, False) | (rms < 1e-5)
                atol = np.where(noisy[key], lr * (i + 1), atol)
            assert not (np.abs(got[key] - r) > atol + 1e-5 * np.abs(r)).any(
            ), (i, key)


# --- the two CLI runs of each package --------------------------------------

NO_DROP = ["--dropout", "0", "--attention-dropout", "0",
           "--activation-dropout", "0", "--prenet-dropout", "0",
           "--postnet-dropout", "0"]
S2T_FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset", "train",
    "--valid-subset", "dev", "--task", "s2s_translation",
    "--criterion", "s2t_loss", "--arch", "s2t_transformer",
    "--test-type", "st", "--label-smoothing", "0.1", "--optimizer", "adam",
    "--lr", "2e-3", "--lr-scheduler", "inverse_sqrt", "--warmup-updates",
    "4", "--clip-norm", "10.0", "--max-tokens", "200", "--max-update", "2",
    "--encoder-normalize-before", "--decoder-normalize-before",
    "--seed", "1", "--log-interval", "1", "--log-format", "json",
    *NO_DROP, *TINY_FLAGS]
FINETUNE_FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset",
    "train_a,train_b,train_c", "--task", "s2s_translation",
    "--criterion", "s2st_loss", "--arch", "s2st_transformer",
    "--n-frames-per-step", "2", "--bce-pos-weight", "5.0",
    "--encoder-normalize-before", "--decoder-normalize-before",
    "--optimizer", "adam", "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt",
    "--warmup-updates", "4", "--clip-norm", "1.0", "--label-smoothing",
    "0.1", "--ctc-weight", "1.0", "--report-accuracy", "--seed", "1",
    "--max-tokens", "2000", "--batch-size", "16", "--max-update", "2",
    "--disable-validation", "--log-interval", "1", "--log-format", "json",
    *NO_DROP, *TINY_FLAGS]


@contextlib.contextmanager
def jax_log_handlers():
    """JAX's ``--log-file`` adds a file handler to the ``s2st_tpu`` logger
    for good (logging_utils.py:226-244): taken off again after the run, so
    that the next run's lines go to its own file only."""
    pkg = logging.getLogger("s2st_tpu")
    handlers, level, propagate = list(pkg.handlers), pkg.level, pkg.propagate
    try:
        yield
    finally:
        for h in pkg.handlers:
            if h not in handlers:
                h.close()
        pkg.handlers[:] = handlers
        pkg.setLevel(level)
        pkg.propagate = propagate


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both packages' S2T run and warm-started fine-tune, JAX's init
    patched to the port's seeded weights."""
    from s2st_tpu.cli.train import main as jax_train
    from s2st_tpu_torch.tasks.s2s_translation import build_model_and_loss
    from tests.test_torch_resampling import multi_corpus
    root = tmp_path_factory.mktemp("paper_recipes")
    corpus = multi_corpus(root / "corpus", alpha=0.5)
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, flags, module, attr in (
                ("s2t", S2T_FLAGS, js2t, "init_s2t"),
                ("finetune", FINETUNE_FLAGS, jm, "init_s2st")):
            if name == "finetune":
                flags = flags + ["--load-pretrained-encoder-from", str(
                    root / "s2t_port" / "checkpoint_last.npz")]
            argv = [str(corpus), *flags]
            args = train.get_parser().parse_args(argv)
            _, model, _ = build_model_and_loss(args, 11, 11, 8)
            init = jnp_tree({"stats": {}, **jax_variables(model)})
            mp.setattr(module, attr, lambda *a, init=init, **k: init)
            for pkg, main, extra in (
                    ("port", train.main, ["--device", "cpu"]),
                    ("jax", jax_train, [])):
                save = root / f"{name}_{pkg}"
                save.mkdir()
                with jax_log_handlers():
                    assert main(argv + extra + [
                        "--save-dir", str(save),
                        "--log-file", str(save / "log")]) == 0, (name, pkg)
                runs[name, pkg] = save
    return corpus, runs


def test_s2t_cli_matches_jax_and_resumes_both_ways(cli_runs):
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu.train.optim import adam
    from s2st_tpu.train.trainer import create_train_state
    corpus, runs = cli_runs
    port, ref = runs["s2t", "port"], runs["s2t", "jax"]
    want = _losses(ref / "log", "train_inner_loss")
    got = _losses(port / "log", "loss")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # validation by loss (no --eval-inference for an s2t arch)
    jrec = next(json.loads(line.rsplit(" | ", 1)[-1]) for line in
                (ref / "log").read_text().splitlines()
                if '"valid_loss"' in line)
    valid = _losses(port / "log", "valid")
    assert len(valid) == 1 and "mcd_loss" not in valid[0]
    assert {"valid_" + k for k in valid[0]} == set(jrec)
    for k, v in valid[0].items():
        np.testing.assert_allclose(v, jrec["valid_" + k], atol=1e-4,
                                   rtol=0, err_msg=k)
    # the port resumes from JAX's file and takes a third update
    again = port.parent / "s2t_port_from_jax"
    again.mkdir()
    (again / "checkpoint_last.npz").write_bytes(
        (ref / "checkpoint_last.npz").read_bytes())
    assert train.main([str(corpus), *S2T_FLAGS, "--max-update", "3",
                       "--disable-validation", "--device", "cpu",
                       "--save-dir", str(again), "--log-file",
                       str(again / "log")]) == 0
    assert [r["num_updates"] for r in
            map(json.loads, (again / "log").read_text().splitlines())] == [3]
    # JAX restores the port's checkpoint strictly, Adam's state included
    jcfg = js2t.S2TConfig(base=jm.S2STConfig(
        src_vocab_size=11, tgt_vocab_size=11, input_feat_per_channel=8,
        conv_channels=16, encoder_layers=2, encoder_embed_dim=16,
        encoder_ffn_embed_dim=32, encoder_attention_heads=2,
        decoder_ffn_embed_dim=32, decoder_attention_heads=2,
        max_source_positions=256, dtype=jnp.float32), decoder_layers=2,
        decoder_embed_dim=16)
    tx = adam(betas=(0.9, 0.98))
    state = create_train_state(js2t.init_s2t(jax.random.PRNGKey(0), jcfg,
                                             vocab_size=11), tx)
    state, meta = jckpt.restore_state(state, str(port / "checkpoint_last.npz"))
    assert int(state.step) == meta["step"] == 2


def test_warm_started_two_corpus_finetune_matches_jax(cli_runs):
    _, runs = cli_runs
    port, ref = runs["finetune", "port"], runs["finetune", "jax"]
    want = _losses(ref / "log", "train_inner_loss")
    got = [json.loads(line) for line in (port / "log").read_text()
           .splitlines()]
    assert [r["epoch"] for r in got] == [1, 2]     # one update an epoch
    assert all(r["ctc_loss"] < 100 for r in got)   # every row aligns
    assert len(want) == 2
    np.testing.assert_allclose([r["loss"] for r in got], want, atol=1e-4,
                               rtol=0)
