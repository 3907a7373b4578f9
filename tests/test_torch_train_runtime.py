"""s2st_tpu_torch's training runtime against s2st_tpu's, fp32 on the CPU.

- Two updates of 2 microbatches each against JAX's ``Trainer.train_step``
  with 2 microbatches, with weight decay 0 and 0.01 and with bf16 Adam
  moments: loss, grad norm, lr, sample size, parameters, postnet
  statistics and Adam's moments (through both packages' checkpoint
  layout, so the ``opt::`` names are held too).
- EMA over 3 updates with ``ema_start_update`` 2 against ``ema_step``.
- The encoder in train mode with ``encoder_layerdrop`` 1.0 against JAX's
  (every layer dropped), and 0.0 against JAX's without LayerDrop. At 0.5
  with 2 microbatches an update, each microbatch draws its own decisions,
  as JAX folds the microbatch's index into the key its encoder draws
  from, and the trainer runs each microbatch with its own.
- ``CheckpointManager``: the files written and removed over 4 saves under
  the retention flags, against JAX's manager.
- ``average_checkpoints`` and the stage-6 CLI, bit-equal to JAX's.
- The train CLIs across packages, both ways: from one init, JAX's CLI runs
  6 updates and saves at update 3, in the middle of epoch 2; the port's
  resumes from that file for the 3 others and matches JAX's run of 6;
  then the other way round.
- The port's CLI with the recipe's stage-5 flags and ``--update-freq 2``,
  dropout on: a run stopped in the middle of an epoch and resumed equals
  the uninterrupted run bit for bit, parameters, Adam state and EMA, and
  the retained files are those of ``--keep-last-epochs 2``.

Tolerances (fp32 both sides, summation order only), as in
``tests/test_torch_train.py``: losses and norms 1e-4 relative; parameters
atol 1e-6 + rtol 1e-5, except the leaves whose gradient is 0 in exact
arithmetic (``ZERO_GRAD``: fp32 noise that Adam scales up to lr a step,
so atol lr per update), the elements whose gradient, as Adam's second
moment gives it, lies within 100 eps of 0 (Adam's step g / (|g| + eps)
turns fp32 noise there into up to lr a step: the same atol, from the
first update at which that held), and the
postnet's running means (``BN_MEAN``, which take such a bias in: 0.1 lr
per earlier update). Adam's moments: 1e-4 of
the leaf's largest plus 1e-4 relative (gradients agree to 1e-4 relative).
With bf16 moments, a moment whose fp32 values fall on either side of a
bf16 rounding boundary differs by one bf16 step (2^-8 relative): moments
within 2^-7 relative, and the parameters of the second update within
lr / 64 (Adam's step is at most about 1.4 in magnitude at update 2, and
one step of a moment moves it by at most 1.5 x 2^-8 of that).
"""

import argparse
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.parallel.mesh import make_mesh
from s2st_tpu.train import checkpoint as jckpt
from s2st_tpu.train import ema as jema
from s2st_tpu.train import losses as jl
from s2st_tpu.train.optim import adam, inverse_sqrt_schedule
from s2st_tpu.train.trainer import Trainer as JaxTrainer
from s2st_tpu.train.trainer import TrainState, create_train_state
from s2st_tpu_torch.cli.train import update_streams
from s2st_tpu_torch.models.s2st_transformer import encoder_layer_keep
from s2st_tpu_torch.train import checkpoint as pckpt
from s2st_tpu_torch.train import ema as pema
from s2st_tpu_torch.train import losses as pl
from s2st_tpu_torch.train.optim import schedule_from_args
from s2st_tpu_torch.train.trainer import Trainer
from tests._torch_port import one_thread, port_model  # noqa: F401
from tests.test_torch_train import (BN_MEAN, LOSS, NO_DROPOUT, TINY_FLAGS,
                                    ZERO_GRAD, _cli_args, port_batch,
                                    train_batch)

LR = 1e-3


@pytest.fixture(scope="module")
def cfg(tiny_cfg):
    return tiny_cfg.replace(**NO_DROPOUT)


def as_f64(arr) -> np.ndarray:
    """Any checkpoint array as float64 (2-byte void = bfloat16 bits)."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V":
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr.astype(np.float64)


def assert_state_close(got, ref, updates, moments_rtol=1e-4,
                       params_atol=1e-6, msg="", noisy=None):
    """Two flat states (params::, stats::, opt::) after ``updates``
    updates at lr LR, with the module's tolerances. noisy: {key: mask} of
    the elements whose gradient was within 100 eps of 0 at an earlier
    update, updated here with this one's."""
    noisy = {} if noisy is None else noisy
    assert set(got) == set(ref), set(got) ^ set(ref)
    for key, r in ref.items():
        g, r = as_f64(got[key]), as_f64(r)
        assert g.shape == r.shape, (msg, key)
        if key.startswith("opt"):
            if ZERO_GRAD.search(key):
                continue            # moments of fp32 noise
            atol = 1e-4 * float(np.abs(r).max()) if r.size else 0.0
            np.testing.assert_allclose(g, r, rtol=moments_rtol, atol=atol,
                                       err_msg=f"{msg} {key}")
            continue
        atol = LR * updates if ZERO_GRAD.search(key) else \
            1e-6 + 0.1 * LR * (updates - 1) if BN_MEAN.search(key) else \
            params_atol
        nu = ref.get(pckpt.opt_key("nu", key)) if key.startswith(
            "params") else None
        if nu is not None:
            # Adam's step g / (|g| + eps): where the gradient it sees is
            # within 100 eps of 0, fp32 noise in g moves it by up to lr
            rms = np.sqrt(as_f64(nu) / (1 - 0.98 ** updates))
            noisy[key] = noisy.get(key, False) | (rms < 100 * 1e-8)
            atol = np.where(noisy[key], LR * updates, atol)
        bad = np.abs(g - r) > atol + 1e-5 * np.abs(r)
        assert not bad.any(), (msg, key, float(np.abs(g - r).max()))


@pytest.mark.parametrize("wd,bf16", [(0.0, False), (0.01, False),
                                     (0.0, True)])
def test_two_updates_of_two_microbatches_match_jax(cfg, tiny_variables, wd,
                                                   bf16):
    variables = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                       tiny_variables)
    tx = adam(betas=(0.9, 0.98), weight_decay=wd,
              stats_dtype=jnp.bfloat16 if bf16 else None)
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    j_tr = JaxTrainer(cfg, jl.LossConfig(**LOSS), tx,
                      inverse_sqrt_schedule(LR, 2, LR), mesh, clip_norm=0.125)
    # committed to the mesh once, so the second update reuses the first's
    # compiles (Trainer.place_state's docstring)
    state = j_tr.place_state(create_train_state(variables, tx))
    model = port_model(cfg, tiny_variables)
    p_tr = Trainer(model, pl.LossConfig(**LOSS),
                   schedule_from_args(_cli_args()), clip_norm=0.125,
                   weight_decay=wd,
                   stats_dtype=torch.bfloat16 if bf16 else None)
    noisy = {}
    for i in range(2):
        micro = [train_batch(cfg, seed=40 + 2 * i),
                 train_batch(cfg, seed=41 + 2 * i)]
        state, j_met = j_tr.train_step(state, micro, jax.random.PRNGKey(i))
        p_met = p_tr.train_step([port_batch(b) for b in micro])
        for key in ("loss", "l1_loss", "aux_st_loss", "gnorm", "lr",
                    "sample_size", "ntokens"):
            assert math.isclose(p_met[key], float(j_met[key]), rel_tol=1e-4,
                                abs_tol=1e-7), (i, key)
        assert p_tr.step == int(state.step) == p_tr.optimizer.count == i + 1
        ref = {k: v for k, v in jckpt._flatten_state(state).items()
               if k != "__meta__"}
        assert_state_close(
            pckpt.state_flat(p_tr), ref, i + 1,
            moments_rtol=2 ** -7 if bf16 else 1e-4,
            params_atol=LR / 64 if bf16 and i else 1e-6, msg=f"update {i}",
            noisy=noisy)
    mu = p_tr.optimizer.mu[0]
    assert mu.dtype == (torch.bfloat16 if bf16 else torch.float32)


@pytest.mark.parametrize("freq", [1, 2])
def test_ema_matches_jax(freq):
    cfg = pema.EMAConfig(ema_decay=0.9, ema_start_update=2,
                         ema_update_freq=freq)
    jcfg = jema.EMAConfig(ema_decay=0.9, ema_start_update=2,
                          ema_update_freq=freq)
    r = np.random.RandomState(0)
    params = [r.randn(5, 3).astype(np.float32), r.randn(7).astype(np.float32)]
    ema = pema.init_ema([torch.from_numpy(p) for p in params])
    jshadow = jema.init_ema({"a": params[0], "b": params[1]})
    for step in (1, 2, 3):
        params = [p + r.randn(*p.shape).astype(np.float32) for p in params]
        pema.ema_step(cfg, ema, [torch.from_numpy(p) for p in params], step)
        jshadow = jema.ema_step(jcfg, jshadow, {"a": params[0],
                                                "b": params[1]},
                                jnp.int32(step))
        for got, ref in zip(ema, (jshadow["a"], jshadow["b"])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-7)
        if step == 1 and freq == 1:
            # before ema_start_update the shadow is the parameters
            assert np.array_equal(ema[0].numpy(), params[0])


@pytest.mark.parametrize("layerdrop", [0.0, 1.0])
def test_encoder_layerdrop_matches_jax(cfg, tiny_variables, layerdrop):
    jcfg = cfg.replace(encoder_layerdrop=layerdrop)
    batch = train_batch(cfg, seed=50)
    j = jm.encode(tiny_variables, jcfg, jnp.asarray(batch["src_speech"]),
                  jnp.asarray(batch["src_speech_lens"]),
                  rng=jax.random.PRNGKey(3), deterministic=False)
    model = port_model(cfg, tiny_variables, encoder_layerdrop=layerdrop)
    keep = encoder_layer_keep(model.cfg, torch.Generator().manual_seed(3))
    assert keep == (None if layerdrop == 0.0 else [False, False])
    with torch.no_grad():
        p = model.encoder(torch.from_numpy(batch["src_speech"]),
                          torch.from_numpy(batch["src_speech_lens"]
                                           .astype(np.int64)),
                          layer_keep=keep)
        full = model.encoder(torch.from_numpy(batch["src_speech"]),
                             torch.from_numpy(batch["src_speech_lens"]
                                              .astype(np.int64)))
    np.testing.assert_allclose(p["encoder_out"].numpy(),
                               np.asarray(j["encoder_out"]), atol=1e-5,
                               rtol=1e-5)
    for got, ref in zip(p["out_middle_layers"], j["out_middle_layers"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
    same = torch.equal(p["encoder_out"], full["encoder_out"])
    assert same == (layerdrop == 0.0)


def test_layerdrop_is_drawn_for_each_microbatch(cfg, tiny_variables):
    model = port_model(cfg, tiny_variables, encoder_layerdrop=0.5)
    args = argparse.Namespace(seed=1)
    cpu = torch.device("cpu")
    draws = [update_streams(args, model.cfg, 2, u, 2, cpu)[1]
             for u in range(8)]
    assert draws == [update_streams(args, model.cfg, 2, u, 2, cpu)[1]
                     for u in range(8)]
    assert all(len(keeps) == 2 and all(len(k) == cfg.encoder_layers
                                       for k in keeps) for keeps in draws)
    assert any(keeps[0] != keeps[1] for keeps in draws)
    assert {d for keeps in draws for k in keeps for d in k} == {False, True}

    micro = [port_batch(train_batch(cfg, seed=60 + i)) for i in range(2)]
    lcfg = pl.LossConfig(**LOSS)
    with torch.no_grad():
        alone = [[pl.s2st_loss(model, lcfg, b, generator=torch.Generator(),
                               layer_keep=[keep] * cfg.encoder_layers)[1]
                  ["logging"]["loss"] for b in micro]
                 for keep in (False, True)]

    def mean_loss(keeps):
        tr = Trainer(port_model(cfg, tiny_variables, encoder_layerdrop=0.5),
                     lcfg, schedule_from_args(_cli_args()))
        return tr.train_step(micro, [torch.Generator(), torch.Generator()],
                             keeps)["loss"]
    drop, keep = [False] * cfg.encoder_layers, [True] * cfg.encoder_layers
    # the update's "loss" is the microbatches' mean (trainer.MEAN_KEYS)
    for keeps, want in (([drop, keep], alone[0][0] + alone[1][1]),
                        ([keep, drop], alone[1][0] + alone[0][1])):
        assert math.isclose(mean_loss(keeps), float(want) / 2, rel_tol=1e-5)
    assert not math.isclose(alone[0][0] + alone[1][1],
                            alone[1][0] + alone[0][1], rel_tol=1e-3)


SAVES = [dict(epoch=1), dict(epoch=2, end_of_epoch=False, num_updates=5),
         dict(epoch=2, end_of_epoch=False, num_updates=6), dict(epoch=3)]
RETENTION = {
    "last_epochs": (dict(keep_last_epochs=2, keep_interval_updates=1),
                    SAVES, None),
    "no_epoch": (dict(no_epoch_checkpoints=True, keep_interval_updates=2),
                 SAVES, None),
    "best": (dict(keep_best_checkpoints=2, keep_last_epochs=1),
             [dict(epoch=e) for e in (1, 2, 3, 4)], [3.0, 2.5, 2.75, 2.0]),
}


@pytest.mark.parametrize("name", sorted(RETENTION))
def test_checkpoint_manager_files_match_jax(tmp_path, name):
    kw, saves, metrics = RETENTION[name]
    jm_ = jckpt.CheckpointManager(str(tmp_path / "jax"), **kw)
    pm = pckpt.CheckpointManager(str(tmp_path / "port"), **kw)
    w = np.arange(3, dtype=np.float32)
    for i, save in enumerate(saves):
        val = metrics[i] if metrics else None
        state = TrainState(params={"w": jnp.asarray(w)}, stats={},
                           opt_state=(), step=jnp.int32(i + 1))
        jm_.save(state, val_metric=val, **save)
        pm.save({"params::w": w}, i + 1, val_metric=val, **save)
        files = sorted(os.listdir(tmp_path / "port"))
        assert files == sorted(os.listdir(tmp_path / "jax")), (i, files)
        assert pckpt.peek_meta(str(tmp_path / "port" /
                                   "checkpoint_last.npz")) == \
            jckpt.peek_meta(str(tmp_path / "jax" / "checkpoint_last.npz"))


def _recipe_argv(corpus, save, *extra):
    """The recipe's stage-5 line (recipes/run_baseline.sh:115-151) at the
    tests' tiny widths, with --update-freq 2 and a 3-row batch."""
    return [str(corpus), "--save-dir", str(save), "--config-yaml",
            "config.yaml", "--train-subset", "train", "--valid-subset",
            "dev", "--num-workers", "4", "--max-tokens", "200",
            "--batch-size", "3", "--task", "s2s_translation",
            "--criterion", "s2st_loss", "--arch", "s2st_transformer",
            "--clip-norm", "1.0", "--bce-pos-weight", "5.0",
            "--dropout", "0.1", "--attention-dropout", "0.1",
            "--activation-dropout", "0.01", "--encoder-normalize-before",
            "--decoder-normalize-before", "--optimizer", "adam", "--lr",
            "1e-3", "--lr-scheduler", "inverse_sqrt", "--warmup-updates",
            "4", "--seed", "1", "--update-freq", "2", "--eval-inference",
            "--best-checkpoint-metric", "mcd_loss", "--use-hubert", "False",
            "--label-smoothing", "0.1", "--asr-ce-weight", "0.3",
            "--st-ce-weight", "0.3", "--report-accuracy",
            "--skip-invalid-size-inputs-valid-test", "--ctc-weight", "0.3",
            "--log-format", "json", "--validate-after-updates", "300000",
            "--disable-validation", "--keep-best-checkpoints", "50",
            "--keep-last-epochs", "2", "--device", "cpu", "--log-interval",
            "1", *TINY_FLAGS, *extra]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.make_tiny_corpus import make_tiny_corpus
    return make_tiny_corpus(tmp_path_factory.mktemp("runtime_corpus"))


@pytest.fixture(scope="module")
def port_run(corpus, tmp_path_factory):
    """The port's CLI, recipe flags, --update-freq 2 and EMA, 3 epochs of
    2 updates: (a) uninterrupted; (b) stopped at update 3 in the middle of
    epoch 2, then resumed from checkpoint_last.npz to the end."""
    from s2st_tpu_torch.cli import train
    root = tmp_path_factory.mktemp("port_run")
    ema = ["--store-ema", "--ema-decay", "0.9", "--ema-start-update", "2"]
    assert train.main(_recipe_argv(corpus, root / "a", "--max-epoch", "3",
                                   *ema)) == 0
    assert train.main(_recipe_argv(corpus, root / "b", "--max-epoch", "3",
                                   "--max-update", "3",
                                   "--save-interval-updates", "3",
                                   *ema)) == 0
    stopped = pckpt.peek_meta(str(root / "b" / "checkpoint_last.npz"))
    assert train.main(_recipe_argv(corpus, root / "b", "--max-epoch", "3",
                                   *ema)) == 0
    return root, stopped


def test_port_resume_mid_epoch_equals_uninterrupted_run(port_run):
    root, stopped = port_run
    assert stopped["step"] == 3 and stopped["iterator"] == {
        "epoch": 2, "iterations_in_epoch": 2, "shuffle": True}
    assert sorted(os.listdir(root / "a")) == [
        "checkpoint2.npz", "checkpoint3.npz", "checkpoint_last.npz",
        "checkpoint_last_ema.npz"]
    assert sorted(os.listdir(root / "b")) == [
        "checkpoint2.npz", "checkpoint3.npz", "checkpoint_2_3.npz",
        "checkpoint_last.npz", "checkpoint_last_ema.npz"]
    for name in ("checkpoint_last.npz", "checkpoint3.npz",
                 "checkpoint_last_ema.npz"):
        a, _ = pckpt.load_checkpoint_file(str(root / "a" / name))
        b, _ = pckpt.load_checkpoint_file(str(root / "b" / name))
        assert set(a) == set(b)
        for key in a:
            assert np.array_equal(a[key], b[key]), (name, key)
    meta = pckpt.peek_meta(str(root / "a" / "checkpoint_last.npz"))
    assert meta["step"] == 6 and meta["epoch"] == 3
    assert meta["iterator"] == {"epoch": 4, "iterations_in_epoch": 0,
                                "shuffle": True}
    ema, _ = pckpt.load_checkpoint_file(
        str(root / "a" / "checkpoint_last_ema.npz"))
    last, _ = pckpt.load_checkpoint_file(
        str(root / "a" / "checkpoint_last.npz"))
    assert {k for k in ema} == {k for k in last
                                if not k.startswith("opt")}
    assert not np.array_equal(ema["params::decoder::feat_proj::w"],
                              last["params::decoder::feat_proj::w"])


def test_average_checkpoints_is_bit_equal_to_jax(port_run, tmp_path):
    from s2st_tpu.cli import average_checkpoints as javg
    from s2st_tpu_torch.cli import average_checkpoints as pavg
    root, _ = port_run
    files = [str(root / "a" / f"checkpoint{e}.npz") for e in (2, 3)]
    got, ref = pckpt.average_checkpoints(files), \
        jckpt.average_checkpoints(files)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        assert np.array_equal(got[key], ref[key]), key
    w = "params::encoder::layer0::fc1::w"
    a, b = (pckpt.load_checkpoint_file(f)[0][w] for f in files)
    assert np.array_equal(got[w], ((a.astype(np.float64) / 2
                                    + b.astype(np.float64) / 2)
                                   .astype(np.float32)))
    # the stage-6 line (recipes/run_baseline.sh:154-158), both packages
    outs = {}
    for name, cli in (("port", pavg), ("jax", javg)):
        outs[name] = tmp_path / f"{name}_avg.npz"
        assert cli.main(["--inputs", str(root / "a"),
                         "--num-epoch-checkpoints", "2", "--output",
                         str(outs[name])]) == 0
    got, _ = pckpt.load_checkpoint_file(str(outs["port"]))
    ref, _ = pckpt.load_checkpoint_file(str(outs["jax"]))
    assert set(got) == set(ref) and all(np.array_equal(got[k], ref[k])
                                        for k in ref)
    with pytest.raises(ValueError, match="need 3"):
        pavg.main(["--inputs", str(root / "a"), "--num-epoch-checkpoints",
                   "3", "--output", str(tmp_path / "x.npz")])


CROSS_FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset", "train",
    "--task", "s2s_translation", "--criterion", "s2st_loss",
    "--arch", "s2st_transformer", "--max-tokens", "200", "--batch-size", "3",
    "--clip-norm", "1.0", "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt",
    "--warmup-updates", "4", "--seed", "1", "--update-freq", "2",
    "--disable-validation", "--log-interval", "1", "--dropout", "0",
    "--attention-dropout", "0", "--activation-dropout", "0",
    "--prenet-dropout", "0", "--postnet-dropout", "0",
    "--bce-pos-weight", "5.0", "--label-smoothing", "0.1",
    "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3", "--ctc-weight", "0.3",
    *TINY_FLAGS]


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """A corpus with SpecAugment on its train split, one init file, and
    the port's CLI run of 6 updates (3 epochs of 2 updates of 2 batches)
    from that init, saving at update 3 (in the middle of epoch 2)."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from tests.make_tiny_corpus import make_tiny_corpus
    root = tmp_path_factory.mktemp("cross")
    corpus = make_tiny_corpus(root / "corpus")
    with open(corpus / "config.yaml", "a") as f:
        f.write("src_transforms:\n  _train:\n  - specaugment\n"
                "specaugment:\n  freq_mask_F: 3\n  freq_mask_N: 1\n"
                "  time_mask_N: 1\n  time_mask_T: 6\n  time_mask_p: 1.0\n")
    args = train.get_parser().parse_args(
        [str(corpus)] + CROSS_FLAGS + ["--device", "cpu"])
    init = root / "init.npz"
    write_jax_checkpoint(str(init), S2STTransformer(
        model_config(args, 11, 11, 8)).init_weights(5))
    assert train.main([str(corpus), *CROSS_FLAGS, "--device", "cpu",
                       "--save-dir", str(root / "port"), "--max-update", "6",
                       "--save-interval-updates", "3", "--restore-file",
                       str(init), "--reset-optimizer",
                       "--reset-dataloader"]) == 0
    return corpus, init, root


def _flat(path):
    return pckpt.load_checkpoint_file(str(path))[0]


def test_jax_cli_run_resumed_by_the_port_matches_jax(cross):
    """JAX runs 6 updates from the init, saving at update 3; the port
    resumes from that file and runs to 6: its checkpoint_last matches
    JAX's."""
    from s2st_tpu.cli.train import main as jax_train
    from s2st_tpu_torch.cli import train
    corpus, init, root = cross
    jdir = root / "jax_from_init"
    assert jax_train([str(corpus), *CROSS_FLAGS,
                      "--save-dir", str(jdir), "--max-update", "6",
                      "--save-interval-updates", "3", "--restore-file",
                      str(init), "--reset-optimizer",
                      "--reset-dataloader"]) == 0
    mid = jdir / "checkpoint_2_3.npz"
    assert pckpt.peek_meta(str(mid))["iterator"]["iterations_in_epoch"] == 2
    pdir = root / "port_from_jax"
    assert train.main([str(corpus), *CROSS_FLAGS, "--device", "cpu",
                       "--save-dir", str(pdir), "--max-update", "6",
                       "--restore-file", str(mid)]) == 0
    assert_state_close(_flat(pdir / "checkpoint_last.npz"),
                       _flat(jdir / "checkpoint_last.npz"), 6)
    # the port's own run from the init agrees with JAX's at both points
    for name in ("checkpoint_2_3.npz", "checkpoint_last.npz"):
        assert_state_close(_flat(root / "port" / name), _flat(jdir / name),
                           3 if "2_3" in name else 6, msg=name)
    got = pckpt.peek_meta(str(pdir / "checkpoint_last.npz"))
    ref = pckpt.peek_meta(str(jdir / "checkpoint_last.npz"))
    for key in ("step", "epoch", "iterator"):
        assert got[key] == ref[key], key


def test_port_cli_run_resumed_by_jax_matches_the_port(cross):
    """The port runs 6 updates from the init, saving at update 3; JAX's
    CLI resumes from the port's file and runs to 6: its checkpoint_last
    matches the port's."""
    from s2st_tpu.cli.train import main as jax_train
    corpus, init, root = cross
    jdir = root / "jax_from_port"
    jdir.mkdir()
    shutil.copy(root / "port" / "checkpoint_2_3.npz",
                jdir / "checkpoint_last.npz")
    assert jax_train([str(corpus), *CROSS_FLAGS,
                      "--save-dir", str(jdir), "--max-update", "6"]) == 0
    assert_state_close(_flat(jdir / "checkpoint_last.npz"),
                       _flat(root / "port" / "checkpoint_last.npz"), 6)
    # stopped by --max-update at the last batch of epoch 3: no epoch file
    got = pckpt.peek_meta(str(jdir / "checkpoint_last.npz"))
    assert got["step"] == 6 and got["iterator"] == {
        "epoch": 3, "iterations_in_epoch": 4, "shuffle": True}
    assert got["iterator"] == pckpt.peek_meta(
        str(root / "port" / "checkpoint_last.npz"))["iterator"]
    assert sorted(os.listdir(jdir)) == ["checkpoint2.npz",
                                        "checkpoint_last.npz"]
