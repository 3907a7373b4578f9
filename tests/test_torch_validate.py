"""s2st_tpu_torch's ``--eval-inference`` validation against s2st_tpu's, on
the CPU.

- ``mfcc`` (the MCD metric's 13 coefficients) within atol 1e-4 + rtol 1e-6
  (the DCT sums 80 log-mels; a silent frame's c0 is -123.6, where 1e-6
  relative is the fp32 ulp times 16), out lengths equal;
  ``rms_dist_matrix`` within rtol 1e-5.
- ``batch_dtw``: insertions and deletions exactly equal, the distortion
  within rtol 1e-5, on unequal lengths, rows with M = 1 or N = 1, integer
  distances that tie on purpose, and rows of length 0.
- ``batch_mcd`` and the eval-inference function's sums within rtol 1e-4,
  with JAX's Griffin-Lim phases fed to the port and prenet dropout 0. JAX's
  function runs its Griffin-Lim in bf16; the test makes both packages run
  it in fp32 (through each package's module attribute, for this test
  only) for the 1e-4 comparison, and holds the bf16 default within 2e-2.
- A padding row (target of length 0) adds a whole 1 x N DTW row to each
  package's MCD sums: its summed distances to ``mcd_loss``, N - 1 to
  ``nins`` and 1 to ``targ_frames`` (a fault of the reference that the port
  reproduces; ROADMAP section 3). The eval-inference comparison above
  feeds a batch with such a row, as validation does.
- ``Trainer.valid_step``'s logging values within atol 1e-5.
- The train CLIs with validation on, from one init, validating every
  update under ``--lr-scheduler reduce_lr_on_plateau --patience 3`` and
  ``--maximize-best-checkpoint-metric`` on ``loss`` (so that later
  validations do not improve): 3 updates of each give the same ``valid``
  lines, the same files and ``checkpoint_best.npz`` and the same plateau
  shrinks; the update-3 checkpoint (in the middle of epoch 2) of either
  package resumes in the other with ``best_val``, ``patience_left`` and
  ``lr_scale`` intact and ends, at the early stop, where the port's own
  uninterrupted run ended. Losses and the best value within 1e-4
  relative, parameters as in ``tests/test_torch_train_runtime.py`` (fp32,
  summation order only) but with atol 1e-4 (``PARAMS_ATOL``, a tenth of
  one update's step).
- The port's CLI with ``--eval-inference --best-checkpoint-metric
  mcd_loss`` writes finite MCD stats and picks its best file by them.
"""

import argparse
import functools
import logging
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.ops import dsp as jdsp
from s2st_tpu.ops import mcd as jmcd
from s2st_tpu_torch.ops import dsp as pdsp
from s2st_tpu_torch.ops import mcd as pmcd
from s2st_tpu_torch.tasks import s2s_translation as p_task
from s2st_tpu_torch.train import checkpoint as pckpt
from tests._torch_port import port_model, t
from tests.conftest import make_batch
from tests.test_torch_train import (LOSS, NO_DROPOUT, TINY_FLAGS,
                                    port_batch)
from tests.test_torch_train_runtime import assert_state_close

JAX_GRIFFIN_LIM = jdsp.griffin_lim


# --------------------------------------------------------------------------
# MFCC, distances, DTW, MCD
# --------------------------------------------------------------------------

def _waves(seed, lengths, total):
    r = np.random.RandomState(seed)
    w = np.zeros((len(lengths), total), np.float32)
    for i, n in enumerate(lengths):
        w[i, :n] = r.randn(n) * 0.3
    return w, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("sr", [16000, 8000])
def test_mfcc_matches_jax(sr):
    w, lens = _waves(1, [5000, 3100, 0], 5000)
    jo, jl = jdsp.mfcc(jnp.asarray(w), jnp.asarray(lens), sr)
    po, pl = pdsp.mfcc(t(w), t(lens).long(), sr)
    assert po.dtype == torch.float32 and po.shape == jo.shape
    assert pl.tolist() == np.asarray(jl).tolist()
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-4,
                               rtol=1e-6)


def test_rms_dist_matrix_matches_jax():
    r = np.random.RandomState(2)
    x1 = r.randn(3, 11, 13).astype(np.float32) * 10
    x2 = r.randn(3, 17, 13).astype(np.float32) * 10
    ref = np.asarray(jmcd.rms_dist_matrix(jnp.asarray(x1), jnp.asarray(x2)))
    got = pmcd.rms_dist_matrix(t(x1), t(x2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


DTW_CASES = {
    # (B, M, N, m_lens, n_lens, integer distances)
    "unequal": (3, 9, 14, [9, 5, 7], [14, 11, 3], False),
    "m1_n1": (4, 6, 8, [1, 6, 1, 3], [8, 1, 1, 1], False),
    "ties": (3, 10, 10, [10, 7, 9], [10, 10, 4], True),
    "pad_rows": (3, 7, 9, [7, 0, 3], [9, 5, 0], True),
}


@pytest.mark.parametrize("case", sorted(DTW_CASES))
def test_batch_dtw_matches_jax(case):
    b, m, n, ml, nl, ints = DTW_CASES[case]
    r = np.random.RandomState(len(case))
    dist = (r.randint(0, 3, (b, m, n)) if ints
            else r.rand(b, m, n) * 5).astype(np.float32)
    ml, nl = np.asarray(ml, np.int32), np.asarray(nl, np.int32)
    jd, ji, jdl = jmcd.batch_dtw(jnp.asarray(dist), jnp.asarray(ml),
                                 jnp.asarray(nl))
    pd, pi, pdl = pmcd.batch_dtw(t(dist), t(ml).long(), t(nl).long())
    assert pi.tolist() == np.asarray(ji).tolist()
    assert pdl.tolist() == np.asarray(jdl).tolist()
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5)


def test_batch_mcd_matches_jax():
    pred, pl = _waves(3, [7000, 6100, 900, 4000], 7000)
    targ, tl = _waves(4, [5000, 3000, 0, 4100], 5000)
    ref = jmcd.batch_mcd(jnp.asarray(pred), jnp.asarray(pl),
                         jnp.asarray(targ), jnp.asarray(tl), 16000)
    got = pmcd.batch_mcd(t(pred), t(pl).long(), t(targ), t(tl).long(), 16000)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4,
                                   err_msg=k)


# --------------------------------------------------------------------------
# the eval-inference function
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tiny corpus, its features block with a 32-sample hop and a
    96-sample window (the keys the eval function reads)."""
    from tests.make_tiny_corpus import make_tiny_corpus
    root = make_tiny_corpus(tmp_path_factory.mktemp("validate_corpus"),
                            n_dev=5)
    cfg = (root / "config.yaml").read_text()
    (root / "config.yaml").write_text(cfg.replace(
        "  n_mels:", "  hop_length: 32\n  win_length: 96\n  n_mels:"))
    return root


@pytest.fixture(scope="module")
def eval_setup(tiny_cfg, tiny_variables, corpus):
    """JAX's and the port's eval functions on the tiny model (output 8
    mels, one frame a step, dropout off), and a batch whose last row is a
    padding row."""
    from s2st_tpu.data.data_cfg import S2STDataConfig as JDataCfg
    from s2st_tpu.tasks.s2s_translation import S2STranslationTask
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.tasks.s2s_translation import build_eval_inference_fn
    cfg = tiny_cfg.replace(**NO_DROPOUT)
    batch = make_batch(cfg, b=3, src_t=29, tgt_t=21, seed=5)
    for k in ("src_speech", "tgt_speech"):
        batch[k][2] = 0.0
    batch["src_speech_lens"][2] = 0
    batch["target_lengths"][2] = 0
    task = S2STranslationTask(argparse.Namespace(spec_bwd_max_iter=3),
                              JDataCfg(corpus / "config.yaml"), None, None)
    model = port_model(cfg, tiny_variables)

    def port_fn():
        return build_eval_inference_fn(
            model, S2STDataConfig(corpus / "config.yaml"), 3, max_iter=32)

    return cfg, batch, task, port_fn


def _jax_sums(cfg, task, variables, batch, rng, gl_dtype, monkeypatch):
    monkeypatch.setattr(jdsp, "griffin_lim", functools.partial(
        JAX_GRIFFIN_LIM, compute_dtype=gl_dtype))
    fn = task.build_eval_inference_fn(cfg, max_iter=32)
    out = fn(variables, *(jnp.asarray(batch[k]) for k in (
        "src_speech", "src_speech_lens", "tgt_speech", "target_lengths")),
        rng)
    return {k: float(out[k]) for k in ("mcd_loss", "targ_frames",
                                       "pred_frames", "nins", "ndel")}


def _port_sums(fn, batch, rng, f_count=65):
    """The port's sums with JAX's Griffin-Lim phases."""
    b = batch["src_speech"].shape[0]
    angles = [t(np.asarray(jax.random.uniform(
        jax.random.fold_in(rng, i), (b, n, f_count), jnp.float32,
        minval=-np.pi, maxval=np.pi)))
        for i, n in ((1, 32), (2, batch["tgt_speech"].shape[1]))]
    return fn(t(batch["src_speech"]), t(batch["src_speech_lens"]).long(),
              t(batch["tgt_speech"]), t(batch["target_lengths"]).long(),
              init_angles=tuple(angles), prenet_dropout=False)


@pytest.mark.parametrize("gl", ["fp32", "bf16"])
def test_eval_inference_sums_match_jax(eval_setup, tiny_variables, gl,
                                       monkeypatch):
    cfg, batch, task, port_fn = eval_setup
    rng = jax.random.PRNGKey(7)
    jdt, pdt, rtol = {"fp32": (jnp.float32, torch.float32, 1e-4),
                      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[gl]
    ref = _jax_sums(cfg, task, tiny_variables, batch, rng, jdt, monkeypatch)
    monkeypatch.setattr(p_task, "griffin_lim", functools.partial(
        p_task.griffin_lim, compute_dtype=pdt))
    got = _port_sums(port_fn(), batch, rng)
    assert set(got) == set(ref)
    for k in ("targ_frames", "pred_frames", "nins", "ndel"):
        assert got[k] == ref[k], k
    np.testing.assert_allclose(got["mcd_loss"], ref["mcd_loss"], rtol=rtol)
    assert ref["nins"] > 0 and ref["mcd_loss"] > 0


def test_pad_row_adds_a_whole_dtw_row_in_both_packages():
    """The reference's pad row in ``batch_mcd``: a target of length 0 has
    1 MFCC frame (1 + 0 // hop), so the row's path is the whole 1 x N row
    of its distances: N - 1 insertions, no deletion, 1 target frame, and
    the row's summed distances in mcd_loss. Row 2 is shorter than the
    others, so taking it out changes no other row."""
    pred, pl = _waves(3, [6000, 5000, 3000], 6000)
    targ, tl = _waves(4, [5000, 4000, 0], 5000)
    n = 1 + 3000 // 200
    shares = {}
    for pkg, fn, conv in (
            ("jax", jmcd.batch_mcd, jnp.asarray),
            ("port", pmcd.batch_mcd, lambda x: t(x) if x.dtype.kind == "f"
             else t(x).long())):
        full = fn(conv(pred), conv(pl), conv(targ), conv(tl), 16000)
        real = fn(conv(pred[:2]), conv(pl[:2]), conv(targ[:2]),
                  conv(tl[:2]), 16000)
        shares[pkg] = {k: float(full[k]) - float(real[k]) for k in full}
    d = shares["port"]
    assert (d["targ_frames"], d["pred_frames"], d["nins"], d["ndel"]) == \
        (1, n, n - 1, 0)
    tm, _ = pdsp.mfcc(t(targ[2:]), t(tl[2:]).long(), 16000)
    pm, _ = pdsp.mfcc(t(pred[2:]), t(pl[2:]).long(), 16000)
    row = pmcd.rms_dist_matrix(tm[:, :1], pm[:, :n])[0, 0]
    np.testing.assert_allclose(d["mcd_loss"], float(row.sum()), rtol=1e-4)
    for k in d:
        np.testing.assert_allclose(d[k], shares["jax"][k], rtol=1e-4,
                                   atol=1e-2, err_msg=k)


def test_valid_step_matches_jax(tiny_cfg, tiny_variables):
    from s2st_tpu.parallel.mesh import make_mesh
    from s2st_tpu.train import losses as jl
    from s2st_tpu.train.optim import adam, inverse_sqrt_schedule
    from s2st_tpu.train.trainer import Trainer as JaxTrainer
    from s2st_tpu.train.trainer import create_train_state
    from s2st_tpu_torch.train import losses as pl
    from s2st_tpu_torch.train.optim import inverse_sqrt_schedule as p_sched
    from s2st_tpu_torch.train.trainer import Trainer
    cfg = tiny_cfg.replace(**NO_DROPOUT)
    batch = make_batch(cfg, b=3, seed=6)
    batch["src_speech_lens"][2] = 0
    batch["target_lengths"][2] = 0
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    tx = adam()
    j_tr = JaxTrainer(cfg, jl.LossConfig(**LOSS), tx,
                      inverse_sqrt_schedule(1e-3, 4, 1e-3), mesh)
    ref = j_tr.valid_step(create_train_state(tiny_variables, tx), batch,
                          jax.random.PRNGKey(0))
    p_tr = Trainer(port_model(cfg, tiny_variables), pl.LossConfig(**LOSS),
                   p_sched(1e-3, 4, 1e-3))
    got = p_tr.valid_step(port_batch(batch), torch.Generator())
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=1e-6,
                                   err_msg=k)


# --------------------------------------------------------------------------
# the train CLIs with validation
# --------------------------------------------------------------------------

VALID_FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset", "train",
    "--valid-subset", "dev", "--task", "s2s_translation",
    "--criterion", "s2st_loss", "--arch", "s2st_transformer",
    "--max-tokens", "1000", "--batch-size", "6", "--clip-norm", "1.0",
    "--lr", "1e-3", "--lr-scheduler", "reduce_lr_on_plateau",
    "--lr-shrink", "0.5", "--warmup-updates", "2", "--seed", "1",
    "--validate-interval-updates", "1", "--patience", "3",
    "--best-checkpoint-metric", "loss", "--maximize-best-checkpoint-metric",
    "--keep-best-checkpoints", "2", "--no-epoch-checkpoints",
    "--log-interval", "1", "--dropout", "0", "--attention-dropout", "0",
    "--activation-dropout", "0", "--prenet-dropout", "0",
    "--postnet-dropout", "0", "--bce-pos-weight", "5.0",
    "--label-smoothing", "0.1", "--asr-ce-weight", "0.3",
    "--st-ce-weight", "0.3", "--ctc-weight", "0.3", *TINY_FLAGS]


# parameters within a tenth of one update's step (lr 1e-3): the decisions
# under test turn on the validation values, and a plateau shrink missed or
# taken twice moves Adam's step, and so the parameters it touches, by 5e-4;
# fp32 noise in small gradients (rms ~5e-5) moves single elements by 3e-5
PARAMS_ATOL = 1e-4


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _run_cli(fn, argv):
    """Run a train CLI; its ``valid | ...`` log lines. The collector sits
    on the two packages' loggers, which see every record of their modules
    once, also after a CLI run with ``--log-file`` in the same process
    turned their propagation to the root logger off."""
    handler, saved = _Collect(), []
    for name in ("s2st_tpu", "s2st_tpu_torch"):
        pkg = logging.getLogger(name)
        saved.append((pkg, pkg.level))
        pkg.addHandler(handler)
        pkg.setLevel(logging.INFO)
    try:
        assert fn(argv) == 0
    finally:
        for pkg, level in saved:
            pkg.removeHandler(handler)
            pkg.setLevel(level)
    return [r.getMessage() for r in handler.records
            if r.getMessage().startswith("valid | ")]


def _saved_files(save_dir):
    """A save directory's file names with the best value of each
    ``checkpoint.best_<metric>_<value>.<updates>.npz`` taken out, and those
    values: they are printed to 3 decimals, so the fp32 noise between the
    packages can flip the last one."""
    names, values = [], []
    for name in sorted(os.listdir(save_dir)):
        m = re.fullmatch(r"(checkpoint\.best_\w+?_)(-?[0-9.]+?)(\.\d+\.npz)",
                         name)
        if m:
            names.append(m.group(1) + "*" + m.group(3))
            values.append(float(m.group(2)))
        else:
            names.append(name)
    return names, values


def _same_end(got_dir, ref_dir):
    """Two runs' checkpoint_last.npz: equal step, iterator and validation
    state, close parameters."""
    got = pckpt.peek_meta(str(got_dir / "checkpoint_last.npz"))
    ref = pckpt.peek_meta(str(ref_dir / "checkpoint_last.npz"))
    for key in ("step", "lr_scale", "patience_left", "iterator"):
        assert got[key] == ref[key], key
    np.testing.assert_allclose(got["best_val"], ref["best_val"], rtol=1e-4)
    assert_state_close(
        pckpt.load_checkpoint_file(str(got_dir / "checkpoint_last.npz"))[0],
        pckpt.load_checkpoint_file(str(ref_dir / "checkpoint_last.npz"))[0],
        ref["step"], params_atol=PARAMS_ATOL)


def test_train_cli_validation_matches_jax(corpus, tmp_path):
    """From one init, 3 updates of each CLI: the same valid lines, files
    and validation state. Then each package resumes the other's update-3
    checkpoint (best_val, patience_left and lr_scale in its meta) until
    the early stop and ends where the port's own uninterrupted run ended.
    An epoch is two batches of 6 of the 12 training utterances (JAX
    compiles at most two train steps and one valid step; its second run
    reads them from JAX's persistent compilation cache), so update 3 is
    inside epoch 2."""
    from s2st_tpu.cli.train import main as jax_train
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    args = train.get_parser().parse_args([str(corpus)] + VALID_FLAGS)
    init = tmp_path / "init.npz"
    write_jax_checkpoint(str(init), S2STTransformer(
        model_config(args, 11, 11, 8)).init_weights(5))
    clis = {"jax": (jax_train, []), "port": (train.main, ["--device", "cpu"])}
    from_init = [str(corpus), *VALID_FLAGS, "--restore-file", str(init),
                 "--reset-optimizer", "--reset-dataloader",
                 "--save-interval-updates", "3"]
    lines = {}
    for name, (fn, extra) in clis.items():
        lines[name] = _run_cli(fn, [*from_init, "--save-dir",
                                    str(tmp_path / name), "--max-update",
                                    "3", *extra])
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 3
    assert all(" | loss " in line and " | sample_size " in line
               for line in lines["port"])
    files = {name: _saved_files(tmp_path / name) for name in clis}
    assert files["port"][0] == files["jax"][0]
    np.testing.assert_allclose(files["port"][1], files["jax"][1], atol=1e-3)
    best = {}
    for name in clis:
        best[name] = pckpt.peek_meta(
            str(tmp_path / name / "checkpoint_best.npz"))
    assert best["port"]["step"] == best["jax"]["step"]
    np.testing.assert_allclose(best["port"]["val_metric"],
                               best["jax"]["val_metric"], rtol=1e-4)
    _same_end(tmp_path / "port", tmp_path / "jax")
    # JAX's manager keeps its own best, empty at the start, and sees only
    # the validations of saves: update 3's (the first save) writes
    # checkpoint_best although update 1's value was the better one
    assert best["jax"]["step"] == 3 and \
        best["jax"]["val_metric"] < best["jax"]["best_val"]
    mid = "checkpoint_2_3.npz"       # in epoch 2, after its first batch
    meta = pckpt.peek_meta(str(tmp_path / "jax" / mid))
    assert meta["step"] == 3 and meta["lr_scale"] == 0.25 \
        and meta["patience_left"] == 1 and meta["best_val"] is not None

    full = tmp_path / "port_full"
    whole = _run_cli(train.main, [*from_init, "--save-dir", str(full),
                                  "--max-update", "8", "--device", "cpu"])
    assert whole[:3] == lines["port"] and len(whole) >= 4
    last = pckpt.peek_meta(str(full / "checkpoint_last.npz"))
    # the plateau shrank the rate and the patience ran out before update 8
    assert last["lr_scale"] < 0.25 and last["patience_left"] == 0
    assert last["step"] < 8
    for src, dst in (("jax", "port"), ("port", "jax")):
        work = tmp_path / f"{src}_to_{dst}"
        work.mkdir()
        shutil.copy(tmp_path / src / mid, work / "checkpoint_last.npz")
        fn, extra = clis[dst]
        resumed = _run_cli(fn, [str(corpus), *VALID_FLAGS, "--save-dir",
                                str(work), "--save-interval-updates", "3",
                                "--max-update", "8", *extra])
        assert resumed == whole[3:], (src, dst)
        _same_end(work, full)


def test_port_cli_validates_with_eval_inference(corpus, tmp_path):
    import json
    from s2st_tpu_torch.cli import train
    flags = [f for f in VALID_FLAGS if f != "--maximize-best-checkpoint-metric"]
    i = flags.index("--best-checkpoint-metric")
    flags[i + 1] = "mcd_loss"
    log = tmp_path / "log.jsonl"
    assert train.main([str(corpus), *flags, "--eval-inference",
                       "--spec-bwd-max-iter", "2", "--max-target-positions",
                       "64", "--save-dir", str(tmp_path / "ckpt"),
                       "--max-update", "2", "--save-interval-updates", "1",
                       "--device", "cpu",
                       "--log-file", str(log)]) == 0
    valid = [json.loads(line) for line in log.read_text().splitlines()
             if '"valid"' in line]
    assert [v["num_updates"] for v in valid] == [1, 2]
    for v in valid:
        for k in ("loss", "mcd_loss", "ins_rate", "del_rate"):
            assert np.isfinite(v["valid"][k]), k
        assert set(v["ms"]) == {"loss", "decode", "griffin_lim", "mfcc",
                                "dtw"}
    best = min(valid, key=lambda v: v["valid"]["mcd_loss"])
    meta = pckpt.peek_meta(str(tmp_path / "ckpt" / "checkpoint_best.npz"))
    assert meta["step"] == best["num_updates"]
    np.testing.assert_allclose(meta["best_val"],
                               best["valid"]["mcd_loss"], rtol=1e-6)
