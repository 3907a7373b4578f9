"""Asynchronous checkpoint saves, ``--stop-min-lr`` and the ``--eval-bleu``
flags of the port's train CLI, on the CPU.

- ``StateSnapshot(copy=True)`` holds the state of the moment it was taken
  while the optimizer's in-place update changes the live tensors; without
  the copy the same update shows through;
- the ``AsyncWriter`` of ``CheckpointManager``: saves are written in
  submission order, so ``checkpoint_last`` is the newest state even when
  an earlier write is slow; a write's error is raised by the next save and
  by ``wait()``; ``last_checkpoint()`` waits for pending writes;
- the train CLI with ``--write-checkpoints-asynchronously`` (its files
  exist when ``main`` returns, under a slowed writer) writes the same
  arrays and meta as a synchronous run of the same flags
  (``--save-interval-updates``, ``--keep-last-epochs``, ``--store-ema``);
- against JAX's train CLI (one run): ``--stop-min-lr`` ends both after the
  same epoch, at the same update, and with ``--eval-bleu``,
  ``--eval-bleu-print-samples`` and the other ``--eval-bleu-*`` flags the
  ``valid |`` lines are equal and carry no ``bleu``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from s2st_tpu_torch.train import checkpoint as pckpt
from tests._torch_port import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_train import TINY_FLAGS
from tests.test_torch_validate import _run_cli, corpus  # noqa: F401

FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset", "train",
    "--valid-subset", "dev", "--task", "s2s_translation",
    "--criterion", "s2st_loss", "--arch", "s2st_transformer",
    "--max-tokens", "1000", "--batch-size", "12", "--clip-norm", "1.0",
    "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt", "--warmup-updates",
    "1", "--seed", "1", "--log-interval", "1", "--dropout", "0",
    "--attention-dropout", "0", "--activation-dropout", "0",
    "--prenet-dropout", "0", "--postnet-dropout", "0",
    "--bce-pos-weight", "5.0", "--label-smoothing", "0.1",
    "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3", "--ctc-weight", "0.3",
    "--max-epoch", "8", *TINY_FLAGS]
# one update an epoch at lr 1e-3 * update^-0.5: after epoch 3 the next
# update's rate, 5.0e-4, is the first below the floor
STOP = ["--stop-min-lr", "5.5e-4"]
BLEU = ["--eval-bleu", "--eval-bleu-args", '{"beam": 4}',
        "--eval-bleu-detok", "space", "--eval-bleu-remove-bpe",
        "--eval-bleu-print-samples"]


class _Trainer:
    """What ``StateSnapshot`` reads: a model and its optimizer."""

    def __init__(self, seed=0):
        from s2st_tpu_torch.models.s2st_transformer import (S2STConfig,
                                                            S2STTransformer)
        from s2st_tpu_torch.train.optim import Adam
        cfg = S2STConfig(src_vocab_size=9, tgt_vocab_size=9,
                         input_feat_per_channel=8, conv_channels=8,
                         encoder_layers=1, encoder_embed_dim=8,
                         encoder_ffn_embed_dim=8, encoder_attention_heads=2,
                         decoder_layers=1, decoder_embed_dim=8,
                         decoder_ffn_embed_dim=8, decoder_attention_heads=2,
                         output_frame_dim=4, prenet_dim=4,
                         postnet_conv_dim=4, postnet_layers=1,
                         middle_layers=(), dtype=torch.float32)
        self.model = S2STTransformer(cfg).init_weights(seed)
        self.optimizer = Adam(list(self.model.parameters()))

    def update(self):
        grads = [torch.ones_like(p) for p in self.optimizer.params]
        self.optimizer.step(grads, 0.1)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_snapshot_is_the_state_before_the_next_update():
    tr = _Trainer()
    tr.update()
    # host arrays of CPU tensors may share their memory: copies
    before = {k: v.copy() for k, v in pckpt.state_flat(tr).items()}
    ema = [p.detach().clone() for p in tr.optimizer.params]
    snap = pckpt.StateSnapshot(tr, ema, copy=True)
    live = pckpt.StateSnapshot(tr, ema)
    ema_before = {k: v.copy() for k, v in live.ema_flat().items()}
    tr.update()
    torch._foreach_mul_(ema, 2.0)
    _equal(snap.flat(), before)
    _equal(snap.ema_flat(), ema_before)
    moved = live.flat()
    assert any(not np.array_equal(moved[k], before[k]) for k in before)
    assert int(snap.flat()[pckpt.OPT_COUNT]) == 1
    assert int(moved[pckpt.OPT_COUNT]) == 1   # the count is taken, not read


def _slow_first_write(monkeypatch, delay=0.3, fail=None):
    """Slow (or fail) the first write that save_checkpoint_files makes."""
    real, calls = pckpt.save_checkpoint_files, []

    def write(paths, flat, meta):
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            time.sleep(delay)
            if fail is not None:
                raise fail
        real(paths, flat, meta)
    monkeypatch.setattr(pckpt, "save_checkpoint_files", write)
    return calls


def test_writer_keeps_order_and_the_last_checkpoint_is_the_newest(
        tmp_path, monkeypatch):
    calls = _slow_first_write(monkeypatch)
    mgr = pckpt.CheckpointManager(str(tmp_path), keep_last_epochs=2,
                                  write_asynchronously=True)
    for epoch in (1, 2, 3):
        mgr.save({"params::w": np.full(3, epoch, np.float32)}, epoch, epoch)
    # nothing is on disk yet: the first write is still sleeping
    assert not (tmp_path / "checkpoint1.npz").exists()
    last = mgr.last_checkpoint()            # waits for the writer
    flat, meta = pckpt.load_checkpoint_file(last)
    assert meta["step"] == 3 and (flat["params::w"] == 3).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoint2.npz", "checkpoint3.npz", "checkpoint_last.npz"]
    assert calls == ["checkpoint-writer"] * 3


def test_writer_error_is_raised_at_the_next_save_and_wait(tmp_path,
                                                          monkeypatch):
    _slow_first_write(monkeypatch, delay=0.0, fail=OSError("disk full"))
    mgr = pckpt.CheckpointManager(str(tmp_path), write_asynchronously=True)
    mgr.save({"params::w": np.zeros(2, np.float32)}, 1, 1)
    mgr.writer._q.join()
    with pytest.raises(OSError, match="disk full"):
        mgr.save({"params::w": np.ones(2, np.float32)}, 2, 2)
    mgr.save({"params::w": np.ones(2, np.float32)}, 3, 3)
    mgr.wait()                              # the error was raised once
    assert pckpt.peek_meta(str(tmp_path / "checkpoint_last.npz"))["step"] == 3
    _slow_first_write(monkeypatch, delay=0.0, fail=OSError("gone"))
    mgr.save({"params::w": np.ones(2, np.float32)}, 4, 4)
    with pytest.raises(OSError, match="gone"):
        mgr.wait()


def test_async_train_run_writes_the_files_of_a_sync_run(
        corpus, tmp_path, monkeypatch):  # noqa: F811
    from s2st_tpu_torch.cli import train
    flags = [str(corpus), *FLAGS, "--max-update", "4", "--disable-validation",
             "--save-interval-updates", "3", "--keep-last-epochs", "2",
             "--store-ema", "--device", "cpu"]
    assert train.main(flags + ["--save-dir", str(tmp_path / "sync")]) == 0
    _slow_first_write(monkeypatch)
    assert train.main(flags + ["--save-dir", str(tmp_path / "async"),
                               "--save-async"]) == 0
    names = sorted(p.name for p in (tmp_path / "sync").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "async").iterdir())
    # update 4 ends the run inside epoch 4: an update file, no epoch file;
    # checkpoint1 is removed by the retention
    assert names == ["checkpoint2.npz", "checkpoint3.npz",
                     "checkpoint_3_3.npz", "checkpoint_4_4.npz",
                     "checkpoint_last.npz", "checkpoint_last_ema.npz"]
    for name in names:
        a, ma = pckpt.load_checkpoint_file(str(tmp_path / "async" / name))
        s, ms = pckpt.load_checkpoint_file(str(tmp_path / "sync" / name))
        _equal(a, s)
        # the flag echo differs in the two flags that differ
        for m in (ma, ms):
            for key in ("save_dir", "write_checkpoints_asynchronously"):
                m.get("args", {}).pop(key, None)
        assert ma == ms, name


def test_stop_min_lr_and_eval_bleu_match_jax(corpus, tmp_path):  # noqa: F811
    """One JAX run and one port run from one init, both writing
    asynchronously."""
    from s2st_tpu.cli.train import main as jax_train
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    args = train.get_parser().parse_args([str(corpus), *FLAGS])
    init = tmp_path / "init.npz"
    write_jax_checkpoint(str(init), S2STTransformer(
        model_config(args, 11, 11, 8)).init_weights(5))
    flags = [str(corpus), *FLAGS, *STOP, *BLEU, "--save-async",
             "--no-epoch-checkpoints", "--restore-file", str(init),
             "--reset-optimizer", "--reset-dataloader"]
    lines = {}
    for name, fn, extra in (("jax", jax_train, []),
                            ("port", train.main, ["--device", "cpu"])):
        lines[name] = _run_cli(fn, flags + ["--save-dir",
                                            str(tmp_path / name), *extra])
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 3
    assert all("bleu" not in line for line in lines["port"])
    for name in ("jax", "port"):
        meta = pckpt.peek_meta(str(tmp_path / name / "checkpoint_last.npz"))
        assert (meta["step"], meta["epoch"]) == (3, 3), name
