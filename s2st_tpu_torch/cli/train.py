"""Training: stage 5 of the recipe through the port.

Counterpart of ``s2st_tpu/cli/train.py::main`` (:28-600) for ``--task
s2s_translation --criterion s2st_loss --arch s2st_transformer``:
dictionaries and data config from ``<data>``, a seeded random model, Adam
with the inverse-sqrt schedule as the JAX CLI builds it, the JAX CLI's
epoch batches (``data/iterators.py``) grouped by ``--update-freq`` (a list
over epochs, :440), and its checkpoints: resume from
``<save-dir>/checkpoint_last.npz`` or ``--restore-file`` (:234-295, with
``--reset-optimizer`` and ``--reset-dataloader``), ``checkpoint{epoch}``
every ``--save-interval`` epochs, ``checkpoint_{epoch}_{updates}`` every
``--save-interval-updates`` updates with the iterator's position counted
in consumed batches (:522-582), ``checkpoint_last`` each time, the
retention flags, and ``checkpoint_last_ema.npz`` under ``--store-ema``
(:317-339, :409-421). Runs on CUDA unless ``--device`` names another
device. ``--fp16`` computes in bf16 over fp32 parameters.

    python -m s2st_tpu_torch.cli.train <data> --config-yaml config.yaml \\
        --train-subset train --save-dir ckpt --max-tokens 60000 \\
        --max-update 100000 --task s2s_translation --criterion s2st_loss \\
        --arch s2st_transformer <the recipe's stage-5 flags>

Dropout and LayerDrop draw from streams of the port's own, seeded for each
update from (seed, epoch, updates so far) and for each microbatch from its
index, so that a resumed run draws what the uninterrupted run drew (as
JAX's ``fold_in``, :464-465, does for its own stream). Every
``--log-interval`` updates the update's metrics (the loss terms, ``gnorm``,
``lr``, ``step_ms`` on the host clock with the device synchronised) go to
stdout and, with ``--log-file``, to that file as JSON lines.

Validation (``validate``, :601-675) runs on ``--valid-subset`` at the end
of every ``--validate-interval`` epochs and every
``--validate-interval-updates`` updates, from ``--validate-after-updates``
on, never twice at one update: the loss terms weighted by sample size and,
with ``--eval-inference``, ``mcd_loss``, ``ins_rate`` and ``del_rate`` from
the MCD sums of ``tasks/s2s_translation.py`` over whole padded batches. It
prints JAX's ``valid | ...`` line and, with ``--log-file``, a JSON line
``{"valid": {...}, "num_updates": n, "ms": {phase: ms}}``. The value of
``--best-checkpoint-metric`` picks ``checkpoint_best.npz`` (and the
``--keep-best-checkpoints`` files), and drives ``--patience`` and, under
``--lr-scheduler reduce_lr_on_plateau``, the ``--lr-shrink`` of the rate
(:345-375); ``best_val``, ``patience_left`` and ``lr_scale`` ride in each
checkpoint's meta and come back on resume. ``--write-checkpoints-
asynchronously`` raises; the log-format, tensorboard and worker flags are
accepted and ignored with a logged line.

``--use-hubert True`` trains over raw waveforms through the frozen HuBERT
frontend (``--hubert-hidden/-layers/-ffn/-heads``), and
``--load-pretrained-hubert-from`` a fairseq ``.pt`` replaces its random
init before the optimizer is built (:169-180). The frontend's parameters
stay in Adam with zero gradients, as in JAX: their moments stay 0 and
they do not move unless ``--weight-decay`` decays them; they and their
moments are in every checkpoint.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..data.iterators import EpochBatchIterator, GroupedIterator
from ..data.s2st_dataset import TrainSplit, to_device
from ..models.config_from_args import add_model_args, model_config
from ..models.hubert import load_torch_hubert
from ..models.s2st_transformer import S2STTransformer, encoder_layer_keep
from ..nn.core import disable_tf32, resolve_device
from ..train.checkpoint import (CheckpointManager, ema_flat, load_ema,
                                restore_state, state_flat, write_npz)
from ..train.ema import EMAConfig, ema_step, init_ema
from ..train.losses import LossConfig
from ..tasks.s2s_translation import (build_eval_inference_fn, data_config,
                                     load_dictionaries)
from ..train.optim import PLATEAU, schedule_from_args
from ..train.trainer import Trainer
from .generate_waveform import _PhaseClock

logger = logging.getLogger("s2st_tpu_torch.train")

# accepted for the recipe's command line, with no effect in this port
IGNORED = ("num_workers", "report_accuracy", "log_format",
           "tensorboard_logdir")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data")
    p.add_argument("--task", default="s2s_translation",
                   choices=["s2s_translation"])
    p.add_argument("--criterion", default="s2st_loss", choices=["s2st_loss"])
    p.add_argument("--config-yaml", default="config.yaml")
    p.add_argument("--train-subset", default="train")
    p.add_argument("--valid-subset", default="valid")
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--batch-size", "--max-sentences", type=int, default=None)
    p.add_argument("--required-batch-size-multiple", type=int, default=8)
    p.add_argument("--num-batch-buckets", type=int, default=0)
    p.add_argument("--skip-invalid-size-inputs-valid-test",
                   action="store_true")
    p.add_argument("--max-update", type=int, default=0)
    p.add_argument("--max-epoch", type=int, default=0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--log-file", default=None,
                   help="append each logged update's metrics as a JSON line")
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    # optimisation (options.py:499-521)
    p.add_argument("--optimizer", default="adam", choices=["adam"])
    p.add_argument("--adam-betas", default="(0.9, 0.98)")
    p.add_argument("--adam-eps", type=float, default=1e-8)
    p.add_argument("--adam-bf16-stats", action="store_true",
                   help="store Adam's moments in bfloat16")
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--lr", default="0.001")
    p.add_argument("--lr-scheduler", default="inverse_sqrt")
    p.add_argument("--warmup-updates", type=int, default=4000)
    p.add_argument("--warmup-init-lr", type=float, default=-1.0)
    p.add_argument("--lr-shrink", type=float, default=0.1,
                   help="reduce_lr_on_plateau shrink factor")
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--update-freq", default="1")
    p.add_argument("--encoder-layerdrop", type=float, default=0.0)
    # loss (options.py:480-493)
    p.add_argument("--bce-pos-weight", type=float, default=5.0)
    p.add_argument("--use-guided-attention-loss", action="store_true")
    p.add_argument("--guided-attention-loss-sigma", type=float, default=0.4)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--l1-loss-weight", type=float, default=1.0)
    p.add_argument("--mse-loss-weight", type=float, default=1.0)
    p.add_argument("--eos-loss-weight", type=float, default=1.0)
    p.add_argument("--attn-loss-weight", type=float, default=1.0)
    p.add_argument("--sentence-avg", action="store_true")
    # checkpoints (options.py:526-556)
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--restore-file", default="checkpoint_last.npz")
    p.add_argument("--reset-optimizer", action="store_true")
    p.add_argument("--reset-dataloader", action="store_true")
    p.add_argument("--save-interval", type=int, default=1)
    p.add_argument("--save-interval-updates", type=int, default=0)
    p.add_argument("--keep-interval-updates", type=int, default=-1)
    p.add_argument("--keep-best-checkpoints", type=int, default=-1)
    p.add_argument("--keep-last-epochs", type=int, default=-1)
    p.add_argument("--no-epoch-checkpoints", action="store_true")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--best-checkpoint-metric", default="loss")
    p.add_argument("--maximize-best-checkpoint-metric", action="store_true")
    # EMA (options.py:557-562)
    p.add_argument("--store-ema", action="store_true")
    p.add_argument("--ema-decay", type=float, default=0.9999)
    p.add_argument("--ema-start-update", type=int, default=0)
    p.add_argument("--ema-update-freq", type=int, default=1)
    # validation (options.py:80-83, :547-554)
    p.add_argument("--eval-inference", action="store_true")
    p.add_argument("--spec-bwd-max-iter", type=int, default=8)
    p.add_argument("--disable-validation", action="store_true")
    p.add_argument("--validate-after-updates", type=int, default=0)
    p.add_argument("--validate-interval", type=int, default=1)
    p.add_argument("--validate-interval-updates", type=int, default=0)
    p.add_argument("--patience", type=int, default=-1)
    # a later slice: raises
    p.add_argument("--write-checkpoints-asynchronously", "--save-async",
                   action="store_true")
    p.add_argument("--use-flash-attention", action="store_true",
                   help="JAX's switch to its attention kernel; the port takes "
                   "its kernels wherever the function allows (no attention "
                   "weights wanted, no attention dropout active), so this "
                   "flag changes nothing")
    for name in IGNORED:
        p.add_argument("--" + name.replace("_", "-"), nargs="?", const=True,
                       default=None)
    add_model_args(p)
    return p


def check_args(args: argparse.Namespace) -> None:
    """Raise on what this slice does not port; log what it ignores."""
    if args.write_checkpoints_asynchronously:
        raise NotImplementedError("not ported yet: --write-checkpoints-"
                                  "asynchronously (sync saves only)")
    for name in IGNORED:
        if getattr(args, name) is not None:
            logger.info(f"--{name.replace('_', '-')} is accepted and ignored")


def loss_config(args: argparse.Namespace) -> LossConfig:
    return LossConfig(
        bce_pos_weight=args.bce_pos_weight,
        use_guided_attention_loss=args.use_guided_attention_loss,
        guided_attention_loss_sigma=args.guided_attention_loss_sigma,
        label_smoothing=args.label_smoothing, ctc_weight=args.ctc_weight,
        asr_ce_weight=args.asr_ce_weight, st_ce_weight=args.st_ce_weight,
        l1_loss_weight=args.l1_loss_weight,
        mse_loss_weight=args.mse_loss_weight,
        eos_loss_weight=args.eos_loss_weight,
        attn_loss_weight=args.attn_loss_weight,
        sentence_avg=args.sentence_avg)


def args_echo(args: argparse.Namespace) -> dict:
    """The flag namespace a checkpoint carries (cli/train.py:394-398)."""
    return {k: v for k, v in vars(args).items()
            if isinstance(v, (bool, int, float, str, type(None)))}


def stream_seed(*words: int) -> int:
    """A 64-bit seed from integers (numpy's SeedSequence)."""
    return int(np.random.SeedSequence([w % 2 ** 32 for w in words])
               .generate_state(1, np.uint64)[0])


def update_streams(args, cfg, epoch: int, num_updates: int, n: int,
                   device: torch.device):
    """For each of the update's n microbatches, its dropout generator and
    its LayerDrop decisions, from (seed, epoch, updates so far, microbatch),
    as JAX folds the microbatch's index into the update's key
    (s2st_tpu/train/trainer.py:509) and draws each layer's keep from it
    (s2st_tpu/models/s2st_transformer.py:406-412)."""
    gens = [torch.Generator(device).manual_seed(
        stream_seed(0, args.seed, epoch, num_updates, i)) for i in range(n)]
    keeps = [encoder_layer_keep(cfg, torch.Generator().manual_seed(
        stream_seed(1, args.seed, epoch, num_updates, i))) for i in range(n)]
    return gens, keeps


def valid_line(stats: dict) -> str:
    """JAX's ``valid | k v | ...`` line (logging_utils.py:237-247, simple
    format) of the values rounded to 4 decimals."""
    return "valid | " + " | ".join(f"{k} {round(float(v), 4):.4g}"
                                   for k, v in stats.items())


def validate(args, trainer: Trainer, valid_itr: EpochBatchIterator,
             eval_fn, device: torch.device, epoch: int, num_updates: int
             ) -> tuple:
    """One pass over the validation split (cli/train.py:601-675). Each
    batch's loss values are weighted by its sample size; the MCD sums of
    every batch, pad rows included, give mcd_loss, ins_rate and del_rate
    per target frame. Returns (the stats, each phase's summed ms)."""
    agg: dict = {}
    weights: dict = {}
    mcd = {"mcd_loss": 0.0, "targ_frames": 0.0, "pred_frames": 0.0,
           "nins": 0.0, "ndel": 0.0}
    clock = _PhaseClock(device)
    ms: dict = {}

    def lap(name):
        ms[name] = ms.get(name, 0.0) + clock.lap()

    valid_itr.epoch, valid_itr.iterations_in_epoch = 1, 0
    for n, batch in enumerate(valid_itr.next_epoch_itr()):
        batch = to_device(batch, device)
        clock.start()
        metrics = trainer.valid_step(batch, torch.Generator(device).manual_seed(
            stream_seed(2, args.seed, epoch, num_updates, n)))
        lap("loss")
        ss = metrics.get("sample_size", 1.0) or 1.0
        for k, v in metrics.items():
            agg[k] = agg.get(k, 0.0) + v * ss
            weights[k] = weights.get(k, 0.0) + ss
        if eval_fn is not None:
            sums = eval_fn(batch["src_speech"], batch["src_speech_lens"],
                           batch["tgt_speech"], batch["target_lengths"],
                           generator=torch.Generator(device).manual_seed(
                               stream_seed(3, args.seed, epoch, num_updates,
                                           n)), lap=lap)
            for k in mcd:
                mcd[k] += sums[k]
    stats = {k: agg[k] / max(weights[k], 1.0) for k in agg}
    if eval_fn is not None and mcd["targ_frames"] > 0:
        stats["mcd_loss"] = mcd["mcd_loss"] / mcd["targ_frames"]
        stats["ins_rate"] = mcd["nins"] / mcd["targ_frames"]
        stats["del_rate"] = mcd["ndel"] / mcd["targ_frames"]
    return stats, ms


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        stream=sys.stdout)
    args = get_parser().parse_args(argv)
    disable_tf32()
    device = resolve_device(args.device)
    check_args(args)

    data_cfg = data_config(args)
    dicts = load_dictionaries(args.data, data_cfg)
    cfg = model_config(args, len(dicts[0]), len(dicts[1]),
                       data_cfg.input_feat_per_channel)
    split = TrainSplit(args.data, data_cfg, args.train_subset, *dicts,
                       n_frames_per_step=args.n_frames_per_step)
    model = S2STTransformer(cfg).init_weights(args.seed)
    if cfg.use_hubert and args.load_pretrained_hubert_from:
        sd, _ = load_torch_hubert(args.load_pretrained_hubert_from)
        model.encoder.hubert.carry_pretraining(
            {k: tuple(v.shape) for k, v in sd.items()})
        model.encoder.hubert.load_state_dict(sd, strict=True)
        logger.info(f"loaded pretrained hubert from "
                    f"{args.load_pretrained_hubert_from}")
    model = model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params:,}; {len(split)} utterances in "
                f"{args.train_subset}; compute {cfg.dtype} on {device}")
    trainer = Trainer(model, loss_config(args), schedule_from_args(args),
                      clip_norm=args.clip_norm,
                      betas=tuple(float(b) for b in
                                  str(args.adam_betas).strip("()[] ")
                                  .split(",")),
                      eps=args.adam_eps, weight_decay=args.weight_decay,
                      stats_dtype=torch.bfloat16 if args.adam_bf16_stats
                      else None)

    mgr = None if args.no_save else CheckpointManager(
        args.save_dir, args.best_checkpoint_metric,
        args.maximize_best_checkpoint_metric, args.keep_best_checkpoints,
        args.keep_last_epochs, args.keep_interval_updates,
        args.no_epoch_checkpoints)
    # --restore-file: the default name means <save-dir>/checkpoint_last.npz;
    # another is looked for as given, then under --save-dir
    restore_path, restored_from_last = None, False
    if args.restore_file and args.restore_file not in (
            "checkpoint_last.npz", "checkpoint_last.pt"):
        for cand in (Path(args.restore_file),
                     Path(args.save_dir) / args.restore_file):
            if cand.is_file():
                restore_path = str(cand)
                break
        if restore_path is None:
            logger.warning(f"--restore-file {args.restore_file} not found; "
                           f"starting fresh")
    elif mgr is not None:
        restore_path = mgr.last_checkpoint()
        restored_from_last = restore_path is not None
    start_epoch, itr_state, meta = 1, None, {}
    if restore_path:
        meta = restore_state(trainer, restore_path, args.reset_optimizer)
        if not args.reset_dataloader:
            start_epoch = int(meta.get("epoch", 0)) + 1
            itr_state = meta.get("iterator")
        logger.info(f"resumed from {restore_path} at step {trainer.step}")

    epoch_itr = EpochBatchIterator(
        split, args.max_tokens, args.batch_size, seed=args.seed,
        required_batch_size_multiple=args.required_batch_size_multiple,
        max_positions=(args.max_source_positions
                       if args.skip_invalid_size_inputs_valid_test else None),
        num_batch_buckets=args.num_batch_buckets)
    if not epoch_itr.frozen_batches():
        raise ValueError(f"no batch of {args.train_subset} fits "
                         f"--max-tokens {args.max_tokens}")
    if itr_state:
        epoch_itr.load_state_dict(itr_state)
        start_epoch = epoch_itr.epoch
    num_updates = trainer.step
    update_freq = [int(x) for x in str(args.update_freq).split(",")]

    valid_itr = eval_fn = None
    if not args.disable_validation:
        valid_itr = EpochBatchIterator(
            TrainSplit(args.data, data_cfg, args.valid_subset, *dicts,
                       n_frames_per_step=args.n_frames_per_step),
            args.max_tokens, args.batch_size, seed=args.seed,
            required_batch_size_multiple=args.required_batch_size_multiple,
            max_positions=(args.max_source_positions
                           if args.skip_invalid_size_inputs_valid_test
                           else None),
            num_batch_buckets=args.num_batch_buckets, shuffle=False)
        if args.eval_inference:
            eval_fn = build_eval_inference_fn(
                model, data_cfg, args.spec_bwd_max_iter,
                max_iter=max(64, args.max_target_positions
                             // max(args.n_frames_per_step, 1)))

    ema, ema_cfg = None, None
    ema_path = Path(args.save_dir) / "checkpoint_last_ema.npz"
    if args.store_ema:
        ema_cfg = EMAConfig(args.ema_decay, args.ema_start_update,
                            args.ema_update_freq)
        ema = init_ema(trainer.params)
        # the shadow belongs to checkpoint_last: restored only with it
        if restored_from_last and not args.reset_optimizer and \
                ema_path.is_file():
            load_ema(trainer, ema, str(ema_path))
            logger.info(f"restored EMA params from {ema_path}")

    # the validation state (cli/train.py:345-375): the plateau's lr
    # multiplier, the best value so far and the patience left, restored
    # with the optimizer
    st = {"best_val": None, "patience_left": args.patience,
          "lr_scale": 1.0, "stop": False}
    if restore_path and not args.reset_optimizer:
        st["lr_scale"] = float(meta.get("lr_scale", 1.0))
        if meta.get("best_val") is not None:
            st["best_val"] = float(meta["best_val"])
        st["patience_left"] = int(meta.get("patience_left", args.patience))

    def handle_val_result(val):
        """Patience and the plateau shrink (cli/train.py:352-375)."""
        better = st["best_val"] is None or (
            val > st["best_val"] if args.maximize_best_checkpoint_metric
            else val < st["best_val"])
        if better:
            st["best_val"] = val
            st["patience_left"] = args.patience
        else:
            if args.lr_scheduler in PLATEAU:
                st["lr_scale"] *= args.lr_shrink
                logger.info(f"plateau: lr_scale -> {st['lr_scale']:.2e}")
            if args.patience > 0:
                st["patience_left"] -= 1
                if st["patience_left"] <= 0:
                    logger.info(f"early stop: no improvement in "
                                f"{args.patience} validations")
                    st["stop"] = True

    def run_validation(epoch: int) -> Optional[float]:
        stats, ms = validate(args, trainer, valid_itr, eval_fn, device,
                             epoch, num_updates)
        logger.info(valid_line(stats))
        if args.log_file:
            with open(args.log_file, "a") as f:
                f.write(json.dumps({"valid": stats,
                                    "num_updates": num_updates,
                                    "epoch": epoch, "ms": ms}) + "\n")
        val = stats.get(args.best_checkpoint_metric)
        if val is not None:
            handle_val_result(val)
        return val

    echo = args_echo(args)

    def save(epoch: int, itr_sd: dict, end_of_epoch: bool,
             updates: Optional[int] = None,
             val_metric: Optional[float] = None) -> None:
        meta = {"iterator": itr_sd, "lr_scale": st["lr_scale"],
                "best_val": st["best_val"],
                "patience_left": st["patience_left"], "args": echo}
        mgr.save(state_flat(trainer), trainer.step, epoch,
                 val_metric=val_metric, end_of_epoch=end_of_epoch,
                 num_updates=updates, extra_meta=meta)
        if ema is not None:
            write_npz(str(ema_path), ema_flat(trainer, ema))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    max_update = args.max_update or math.inf
    max_epoch = args.max_epoch or math.inf
    # the update count of the last validation: the end of an epoch does
    # not validate again at the update a mid-epoch validation ran at
    last_validated = -1
    epoch, stop = start_epoch, False
    while not stop and epoch <= max_epoch:
        uf = update_freq[min(epoch - 1, len(update_freq) - 1)]
        batches_done = epoch_itr.iterations_in_epoch
        broke_mid_epoch = False
        for group in GroupedIterator(epoch_itr.next_epoch_itr(), uf):
            microbatches = [to_device(b, device) for b in group]
            gens, keeps = update_streams(args, cfg, epoch, num_updates,
                                         len(group), device)
            sync()
            t0 = time.perf_counter()
            metrics = trainer.train_step(microbatches, gens, keeps,
                                         lr_scale=st["lr_scale"])
            sync()
            step_ms = (time.perf_counter() - t0) * 1e3
            num_updates += 1
            batches_done += len(group)
            if ema is not None:
                ema_step(ema_cfg, ema, trainer.params, trainer.step)
            if not math.isfinite(metrics["gnorm"]):
                logger.warning(f"update {num_updates}: non-finite gradient "
                               f"norm; update skipped")
            if num_updates % args.log_interval == 0 or \
                    num_updates >= max_update:
                metrics.update(num_updates=num_updates, epoch=epoch,
                               step_ms=step_ms)
                line = json.dumps(metrics)
                print("train_inner " + line, flush=True)
                if args.log_file:
                    with open(args.log_file, "a") as f:
                        f.write(line + "\n")
            mid_val = None
            if valid_itr is not None and args.validate_interval_updates > 0 \
                    and num_updates % args.validate_interval_updates == 0 \
                    and num_updates >= args.validate_after_updates:
                mid_val = run_validation(epoch)
                last_validated = num_updates
            if mgr is not None and args.save_interval_updates > 0 and \
                    num_updates % args.save_interval_updates == 0:
                # the iterator's position counts consumed batches
                save(epoch, {"epoch": epoch, "iterations_in_epoch":
                             batches_done, "shuffle": True}, False,
                     num_updates, mid_val)
            if num_updates >= max_update or st["stop"]:
                stop = broke_mid_epoch = True
                break
        logger.info(f"end of epoch {epoch} at update {num_updates}")
        val_metric = None
        if valid_itr is not None and epoch % args.validate_interval == 0 \
                and num_updates >= args.validate_after_updates \
                and num_updates != last_validated:
            val_metric = run_validation(epoch)
            last_validated = num_updates
        if st["stop"]:
            stop = True
        if mgr is not None:
            if broke_mid_epoch:
                save(epoch, {"epoch": epoch, "iterations_in_epoch":
                             batches_done, "shuffle": True}, False,
                     num_updates if args.save_interval_updates > 0 else None,
                     val_metric)
            elif epoch % args.save_interval == 0:
                save(epoch, epoch_itr.state_dict(), True,
                     val_metric=val_metric)
        epoch += 1
    logger.info(f"done training at update {num_updates} (step "
                f"{trainer.step})")
    return 0


def cli_main():
    sys.exit(main())


if __name__ == "__main__":
    cli_main()
