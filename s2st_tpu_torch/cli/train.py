"""Training: the stage-5 entry point of the port.

Counterpart of the stage-5 part of ``s2st_tpu/cli/train.py::main``
(:28-600) for ``--task s2s_translation --criterion s2st_loss --arch
s2st_transformer``: dictionaries and data config from ``<data>``, a seeded
random model, Adam with the inverse-sqrt schedule as the JAX CLI builds
it, one update per batch, and ``<save-dir>/checkpoint_last.npz`` in the
JAX layout at the end of every epoch and of the run. Runs on CUDA unless
``--device`` names another device. ``--fp16`` computes in bf16 over fp32
parameters.

    python -m s2st_tpu_torch.cli.train <data> --config-yaml config.yaml \\
        --train-subset train --save-dir ckpt --max-tokens 60000 \\
        --max-update 100000 --task s2s_translation --criterion s2st_loss \\
        --arch s2st_transformer <the recipe's stage-5 flags>

Every ``--log-interval`` updates the step's metrics (the loss terms,
``gnorm``, ``lr``, ``step_ms`` on the host clock with the device
synchronised) go to stdout and, with ``--log-file``, to that file as JSON
lines. Flags of later slices raise (``--update-freq`` > 1,
``--restore-file``, ``--eval-inference`` without ``--disable-validation``,
``--use-hubert True``, ``--store-ema``, ``--encoder-layerdrop``,
``--weight-decay``); the log-format, tensorboard, validation and
checkpoint-keeping flags are accepted and ignored with a logged line.
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

import torch

from ..data.data_cfg import S2STDataConfig
from ..data.dictionary import Dictionary
from ..data.s2st_dataset import TrainSplit, to_device
from ..models.config_from_args import add_model_args, model_config
from ..models.jax_bridge import write_jax_checkpoint
from ..models.s2st_transformer import S2STTransformer
from ..nn.core import resolve_device
from ..train.losses import LossConfig
from ..train.optim import schedule_from_args
from ..train.trainer import Trainer

logger = logging.getLogger("s2st_tpu_torch.train")

# accepted for the recipe's command line, with no effect in this port
IGNORED = ("valid_subset", "num_workers", "best_checkpoint_metric",
           "report_accuracy", "skip_invalid_size_inputs_valid_test",
           "log_format", "tensorboard_logdir",
           "validate_after_updates", "keep_best_checkpoints",
           "keep_last_epochs", "load_pretrained_hubert_from")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data")
    p.add_argument("--task", default="s2s_translation",
                   choices=["s2s_translation"])
    p.add_argument("--criterion", default="s2st_loss", choices=["s2st_loss"])
    p.add_argument("--config-yaml", default="config.yaml")
    p.add_argument("--train-subset", default="train")
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--batch-size", "--max-sentences", type=int, default=None)
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
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--lr", default="0.001")
    p.add_argument("--lr-scheduler", default="inverse_sqrt")
    p.add_argument("--warmup-updates", type=int, default=4000)
    p.add_argument("--warmup-init-lr", type=float, default=-1.0)
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--update-freq", default="1")
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
    # later slices: raise when set
    p.add_argument("--restore-file", default=None)
    p.add_argument("--eval-inference", action="store_true")
    p.add_argument("--disable-validation", action="store_true")
    p.add_argument("--store-ema", action="store_true")
    p.add_argument("--encoder-layerdrop", type=float, default=0.0)
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
    later = []
    if [x for x in str(args.update_freq).split(",") if int(x) != 1]:
        later.append("--update-freq > 1 (gradient accumulation)")
    if args.restore_file:
        later.append("--restore-file (resume)")
    if args.eval_inference and not args.disable_validation:
        later.append("--eval-inference without --disable-validation "
                     "(validation)")
    if args.store_ema:
        later.append("--store-ema")
    if args.encoder_layerdrop > 0:
        later.append("--encoder-layerdrop")
    if args.weight_decay != 0.0:
        later.append("--weight-decay")
    if later:
        raise NotImplementedError("not ported yet: " + ", ".join(later))
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


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        stream=sys.stdout)
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    check_args(args)

    data_cfg = S2STDataConfig(Path(args.data) / args.config_yaml)
    dicts = [Dictionary.load(str(Path(args.data) / data_cfg.config[key]))
             for key in ("src_vocab_filename", "tgt_vocab_filename")]
    cfg = model_config(args, len(dicts[0]), len(dicts[1]),
                       data_cfg.input_feat_per_channel)
    split = TrainSplit(args.data, data_cfg, args.train_subset, *dicts,
                       n_frames_per_step=args.n_frames_per_step,
                       seed=args.seed)
    model = S2STTransformer(cfg).init_weights(args.seed).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params:,}; {len(split)} utterances in "
                f"{args.train_subset}; compute {cfg.dtype} on {device}")
    generator = torch.Generator(device).manual_seed(args.seed + 1)
    trainer = Trainer(model, loss_config(args), schedule_from_args(args),
                      clip_norm=args.clip_norm,
                      betas=tuple(float(b) for b in
                                  str(args.adam_betas).strip("()[] ")
                                  .split(",")),
                      eps=args.adam_eps, generator=generator)
    save_path = Path(args.save_dir) / "checkpoint_last.npz"
    if save_path.is_file() and not args.no_save:
        logger.info(f"{save_path} exists and is not resumed (resume is not "
                    f"ported); it will be overwritten")

    def save(epoch: int, num_updates: int):
        if args.no_save:
            return
        save_path.parent.mkdir(parents=True, exist_ok=True)
        write_jax_checkpoint(str(save_path), model, meta={
            "args": args_echo(args), "step": trainer.step, "epoch": epoch,
            "num_updates": num_updates})
        logger.info(f"saved {save_path} (step {trainer.step})")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    max_update = args.max_update or math.inf
    max_epoch = args.max_epoch or math.inf
    num_updates, epoch = 0, 1
    while num_updates < max_update and epoch <= max_epoch:
        batches = split.batches(args.max_tokens, args.batch_size, epoch)
        if not batches:
            raise ValueError(f"no batch of {args.train_subset} fits "
                             f"--max-tokens {args.max_tokens}")
        for indices in batches:
            batch = to_device(split.collate_indices(indices, epoch), device)
            sync()
            t0 = time.perf_counter()
            metrics = trainer.train_step(batch)
            sync()
            step_ms = (time.perf_counter() - t0) * 1e3
            num_updates += 1
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
            if num_updates >= max_update:
                break
        save(epoch, num_updates)
        epoch += 1
    logger.info(f"done training at update {num_updates} (step "
                f"{trainer.step})")
    return 0


def cli_main():
    sys.exit(main())


if __name__ == "__main__":
    cli_main()
