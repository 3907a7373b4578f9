"""Training: stage 5 of the recipe and the paper's recipes through the port.

Counterpart of ``s2st_tpu/cli/train.py::main`` (:28-600) for ``--task
s2s_translation`` (or ``s2s_translation_mtl``, the same task) with an arch
the port builds (``config_from_args.arch_family``):
dictionaries and data config from ``<data>``, a seeded random model, the
optimizer and schedule as the JAX CLI builds them (``--optimizer`` any of
JAX's registry, with the Adam flags reaching ``adam`` only;
``--lr-scheduler`` any of its names, with only ``--warmup-updates`` and,
for ``inverse_sqrt``, ``--warmup-init-lr`` passed, so that
``polynomial_decay``, ``cosine`` and ``tri_stage`` raise ``TypeError`` as
JAX's do; ``manual`` drives ``lr_scale`` over ``pass_through`` from
``--epoch2lr``/``--update2lr``, :107-133), the JAX CLI's epoch batches
(``data/iterators.py``) collated by ``--num-workers`` threads in a
background thread and put on the device ahead of the update
(``DevicePrefetcher(GroupedIterator(BufferedIterator(...)))``, grouped by
``--update-freq``, a list over epochs, :440-452), and its checkpoints:
resume from ``<save-dir>/checkpoint_last.npz`` or ``--restore-file``
(:234-295, with
``--reset-optimizer`` and ``--reset-dataloader``), ``checkpoint{epoch}``
every ``--save-interval`` epochs, ``checkpoint_{epoch}_{updates}`` every
``--save-interval-updates`` updates with the iterator's position counted
in the batches the loop consumed (:443, :479, :522-582; the iterator's
own count runs ahead of them), ``checkpoint_last`` each time, the
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
``--log-interval`` updates of an epoch ``logging_utils.ProgressLogger``
logs JAX's ``train_inner`` line (``--log-format simple|json|tqdm``, with
``--tensorboard-logdir``, ``--wandb-project``/``--wandb-run-name`` and
``--azureml-logging`` sinks; the values rounded to 4 places, ``ups`` and
``wps``, :491-510), each epoch ends with its ``train`` line (:541-548),
and every ``--log-interval`` updates of the run, with ``--log-file``, the
update's metrics (the loss terms, ``gnorm``, ``lr``, ``step_ms`` on the
host clock with the device synchronised, ``data_ms`` the loop's wait for
its batches) go to that file as JSON lines. A non-finite gradient norm
logs JAX's warning with the non-finite parameters (by their JAX paths)
and batch entries (``utils/diagnostics.py``, :500-505). ``--profile``
traces the first epoch with ``torch.profiler`` (:428-431, :537-539),
``--heartbeat-timeout`` interrupts a run whose update does not finish in
time (:341, :480), ``--find-unused-parameters`` does nothing, as in JAX,
and ``--prng-impl`` names JAX's generator and is ignored with a logged
line (the port's streams are ``torch.Generator``s).

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
checkpoint's meta and come back on resume. ``--eval-bleu`` and its
options are accepted and change nothing, as in JAX, whose validation
scores BLEU only for tasks with ``build_valid_bleu`` (:616-618; not
``s2s_translation``). ``--stop-min-lr`` ends the run at
the end of the first epoch after which the rate of the next update,
``schedule(num_updates + 1) * lr_scale``, is below it (:583-590).

``--write-checkpoints-asynchronously`` (``--save-async``) hands each save
to a background writer (``train/checkpoint.py``): the loop stalls only for
a copy of the state on the device, and the writer copies it to the host,
writes it and applies the retention, in order; the run waits for the
writer before it exits. The files are those of a synchronous run.

``--speaker-to-id`` (a JSON map of the manifest's speakers to ids) adds
encoder and decoder speaker embeddings of ``--speaker-embed-dim`` for max
id + 1 speakers, and each batch carries its rows' ids (an unknown speaker
is 0), as JAX's task and dataset do (tasks/s2s_translation.py:42-43,
:100-103, data/s2st_dataset.py:208-210).

The arch picks the model and its loss, as in JAX (``--criterion`` is
accepted): ``s2st_transformer`` with ``s2st_loss``;
``s2st_transformer_mtl`` (decoder tap 3 by default,
``--middle-layers-decoder``) with the target CTC of ``--ctc-weight-tgt``
in it; ``t2s_transformer`` (the text encoder's
``--encoder-conv-layers/-conv-kernel-size/-dropout/-transformer-layers``)
with ``t2s_loss`` over the batches' source text, its BatchNorms' statistics
written back after each microbatch; an ``s2t_transformer`` arch
(``_hubert``, the s/xs/sp/m/mp/l/lp ladder), ``xm_transformer`` (over raw
waveforms), ``convtransformer[_espnet]`` or ``s2t_berard`` (``_256_3_3``,
``_512_5_3``, ``_512_3_2``), each with its defaults under the flags given,
with ``s2t_loss`` over the target text (``--test-type st``) or the source
text (``asr``); ``tacotron_2`` (or ``tacotron2``) with ``tacotron2_loss``
over the source text, its encoder's and postnet's BatchNorm statistics
written back; or ``fastspeech2`` with ``fastspeech2_loss`` over the source
text and the split's ``duration``, ``pitch`` and ``energy`` columns. A run
of a model other than S2ST validates by its loss, ``--eval-inference``
being for ``s2st*`` archs (:302).
``--load-pretrained-encoder-from`` and ``--load-pretrained-decoder-from``
(a ``.npz`` or a fairseq ``.pt``) then warm-start those components'
parameters, after the frontend's load and before a resume, which wins
(:182-190; ``train/checkpoint.py::load_pretrained_component``). A
``--train-subset`` of comma-separated TSVs concatenates them, and with
``sampling_alpha`` in config.yaml each epoch resamples them by
temperature (``data/s2st_dataset.py``).

``--task hubert_pretraining``, ``audio_pretraining`` and
``audio_finetuning`` (``AUDIO_TASKS``, ``tasks/``) build their model, loss
and raw-audio datasets from a wav2vec manifest, with no ``config.yaml``
(JAX's ``get_task``, :71-74); their validation runs the criterion in eval
(the CTC counters), and resume, retention and ``--save-async`` work as for
the S2ST task.

``--use-hubert True`` trains over raw waveforms through the frozen HuBERT
frontend (``--hubert-hidden/-layers/-ffn/-heads``), and
``--load-pretrained-hubert-from`` a fairseq ``.pt`` replaces its random
init before the optimizer is built (:169-180); for ``xm_transformer`` it
is loaded into the trunk (JAX's CLI puts it under ``params::hubert``,
which that model never reads: ROADMAP §3). The frontend's parameters
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

from ..data.iterators import (BufferedIterator, DevicePrefetcher,
                              EpochBatchIterator, GroupedIterator,
                              device_put)
from ..data.s2st_dataset import TrainSplit, to_device
from ..logging_utils import ProgressLogger
from ..models.config_from_args import (add_model_args, add_speaker_args,
                                       add_wav2vec2_args, apply_arch,
                                       num_speakers, speaker_to_id)
from ..models.hubert import load_torch_hubert
from ..models.s2st_transformer import encoder_layer_keep
from ..nn.core import disable_tf32, resolve_device
from ..train.checkpoint import (CheckpointManager, StateSnapshot,
                                _param_entries, load_ema,
                                load_pretrained_component, restore_state)
from ..train.ema import EMAConfig, ema_step, init_ema
from ..train.losses import LossConfig
from ..tasks.audio_finetuning import AudioFinetuningTask
from ..tasks.audio_pretraining import AudioPretrainingTask
from ..tasks.hubert_pretraining import HubertPretrainingTask
from ..tasks.s2s_translation import (build_eval_inference_fn,
                                     build_model_and_loss, data_config,
                                     load_dictionaries)
from ..train.optim import (OPTIMIZER_REGISTRY, PLATEAU, manual_lr_from_args,
                           optimizer_kwargs, schedule_from_args)
from ..train.trainer import Trainer
from ..utils.diagnostics import (PROFILE_DIR, HeartbeatWatchdog, Profiler,
                                 report_nonfinite)
from .generate_waveform import _PhaseClock

logger = logging.getLogger("s2st_tpu_torch.train")

# accepted for the recipe's command line, with no effect in this port
IGNORED = ("report_accuracy",)
# the tasks over raw audio, by JAX's names (s2st_tpu/cli/train.py:71-74
# looks them up in its registry); they need no config.yaml
AUDIO_TASKS = {"audio_pretraining": AudioPretrainingTask,
               "hubert_pretraining": HubertPretrainingTask,
               "audio_finetuning": AudioFinetuningTask}


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data")
    p.add_argument("--task", default="s2s_translation",
                   choices=["s2s_translation", "s2s_translation_mtl",
                            *AUDIO_TASKS])
    p.add_argument("--criterion", default="s2st_loss",
                   choices=["s2st_loss", "s2st_loss_mtl", "s2t_loss",
                            "t2s_loss", "tacotron2", "tacotron2_loss",
                            "fastspeech2", "fastspeech2_loss", "hubert",
                            "wav2vec", "ctc"],
                   help="the arch (the task, for the audio tasks) binds its "
                   "loss, as in JAX: s2st_loss for the s2st archs, t2s_loss "
                   "for t2s_transformer, tacotron2_loss for tacotron_2, "
                   "fastspeech2_loss for fastspeech2, s2t_loss for the "
                   "text-output archs; hubert, wav2vec and ctc for "
                   "hubert_pretraining, audio_pretraining and "
                   "audio_finetuning")
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
    p.add_argument("--stop-min-lr", type=float, default=-1.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--log-file", default=None,
                   help="append each logged update's metrics as a JSON line")
    p.add_argument("--log-format", default="simple",
                   choices=["simple", "json", "tqdm"])
    p.add_argument("--tensorboard-logdir", default=None)
    p.add_argument("--wandb-project", default=None,
                   help="Weights & Biases project (library-gated sink)")
    p.add_argument("--wandb-run-name", default=None)
    p.add_argument("--azureml-logging", action="store_true",
                   help="log metrics to the AzureML run context")
    p.add_argument("--num-workers", type=int, default=1,
                   help="collate threads (> 1 collates batches in a pool)")
    p.add_argument("--heartbeat-timeout", type=float, default=-1.0,
                   help="SIGINT the job if no update completes in N seconds")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the first epoch")
    p.add_argument("--prng-impl", default="rbg",
                   choices=["rbg", "threefry2x32", "unsafe_rbg"],
                   help="JAX's generator; ignored, the port draws from "
                   "torch.Generator streams")
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    # optimisation (options.py:499-521)
    p.add_argument("--optimizer", default="adam",
                   choices=sorted(OPTIMIZER_REGISTRY))
    p.add_argument("--adam-betas", default="(0.9, 0.98)")
    p.add_argument("--adam-eps", type=float, default=1e-8)
    p.add_argument("--adam-bf16-stats", action="store_true",
                   help="store Adam's moments in bfloat16")
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--lr", default="0.001")
    p.add_argument("--lr-scheduler", default="inverse_sqrt")
    p.add_argument("--epoch2lr", default="{}",
                   help='manual scheduler: epoch->lr dict, keys "5", "1,2" '
                        'or "3-10"')
    p.add_argument("--update2lr", default="{}",
                   help="manual scheduler: update->lr dict, same key syntax")
    p.add_argument("--warmup-updates", type=int, default=4000)
    p.add_argument("--warmup-init-lr", type=float, default=-1.0)
    p.add_argument("--lr-shrink", type=float, default=0.1,
                   help="reduce_lr_on_plateau shrink factor")
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--update-freq", default="1")
    p.add_argument("--find-unused-parameters", action="store_true",
                   help="no effect, as in JAX")
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
    p.add_argument("--load-pretrained-encoder-from", default=None,
                   help="warm-start the encoder from a .npz or fairseq .pt")
    p.add_argument("--load-pretrained-decoder-from", default=None,
                   help="warm-start the decoder from a .npz or fairseq .pt")
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
    # validation-time BLEU (options.py:180-188): no effect on this task
    p.add_argument("--eval-bleu", action="store_true")
    p.add_argument("--eval-bleu-args", default="{}")
    p.add_argument("--eval-bleu-detok", default="space")
    p.add_argument("--eval-bleu-detok-args", default="{}")
    p.add_argument("--eval-bleu-remove-bpe", default=None, nargs="?",
                   const="@@ ")
    p.add_argument("--eval-bleu-print-samples", action="store_true")
    p.add_argument("--write-checkpoints-asynchronously", "--save-async",
                   action="store_true",
                   help="write checkpoints in a background thread")
    p.add_argument("--use-flash-attention", action="store_true",
                   help="JAX's switch to its attention kernel; the port takes "
                   "its kernels wherever the function allows (no attention "
                   "weights wanted, no attention dropout active), so this "
                   "flag changes nothing")
    for name in IGNORED:
        p.add_argument("--" + name.replace("_", "-"), nargs="?", const=True,
                       default=None)
    add_speaker_args(p)
    add_model_args(p)
    add_wav2vec2_args(p)
    return p


def check_args(args: argparse.Namespace) -> None:
    """Log what the port accepts and ignores."""
    for name in IGNORED:
        if getattr(args, name) is not None:
            logger.info(f"--{name.replace('_', '-')} is accepted and ignored")
    if args.prng_impl != "rbg":
        logger.info(f"--prng-impl {args.prng_impl} is accepted and ignored: "
                    "the port draws from torch.Generator streams")


def loss_config(args: argparse.Namespace) -> LossConfig:
    return LossConfig(
        bce_pos_weight=args.bce_pos_weight,
        use_guided_attention_loss=args.use_guided_attention_loss,
        guided_attention_loss_sigma=args.guided_attention_loss_sigma,
        label_smoothing=args.label_smoothing, ctc_weight=args.ctc_weight,
        ctc_weight_tgt=args.ctc_weight_tgt,
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


def load_frontends(args, model) -> None:
    """``--load-pretrained-hubert-from`` into the HuBERT frontend (the
    xm_transformer's trunk), then the component warm starts (:169-190)."""
    frontend = getattr(model.encoder, "hubert", None)
    if frontend is None:    # the xm_transformer's trunk
        frontend = getattr(model.encoder, "w2v_model", None)
    if frontend is not None and args.load_pretrained_hubert_from:
        sd, _ = load_torch_hubert(args.load_pretrained_hubert_from)
        frontend.carry_pretraining({k: tuple(v.shape) for k, v in sd.items()})
        frontend.load_state_dict(sd, strict=True)
        logger.info(f"loaded pretrained hubert from "
                    f"{args.load_pretrained_hubert_from}")
    for path, component in ((args.load_pretrained_encoder_from, "encoder"),
                            (args.load_pretrained_decoder_from, "decoder")):
        if path:
            load_pretrained_component(model, path, component)
            logger.info(f"warm-started {component} from {path}")


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        stream=sys.stdout)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = apply_arch(get_parser().parse_args(argv), argv)
    disable_tf32()
    device = resolve_device(args.device)
    check_args(args)

    audio_task = AUDIO_TASKS[args.task](args) \
        if args.task in AUDIO_TASKS else None
    if audio_task is not None:
        model_cfg, model, loss_fn = audio_task.build_model_and_loss()
        lcfg = audio_task.build_loss_config()
        split = audio_task.load_dataset(args.train_subset)
    else:
        data_cfg = data_config(args)
        dicts = load_dictionaries(args.data, data_cfg)
        model_cfg, model, loss_fn = build_model_and_loss(
            args, len(dicts[0]), len(dicts[1]),
            data_cfg.input_feat_per_channel, num_speakers=num_speakers(args))
        lcfg = loss_config(args)
        speakers = speaker_to_id(args)
        split = TrainSplit(args.data, data_cfg, args.train_subset, *dicts,
                           n_frames_per_step=args.n_frames_per_step,
                           speaker_to_id=speakers, seed=args.seed)
        load_frontends(args, model)
    # the S2ST-shaped config of the dropout streams and the log line (XM
    # has none: its config stands in)
    cfg = getattr(model_cfg, "base", model_cfg)
    model = model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params:,}; {len(split)} utterances in "
                f"{args.train_subset}; compute {cfg.dtype} on {device}")
    trainer = Trainer(model, lcfg, schedule_from_args(args),
                      clip_norm=args.clip_norm, loss_fn=loss_fn,
                      optimizer=args.optimizer,
                      optimizer_kw=optimizer_kwargs(args))
    manual_lr = manual_lr_from_args(args)
    base_lr = float(str(args.lr).split(",")[0])

    mgr = None if args.no_save else CheckpointManager(
        args.save_dir, args.best_checkpoint_metric,
        args.maximize_best_checkpoint_metric, args.keep_best_checkpoints,
        args.keep_last_epochs, args.keep_interval_updates,
        args.no_epoch_checkpoints, args.write_checkpoints_asynchronously)
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
                       if args.skip_invalid_size_inputs_valid_test
                       and audio_task is None else None),
        num_batch_buckets=args.num_batch_buckets,
        num_workers=args.num_workers, pin_memory=device.type == "cuda")
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
            audio_task.load_dataset(args.valid_subset) if audio_task
            else TrainSplit(args.data, data_cfg, args.valid_subset, *dicts,
                            n_frames_per_step=args.n_frames_per_step,
                            speaker_to_id=speakers, seed=args.seed),
            args.max_tokens, args.batch_size, seed=args.seed,
            required_batch_size_multiple=args.required_batch_size_multiple,
            max_positions=(args.max_source_positions
                           if args.skip_invalid_size_inputs_valid_test
                           and audio_task is None else None),
            num_batch_buckets=args.num_batch_buckets, shuffle=False,
            num_workers=args.num_workers)
        if args.eval_inference and args.arch.startswith("s2st"):
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
        progress.print({k: round(float(v), 4) for k, v in stats.items()},
                       tag="valid", step=trainer.step)
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
    progress = ProgressLogger(log_format=args.log_format,
                              log_interval=args.log_interval,
                              tensorboard_logdir=args.tensorboard_logdir,
                              wandb_project=args.wandb_project,
                              wandb_run_name=args.wandb_run_name,
                              azureml_logging=args.azureml_logging)
    # the parameters by their JAX paths, for the non-finite report
    named_params = {key.split("::", 1)[1].replace("::", "/"): p
                    for p, (_, key, _) in zip(trainer.params,
                                              _param_entries(model))}

    def save(epoch: int, itr_sd: dict, end_of_epoch: bool,
             updates: Optional[int] = None,
             val_metric: Optional[float] = None) -> None:
        meta = {"iterator": itr_sd, "lr_scale": st["lr_scale"],
                "best_val": st["best_val"],
                "patience_left": st["patience_left"], "args": echo}
        mgr.save(StateSnapshot(trainer, ema,
                               copy=args.write_checkpoints_asynchronously),
                 trainer.step, epoch, val_metric=val_metric,
                 end_of_epoch=end_of_epoch, num_updates=updates,
                 extra_meta=meta)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    put = device_put(device)
    watchdog = HeartbeatWatchdog(args.heartbeat_timeout).start()
    max_update = args.max_update or math.inf
    max_epoch = args.max_epoch or math.inf
    # the update count of the last validation: the end of an epoch does
    # not validate again at the update a mid-epoch validation ran at
    last_validated = -1
    try:
        epoch, stop = start_epoch, False
        while not stop and epoch <= max_epoch:
            prof = Profiler().start() \
                if args.profile and epoch == start_epoch else None
            uf = update_freq[min(epoch - 1, len(update_freq) - 1)]
            # batches consumed this epoch, taken before next_epoch_itr: the
            # collate thread runs ahead of the loop
            batches_done = epoch_itr.iterations_in_epoch
            broke_mid_epoch = False
            itr = DevicePrefetcher(GroupedIterator(BufferedIterator(
                epoch_itr.next_epoch_itr()), uf), put)
            inner, metrics = {}, {}
            tick, since_log = time.perf_counter(), 0
            t_data = time.perf_counter()
            for i, (group, microbatches) in enumerate(
                    progress.wrap(itr, prefix=f"epoch {epoch:03d}")):
                data_ms = (time.perf_counter() - t_data) * 1e3
                gens, keeps = update_streams(args, cfg, epoch, num_updates,
                                             len(group), device)
                if manual_lr is not None:
                    st["lr_scale"] = manual_lr(epoch, num_updates) \
                        / max(base_lr, 1e-30)
                sync()
                t0 = time.perf_counter()
                metrics = trainer.train_step(microbatches, gens, keeps,
                                             lr_scale=st["lr_scale"])
                sync()
                step_ms = (time.perf_counter() - t0) * 1e3
                num_updates += 1
                since_log += 1
                batches_done += len(group)
                watchdog.beat()
                if ema is not None:
                    ema_step(ema_cfg, ema, trainer.params, trainer.step)
                if not math.isfinite(metrics["gnorm"]):
                    logger.warning(
                        "non-finite gradient norm; update skipped.\n"
                        + report_nonfinite(params=named_params,
                                           batch=group[0]))
                if (i + 1) % args.log_interval == 0:
                    now = time.perf_counter()
                    dt = max(now - tick, 1e-9)
                    inner = dict(metrics, ups=since_log / dt,
                                 wps=metrics.get("sample_size", 0.0)
                                 * since_log / dt)
                    tick, since_log = now, 0
                    progress.log({**{k: round(float(v), 4)
                                     for k, v in inner.items()},
                                  "num_updates": num_updates},
                                 tag="train_inner", step=num_updates)
                if args.log_file and (num_updates % args.log_interval == 0
                                      or num_updates >= max_update):
                    line = dict(metrics, num_updates=num_updates, epoch=epoch,
                                step_ms=step_ms, data_ms=data_ms)
                    with open(args.log_file, "a") as f:
                        f.write(json.dumps(line) + "\n")
                mid_val = None
                if valid_itr is not None and \
                        args.validate_interval_updates > 0 and \
                        num_updates % args.validate_interval_updates == 0 \
                        and num_updates >= args.validate_after_updates:
                    mid_val = run_validation(epoch)
                    last_validated = num_updates
                if mgr is not None and args.save_interval_updates > 0 and \
                        num_updates % args.save_interval_updates == 0:
                    save(epoch, {"epoch": epoch, "iterations_in_epoch":
                                 batches_done, "shuffle": True}, False,
                         num_updates, mid_val)
                if num_updates >= max_update or st["stop"]:
                    stop = broke_mid_epoch = True
                    break
                t_data = time.perf_counter()
            if prof is not None:
                prof.stop()
                logger.info(f"profiler trace at {PROFILE_DIR}")
            progress.print({**{k: round(float(v), 4)
                               for k, v in (inner or metrics).items()},
                            "num_updates": num_updates, "epoch": epoch},
                           tag="train", step=num_updates)
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
                         num_updates if args.save_interval_updates > 0
                         else None,
                         val_metric)
                elif epoch % args.save_interval == 0:
                    save(epoch, epoch_itr.state_dict(), True,
                         val_metric=val_metric)
            if args.stop_min_lr > 0:
                cur_lr = trainer.lr_schedule(num_updates + 1) * st["lr_scale"]
                if cur_lr < args.stop_min_lr:
                    logger.info(f"stopping: lr {cur_lr:.3e} < --stop-min-lr "
                                f"{args.stop_min_lr:.3e}")
                    stop = True
            epoch += 1
    finally:
        watchdog.stop()
    if mgr is not None:
        mgr.wait()      # every submitted save is on disk
    logger.info(f"done training at update {num_updates} (step "
                f"{trainer.step})")
    return 0


def cli_main():
    sys.exit(main())


if __name__ == "__main__":
    cli_main()
