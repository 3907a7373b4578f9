"""Waveform generation: the serving entry point of the port.

Counterpart of ``s2st_tpu/cli/generate_waveform.py`` (stage 7 of
``recipes/run_baseline.sh``): loads a JAX ``.npz`` checkpoint, rebuilds the
model from the checkpoint's flag echo, then for each batch of the split
encodes, decodes autoregressively (or teacher-forces), applies the postnet
and GCMVN denormalisation, runs Griffin-Lim and dumps per-utterance WAVs
and features. Runs on CUDA unless ``--device`` names another device.

    python -m s2st_tpu_torch.cli.generate_waveform <data> \\
        --config-yaml config.yaml --gen-subset tst --path ckpt.npz \\
        --results-path out --spec-bwd-max-iter 64 --fp16 \\
        --dump-waveforms --dump-features --dump-target --dump-plots

With ``--use-hubert True`` (stage 7's line plus that flag, for a model
trained with the HuBERT frontend) the sources are the raw waveforms of the
split's ``src_orig`` (else ``src_audio``) column, padded as JAX's iterator
pads them. Batches are cut as JAX's are, to a multiple of
``--required-batch-size-multiple`` (8) rows where they are larger, and
decoded with JAX's pad rows (``with_pad_rows``).

``--dump-target`` also vocodes each utterance's denormalised target mels
and writes them beside the prediction (``wav/<id>_targ.wav``,
``feat/<id>_targ.npy``); ``--dump-plots`` draws the prediction's (and the
target's) mels into ``plots/<id>.png`` through matplotlib, and warns that
it skipped them where matplotlib is missing, as JAX does
(cli/generate_waveform.py:27-70, :215-240). Each batch's phase times (encode, decode, postnet, vocoder; the device is
synchronised at each phase boundary) go to ``<results-path>/timing.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..data.audio_utils import write_wav
from ..data.iterators import snap_len
from ..data.manifest import GenerationSplit
from ..generate.speech_generator import (GenerationConfig, decode_loop,
                                         postprocess,
                                         teacher_forcing_features)
from ..generate.vocoder import GriffinLimVocoder
from ..models.config_from_args import (add_model_args, build_model_config,
                                       model_args_from_checkpoint)
from ..models.jax_bridge import read_jax_checkpoint
from ..models.s2st_transformer import cast_for_inference, from_jax_variables
from ..nn.core import disable_tf32, resolve_device
from ..tasks.s2s_translation import data_config

logger = logging.getLogger("s2st_tpu_torch.generate_waveform")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data")
    p.add_argument("--task", default="s2s_translation",
                   choices=["s2s_translation"])
    p.add_argument("--config-yaml", default="config.yaml")
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--path", required=True, help="JAX .npz checkpoint")
    p.add_argument("--results-path", required=True)
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--batch-size", "--max-sentences", type=int, default=None)
    p.add_argument("--required-batch-size-multiple", type=int, default=8)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max-iter", type=int, default=1500)
    p.add_argument("--eos-prob-threshold", type=float, default=0.5)
    p.add_argument("--spec-bwd-max-iter", type=int, default=8)
    p.add_argument("--output-sample-rate", type=int, default=16000)
    p.add_argument("--teacher-forcing", action="store_true")
    p.add_argument("--dump-waveforms", action="store_true")
    p.add_argument("--dump-features", action="store_true")
    p.add_argument("--dump-attentions", action="store_true")
    p.add_argument("--dump-eos-probs", action="store_true")
    p.add_argument("--dump-plots", action="store_true")
    p.add_argument("--dump-target", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    add_model_args(p)
    return p


class _PhaseClock:
    """Milliseconds of each phase, with the device synchronised at the
    phase boundaries so that each phase's device work is inside it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        self._sync()
        self.t = time.perf_counter()

    def lap(self) -> float:
        self._sync()
        now = time.perf_counter()
        ms, self.t = (now - self.t) * 1e3, now
        return ms


def _plot(path: Path, pred_feat: np.ndarray,
          targ_feat: Optional[np.ndarray]) -> None:
    """The prediction's (and the target's) mels as one PNG."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(2 if targ_feat is not None else 1, 1)
        axes = np.atleast_1d(axes)
        axes[0].imshow(pred_feat.T, origin="lower", aspect="auto")
        axes[0].set_title("prediction")
        if targ_feat is not None:
            axes[1].imshow(targ_feat.T, origin="lower", aspect="auto")
            axes[1].set_title("target")
        fig.savefig(str(path))
        plt.close(fig)
    except Exception as e:  # matplotlib is optional
        logger.warning(f"plot dump skipped: {e}")


def _dump(args, sample_id: str, wave: Optional[np.ndarray], sample_rate: int,
          feat: np.ndarray, attn: Optional[np.ndarray], eos: np.ndarray,
          targ_wave: Optional[np.ndarray] = None,
          targ_feat: Optional[np.ndarray] = None):
    out = Path(args.results_path)
    for flag, sub, name, arr in (
            (args.dump_features, "feat", f"{sample_id}_pred.npy", feat),
            (args.dump_features, "feat", f"{sample_id}_targ.npy", targ_feat),
            (args.dump_attentions, "attn", f"{sample_id}.npy", attn),
            (args.dump_eos_probs, "eos", f"{sample_id}.npy", eos)):
        if flag and arr is not None:
            (out / sub).mkdir(parents=True, exist_ok=True)
            np.save(str(out / sub / name), arr)
    if args.dump_waveforms and wave is not None:
        (out / "wav").mkdir(parents=True, exist_ok=True)
        write_wav(str(out / "wav" / f"{sample_id}_pred.wav"), wave,
                  sample_rate)
        if targ_wave is not None:
            write_wav(str(out / "wav" / f"{sample_id}_targ.wav"), targ_wave,
                      sample_rate)
    if args.dump_plots:
        (out / "plots").mkdir(parents=True, exist_ok=True)
        _plot(out / "plots" / f"{sample_id}.png", feat, targ_feat)


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        stream=sys.stdout)
    args = get_parser().parse_args(argv)
    disable_tf32()
    device = resolve_device(args.device)

    data_cfg = data_config(args)
    variables, meta = read_jax_checkpoint(args.path.split(":")[0])
    margs = model_args_from_checkpoint(args, meta)
    cfg = build_model_config(margs, variables,
                             data_cfg.input_feat_per_channel)
    model = cast_for_inference(
        from_jax_variables(cfg, variables).to(device).eval(), cfg.dtype)
    logger.info(f"loaded {args.path} (step {meta.get('step', '?')}) on "
                f"{device}, compute {cfg.dtype}")

    vocoder = GriffinLimVocoder.from_data_cfg(data_cfg, args.spec_bwd_max_iter,
                                              device)
    gcmvn_mean = gcmvn_std = None
    stats_path = data_cfg.cmvn_stats_path("tgt_global_cmvn")
    if stats_path is not None:
        stats = np.load(stats_path)
        gcmvn_mean = torch.from_numpy(stats["mean"].astype(np.float32))
        gcmvn_std = torch.from_numpy(stats["std"].astype(np.float32))
    gen_cfg = GenerationConfig(
        max_iter=min(args.max_iter, cfg.max_target_positions
                     // max(cfg.n_frames_per_step, 1)),
        eos_prob_threshold=args.eos_prob_threshold)

    split = GenerationSplit(args.data, data_cfg, args.gen_subset,
                            cfg.n_frames_per_step)
    clock = _PhaseClock(device)
    timing = []
    n_done = 0
    for bi, indices in enumerate(split.batches(
            args.max_tokens, args.batch_size,
            args.required_batch_size_multiple)):
        batch = split.collate(indices, with_target=args.teacher_forcing
                              or args.dump_target)
        gen = torch.Generator(device).manual_seed(args.seed * 100003 + bi)
        clock.start()
        tensors = {k: v.to(device) for k, v in batch.items()
                   if isinstance(v, torch.Tensor)}
        rec = {"batch": bi, "rows": len(indices),
               "src_frames": int(batch["src_speech"].shape[1])}
        if args.teacher_forcing:
            out = teacher_forcing_features(model, tensors, gcmvn_mean,
                                           gcmvn_std, gen)
            rec["forward_ms"] = clock.lap()
        else:
            n = len(indices)
            enc = model.encode(*with_pad_rows(tensors["src_speech"],
                                              tensors["src_speech_lens"]))
            rec["encode_ms"] = clock.lap()
            feats, eos_prob, attn, out_lens, steps = decode_loop(
                model, gen_cfg, enc, generator=gen)
            rec["decode_ms"] = clock.lap()
            rec["decode_steps"] = steps
            out = postprocess(model, feats[:n], eos_prob[:n], out_lens[:n],
                              gcmvn_mean, gcmvn_std)
            out["attn"] = attn[:n]
            rec["postnet_ms"] = clock.lap()
        waves = vocoder(out["feats"], lengths=out["raw_out_lens"],
                        generator=gen)
        rec["vocoder_ms"] = clock.lap()
        timing.append(rec)
        logger.info(f"batch {bi}: {json.dumps(rec)}")

        feats = out["feats"].cpu().numpy()
        raw_lens = out["raw_out_lens"].cpu().numpy()
        step_lens = out["out_lens"].cpu().numpy()
        eos = out["eos_prob"].cpu().numpy()
        attns = out["attn"].cpu().numpy() if out["attn"] is not None \
            else None
        waves = waves.float().cpu().numpy()
        for row, sample_id in enumerate(batch["ids"]):
            n = int(raw_lens[row])
            if n <= 0:
                continue
            targ_feat = targ_wave = None
            if args.dump_target:
                tl = int(batch["target_lengths"][row])
                targ = batch["tgt_speech"][row, :tl].reshape(
                    -1, cfg.output_frame_dim)
                if gcmvn_mean is not None:
                    targ = targ * gcmvn_std + gcmvn_mean
                targ_feat = targ.numpy()
                targ_wave = vocoder(targ[None].to(device),
                                    generator=gen)[0].float().cpu().numpy()
            _dump(args, sample_id, waves[row, :vocoder.wave_length(n)],
                  args.output_sample_rate, feats[row, :n],
                  attns[row, :int(step_lens[row])] if attns is not None
                  else None, eos[row, :n], targ_wave, targ_feat)
            n_done += 1
    Path(args.results_path).mkdir(parents=True, exist_ok=True)
    (Path(args.results_path) / "timing.json").write_text(
        json.dumps(timing, indent=1))
    logger.info(f"dumped {n_done} utterances to {args.results_path}")
    return 0


def with_pad_rows(src: torch.Tensor, lens: torch.Tensor):
    """The batch of n utterances grown to JAX's snap_len(n, 8) rows with
    rows of length 0, as JAX's iterator collates a generation batch
    (s2st_tpu/data/iterators.py:301, data/s2st_dataset.py:241-280). JAX's
    decode loop runs until every row has finished, these too
    (generate/speech_generator.py:120), and the postnet reads two steps
    past each row's end, so a real row's last frames depend on how long
    the pad rows keep the loop running: the port decodes the same rows
    and drops them after the loop."""
    pad = snap_len(src.shape[0], 8) - src.shape[0]
    if pad == 0:
        return src, lens
    return (torch.cat([src, src.new_zeros((pad,) + src.shape[1:])]),
            torch.cat([lens, lens.new_zeros(pad)]))


def cli_main():
    sys.exit(main())


if __name__ == "__main__":
    cli_main()
