"""Text generation for the LightConv / DynamicConv translation family.

Counterpart of ``s2st_tpu/cli/generate.py`` for ``--task translation`` with
``--arch lightconv*`` / ``dynamicconv*``: reads a fairseq-binarized corpus
and a JAX ``.npz`` checkpoint (the model rebuilt from its flag echo),
beam-decodes the ``--gen-subset`` (or, with ``--score-reference``, scores
its references teacher-forced) and prints fairseq's S-/T-/H-/D-/P- lines
with scores in base 2, the "Translated N sentences (M tokens) in Ts" line
and the "Generate <split> with beam=<k>: BLEU" line. Runs on CUDA unless
``--device`` names another device.

    python -m s2st_tpu_torch.cli.generate <data-bin> --path ckpt.npz \\
        --gen-subset test --batch-size 64 --beam 5 --max-len-a 1.2 \\
        --max-len-b 10 --remove-bpe --fp16 --results-path out

With ``--results-path`` the lines go to ``<results-path>/generate-<split>.txt``
and each batch's phase times (encode, beam loop, or the teacher-forced
forward; the device is synchronised at each phase boundary) with the run's
sentences and target tokens per second to ``<results-path>/timing.json``.
Sampling, diverse search, constraints, prefixes and ensembles (``--path
a:b``) are not ported and raise.
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

from ..data.language_pair_dataset import PAD
from ..generate.sequence_generator import BeamConfig, beam_search
from ..models.config_from_args import model_args_from_checkpoint
from ..models.jax_bridge import load_jax_variables, read_jax_checkpoint
from ..models.lightconv_args import (add_lightconv_model_args, apply_arch,
                                     build_lightconv_config)
from ..models.lightconv_model import LightConvModel, cast_for_inference
from ..nn.core import disable_tf32, resolve_device
from ..scoring import build_scorer
from ..tasks.translation import TranslationTask
from .generate_waveform import _PhaseClock

logger = logging.getLogger("s2st_tpu_torch.generate")


def _str2bool(v) -> bool:
    return str(v).lower() in ("true", "1", "yes", "y")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data")
    p.add_argument("--task", default="translation",
                   choices=["translation", "s2s_translation"])
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--path", required=True, help="JAX .npz checkpoint")
    p.add_argument("--results-path", default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--batch-size", "--max-sentences", type=int, default=None)
    p.add_argument("--required-batch-size-multiple", type=int, default=8)
    p.add_argument("--skip-invalid-size-inputs-valid-test",
                   action="store_true")
    p.add_argument("--source-lang", "-s", default=None)
    p.add_argument("--target-lang", "-t", default=None)
    p.add_argument("--left-pad-source", type=_str2bool, default=True)
    p.add_argument("--left-pad-target", type=_str2bool, default=False)
    p.add_argument("--dataset-impl", default=None, choices=[None, "mmap"])
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--nbest", type=int, default=1)
    p.add_argument("--lenpen", type=float, default=1.0)
    p.add_argument("--min-len", type=int, default=1)
    p.add_argument("--no-repeat-ngram-size", type=int, default=0)
    p.add_argument("--max-len-a", type=float, default=0.0)
    p.add_argument("--max-len-b", type=int, default=200)
    p.add_argument("--remove-bpe", "--post-process", dest="remove_bpe",
                   nargs="?", const="@@ ", default=None)
    p.add_argument("--scoring", default="sacrebleu")
    p.add_argument("--score-reference", action="store_true")
    # refused: later slices
    p.add_argument("--sampling", action="store_true")
    p.add_argument("--diverse-beam-groups", type=int, default=-1)
    p.add_argument("--diversity-rate", type=float, default=-1.0)
    p.add_argument("--prefix-size", type=int, default=0)
    p.add_argument("--constraints", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    add_lightconv_model_args(p)
    return p


def _refuse_unported(args) -> None:
    for flag, on in (("--sampling", args.sampling),
                     ("--diverse-beam-groups", args.diverse_beam_groups > 0),
                     ("--diversity-rate", args.diversity_rate > -1.0),
                     ("--prefix-size", args.prefix_size > 0),
                     ("--constraints", args.constraints is not None),
                     ("--path a:b (ensembles)", ":" in args.path)):
        if on:
            raise NotImplementedError(f"{flag} is not ported")


def beam_config(args, cfg) -> BeamConfig:
    """The JAX CLI's BeamConfig (cli/generate.py:135-165): a static
    max_len of min(max_target_positions - 2, a * max_source_positions + b),
    and per-sentence bounds a * src_len + b when a > 0."""
    b = cfg.base
    static_max = min(b.max_target_positions - 2,
                     int(args.max_len_a * b.max_source_positions
                         + args.max_len_b))
    return BeamConfig(beam=args.beam, max_len=max(static_max, 2),
                      max_len_a=args.max_len_a,
                      max_len_b=(float(args.max_len_b) if args.max_len_a > 0
                                 else -1.0),
                      min_len=args.min_len, len_penalty=args.lenpen,
                      no_repeat_ngram_size=args.no_repeat_ngram_size)


def score_reference(model: LightConvModel, src: torch.Tensor,
                    prev: torch.Tensor, target: torch.Tensor):
    """SequenceScorer: each reference token's log-prob, their mean per
    sentence and the reference lengths (cli/generate.py:233-252)."""
    lp = torch.log_softmax(model(src, prev).float(), dim=-1)
    pos = torch.gather(lp, 2, target[..., None])[..., 0]
    keep = target != PAD
    pos = torch.where(keep, pos, 0.0)
    n = keep.sum(dim=1)
    return pos, pos.sum(dim=1) / n.clamp(min=1), n


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        stream=sys.stdout)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = apply_arch(get_parser().parse_args(argv), argv)
    _refuse_unported(args)
    disable_tf32()
    device = resolve_device(args.device)

    task = TranslationTask.setup_task(args)
    src_dict, tgt_dict = task.src_dict, task.tgt_dict
    variables, meta = read_jax_checkpoint(args.path)
    margs = model_args_from_checkpoint(args, meta)
    cfg = build_lightconv_config(margs, len(src_dict), len(tgt_dict))
    model = LightConvModel(cfg)
    load_jax_variables(model, variables)
    model = cast_for_inference(model.to(device).eval(), cfg.base.dtype)
    logger.info(f"loaded {args.path} (step {meta.get('step', '?')}): "
                f"{margs.arch}, {cfg.conv_type} convs, on {device}, compute "
                f"{cfg.base.dtype}")
    bs_cfg = beam_config(args, cfg)
    nbest = min(args.nbest, args.beam)

    ds = task.load_dataset(args.gen_subset)
    batches = ds.batches(
        args.max_tokens, args.batch_size, args.required_batch_size_multiple,
        args.max_source_positions
        if args.skip_invalid_size_inputs_valid_test else None)
    remove_bpe = args.remove_bpe
    scorer = build_scorer(args)
    out_file = sys.stdout
    if args.results_path:
        Path(args.results_path).mkdir(parents=True, exist_ok=True)
        out_file = open(Path(args.results_path)
                        / f"generate-{args.gen_subset}.txt", "w")
    clock = _PhaseClock(device)
    timing = []
    n_done = gen_tokens = 0
    log2 = math.log(2)
    t0 = time.perf_counter()
    for bi, indices in enumerate(batches):
        batch = ds.collate(indices)
        ids = batch["id"].numpy()
        src_np = batch["src_tokens"].numpy()
        tgt_np = batch["target"].numpy() if "target" in batch else None
        clock.start()
        src = batch["src_tokens"].to(device)
        rec = {"batch": bi, "rows": len(ids),
               "src_tokens": int(src_np.shape[1])}
        if args.score_reference:
            pos, sc, lens = (x.cpu().numpy() for x in score_reference(
                model, src, batch["prev_output_tokens"].to(device),
                batch["target"].to(device)))
            rec["forward_ms"] = clock.lap()
            timing.append(rec)
            for row, sid in enumerate(ids):
                ref = tgt_dict.string(tgt_np[row], remove_bpe,
                                      escape_unk=True)
                hyp = tgt_dict.string(tgt_np[row], remove_bpe)
                n = int(lens[row])
                print(f"S-{sid}\t{src_dict.string(src_np[row], remove_bpe)}",
                      file=out_file)
                print(f"T-{sid}\t{ref}", file=out_file)
                print(f"H-{sid}\t{sc[row] / log2:.4f}\t{hyp}", file=out_file)
                print(f"P-{sid}\t" + " ".join(
                    f"{x / log2:.4f}" for x in pos[row, :n]), file=out_file)
                scorer.add_string(ref, hyp)
                gen_tokens += n
                n_done += 1
            continue
        enc = model.encode(src)
        rec["encode_ms"] = clock.lap()
        k = bs_cfg.beam
        step_fn = model.make_beam_step(
            enc["encoder_out"].repeat_interleave(k, dim=0),
            enc["encoder_padding_mask"].repeat_interleave(k, dim=0))
        out = beam_search(step_fn, model.init_beam_cache(len(ids) * k, device),
                          len(ids), len(tgt_dict), bs_cfg, device,
                          src_lengths=(src != PAD).sum(dim=1))
        rec["beam_ms"] = clock.lap()
        rec["decode_steps"] = out["steps"]
        timing.append(rec)
        tokens, lengths, scores, pos_all = (
            out[name].cpu().numpy()
            for name in ("tokens", "lengths", "scores", "pos_scores"))
        for row, sid in enumerate(ids):
            print(f"S-{sid}\t{src_dict.string(src_np[row], remove_bpe)}",
                  file=out_file)
            ref = None
            if tgt_np is not None:
                ref = tgt_dict.string(tgt_np[row], remove_bpe,
                                      escape_unk=True)
                print(f"T-{sid}\t{ref}", file=out_file)
            for j in range(nbest):
                n = int(lengths[row, j])
                hyp_ids = tokens[row, j, 1:1 + n]
                hyp_ids = hyp_ids[hyp_ids != bs_cfg.eos][:n]
                hyp = tgt_dict.string(hyp_ids, remove_bpe)
                sc2 = scores[row, j] / log2
                print(f"H-{sid}\t{sc2:.4f}\t{tgt_dict.string(hyp_ids)}",
                      file=out_file)
                print(f"D-{sid}\t{sc2:.4f}\t{hyp}", file=out_file)
                print(f"P-{sid}\t" + " ".join(
                    f"{x / log2:.4f}" for x in pos_all[row, j, 1:1 + n]),
                    file=out_file)
                if j == 0:
                    gen_tokens += n
                    if ref is not None:
                        scorer.add_string(ref, hyp)
                    n_done += 1
    dt = time.perf_counter() - t0
    logger.info(f"Translated {n_done} sentences ({gen_tokens} tokens) in "
                f"{dt:.1f}s ({n_done / max(dt, 1e-9):.2f} sentences/s, "
                f"{gen_tokens / max(dt, 1e-9):.2f} tokens/s)")
    line = (f"Generate {args.gen_subset} with beam={args.beam}: "
            f"{scorer.result_string()}")
    print(line, file=out_file)
    if args.results_path:
        out_file.close()
        print(line)
        (Path(args.results_path) / "timing.json").write_text(json.dumps({
            "batches": timing, "sentences": n_done,
            "target_tokens": gen_tokens, "wall_s": dt,
            "sentences_per_s": n_done / max(dt, 1e-9),
            "target_tokens_per_s": gen_tokens / max(dt, 1e-9)}, indent=1))
    return 0


def cli_main():
    sys.exit(main())


if __name__ == "__main__":
    cli_main()
