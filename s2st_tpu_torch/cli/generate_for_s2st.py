"""Text generation from the S2ST model's aux decoders: stages 10 and 11.

Counterpart of ``s2st_tpu/cli/generate_for_s2st.py``. ``--scoring wer``
decodes with the aux ASR decoder over encoder tap 0 into the source
dictionary (stage 10, ASR WER); any other scoring decodes with the aux ST
decoder over the last tap into the target dictionary (stage 11, ST BLEU).
The model is rebuilt from the JAX ``.npz`` checkpoint's flag echo
(``__meta__["args"]``). Batches are the JAX CLI's (length order,
``--max-tokens``, ``--batch-size``, a multiple of
``--required-batch-size-multiple``); their padding rows are dropped
before the encoder, since no real row depends on them. Beam search runs
to ``min(200, max_target_positions)`` steps; ``--score-reference`` scores
the references teacher-forced instead. Prints fairseq's S-/T-/H-/D- lines
(P- lines under ``--score-reference``) and ``Generate <split> with
beam=<k>: <score>`` to stdout; with ``--results-path`` each batch's phase
times (encode, beam loop or teacher-forced forward; the device is
synchronised at each phase boundary) and the run's sentences and tokens a
second go to ``<results-path>/timing.json``. Runs on CUDA unless
``--device`` names another device.

    python -m s2st_tpu_torch.cli.generate_for_s2st <data> \\
        --config-yaml config.yaml --gen-subset test --task s2s_translation \\
        --path ckpt.npz --max-tokens 50000 --beam 5 --fp16 \\
        --scoring wer --wer-lowercase --wer-remove-punct

With ``--use-hubert True`` the sources are the split's raw waveforms, as
in training, and the checkpoint's model runs its HuBERT frontend.

Ensembles (``--path a:b``), sampling, diverse beam and siblings search,
constraints and ``--prefix-size`` are not ported and raise.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from ..data.iterators import EpochBatchIterator
from ..data.s2st_dataset import TrainSplit
from ..generate.sequence_generator import (EOS, BeamConfig, beam_search_aux,
                                           score_sequences)
from ..models.config_from_args import (add_model_args, build_model_config,
                                       model_args_from_checkpoint)
from ..models.jax_bridge import read_jax_checkpoint
from ..models.s2st_transformer import cast_for_inference, from_jax_variables
from ..nn.core import disable_tf32, resolve_device
from ..scoring import build_scorer
from ..tasks.s2s_translation import data_config, load_dictionaries
from .generate_waveform import _PhaseClock

logger = logging.getLogger("s2st_tpu_torch.generate_for_s2st")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("data")
    p.add_argument("--task", default="s2s_translation",
                   choices=["s2s_translation"])
    p.add_argument("--config-yaml", default="config.yaml")
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--path", required=True, help="JAX .npz checkpoint")
    p.add_argument("--results-path", default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--batch-size", "--max-sentences", type=int, default=None)
    p.add_argument("--required-batch-size-multiple", type=int, default=8)
    p.add_argument("--num-batch-buckets", type=int, default=0)
    p.add_argument("--skip-invalid-size-inputs-valid-test",
                   action="store_true")
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--nbest", type=int, default=1)
    p.add_argument("--lenpen", type=float, default=1.0)
    p.add_argument("--min-len", type=int, default=1)
    p.add_argument("--no-repeat-ngram-size", type=int, default=0)
    p.add_argument("--scoring", default="sacrebleu")
    p.add_argument("--wer-tokenizer", default="none")
    p.add_argument("--wer-lowercase", action="store_true")
    p.add_argument("--wer-remove-punct", action="store_true")
    p.add_argument("--score-reference", action="store_true")
    # not ported: raise
    p.add_argument("--sampling", action="store_true")
    p.add_argument("--sampling-topk", type=int, default=-1)
    p.add_argument("--sampling-topp", type=float, default=-1.0)
    p.add_argument("--diverse-beam-groups", type=int, default=-1)
    p.add_argument("--diverse-beam-strength", type=float, default=0.5)
    p.add_argument("--diversity-rate", type=float, default=-1.0)
    p.add_argument("--prefix-size", type=int, default=0)
    p.add_argument("--constraints", nargs="?", const="ordered", default=None)
    p.add_argument("--constraints-file", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    add_model_args(p)
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


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        stream=sys.stdout)
    args = get_parser().parse_args(argv)
    _refuse_unported(args)
    disable_tf32()
    device = resolve_device(args.device)

    data_cfg = data_config(args)
    src_dict, tgt_dict = load_dictionaries(args.data, data_cfg)
    variables, meta = read_jax_checkpoint(args.path)
    margs = model_args_from_checkpoint(args, meta)
    params = variables["params"]
    cfg = build_model_config(margs, variables,
                             data_cfg.input_feat_per_channel).replace(
        aux_asr="aux_asr_decoder" in params, aux_st="aux_st_decoder" in params,
        ctc="ctc_proj" in params["decoder"])
    use_asr = args.scoring == "wer"
    which = "aux_asr_decoder" if use_asr else "aux_st_decoder"
    if which not in params:
        raise ValueError(f"{args.path} has no {which}; train with the "
                         f"matching ce-weight")
    model = cast_for_inference(
        from_jax_variables(cfg, variables).to(device).eval(), cfg.dtype)
    dec = getattr(model, which)
    out_dict = src_dict if use_asr else tgt_dict
    logger.info(f"loaded {args.path} (step {meta.get('step', '?')}): "
                f"{which} on {device}, compute {cfg.dtype}")
    bs_cfg = BeamConfig(beam=args.beam,
                        max_len=min(200, cfg.max_target_positions),
                        min_len=args.min_len, len_penalty=args.lenpen,
                        no_repeat_ngram_size=args.no_repeat_ngram_size)
    nbest = min(args.nbest, args.beam)

    split = TrainSplit(args.data, data_cfg, args.gen_subset, src_dict,
                       tgt_dict, n_frames_per_step=cfg.n_frames_per_step)
    itr = EpochBatchIterator(
        split, args.max_tokens, args.batch_size, seed=args.seed,
        required_batch_size_multiple=args.required_batch_size_multiple,
        max_positions=(margs.max_source_positions
                       if args.skip_invalid_size_inputs_valid_test else None),
        num_batch_buckets=args.num_batch_buckets, shuffle=False)
    text_key = "src_text" if use_asr else "tgt_text"
    scorer = build_scorer(args)
    clock = _PhaseClock(device)
    timing = []
    n_done = gen_tokens = 0
    t0 = time.perf_counter()
    for bi, batch in enumerate(itr.next_epoch_itr()):
        ids = batch["id"]
        n_rows = len(ids)
        clock.start()
        src = batch["src_speech"][:n_rows].to(device)
        src_lens = batch["src_speech_lens"][:n_rows].to(device)
        rec = {"batch": bi, "rows": n_rows,
               "src_frames": int(batch["src_speech"].shape[1])}
        enc = model.encode(src, src_lens)
        taps = enc["out_middle_layers"]
        tap = taps[0] if (use_asr or len(taps) == 1) else taps[1]
        pad = enc["encoder_padding_mask"]
        rec["encode_ms"] = clock.lap()
        if args.score_reference:
            toks = batch[text_key][:n_rows]
            lens = batch[f"{text_key}_len"][:n_rows]
            out = score_sequences(dec, tap, pad, toks.to(device),
                                  lens.to(device))
            pos = out["positional_scores"].cpu().numpy()
            sc = out["score"].cpu().numpy()
            rec["forward_ms"] = clock.lap()
            timing.append(rec)
            toks, lens = toks.numpy(), lens.numpy()
            for row, idx in enumerate(ids):
                sid = split.ids[idx]
                ref = split.samples[idx].get(text_key, "")
                n = int(lens[row])
                hyp_ids = toks[row, :n]
                hyp = out_dict.string(hyp_ids[hyp_ids != EOS])
                gen_tokens += n
                print(f"S-{sid}\t{sid}")
                print(f"T-{sid}\t{ref}")
                print(f"H-{sid}\t{sc[row]:.4f}\t{hyp}")
                print(f"P-{sid}\t" + " ".join(f"{x:.4f}"
                                              for x in pos[row, :n]))
                scorer.add_string(ref, hyp)
                n_done += 1
            continue
        out = beam_search_aux(dec, tap, pad, bs_cfg)
        tokens, lengths, scores = (out[k].cpu().numpy()
                                   for k in ("tokens", "lengths", "scores"))
        rec["beam_ms"] = clock.lap()
        rec["decode_steps"] = out["steps"]
        timing.append(rec)
        for row, idx in enumerate(ids):
            sid = split.ids[idx]
            ref = split.samples[idx].get(text_key, "")
            print(f"S-{sid}\t{sid}")
            print(f"T-{sid}\t{ref}")
            for j in range(nbest):
                n = int(lengths[row, j])
                hyp_ids = tokens[row, j, 1:1 + n]
                hyp = out_dict.string(hyp_ids[hyp_ids != EOS][:n])
                print(f"H-{sid}\t{scores[row, j]:.4f}\t{hyp}")
                print(f"D-{sid}\t{scores[row, j]:.4f}\t{hyp}")
                if j == 0:
                    gen_tokens += n
                    scorer.add_string(ref, hyp)
                    n_done += 1
    dt = time.perf_counter() - t0
    logger.info(f"Translated {n_done} sentences ({gen_tokens} tokens) in "
                f"{dt:.1f}s ({n_done / max(dt, 1e-9):.2f} sentences/s, "
                f"{gen_tokens / max(dt, 1e-9):.2f} tokens/s)")
    print(f"Generate {args.gen_subset} with beam={args.beam}: "
          f"{scorer.result_string()}", flush=True)
    if args.results_path:
        Path(args.results_path).mkdir(parents=True, exist_ok=True)
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
