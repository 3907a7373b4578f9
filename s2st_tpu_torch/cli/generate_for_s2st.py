"""Text generation from the S2ST model's aux decoders: stages 10 and 11.

Counterpart of ``s2st_tpu/cli/generate_for_s2st.py``. ``--scoring wer``
decodes with the aux ASR decoder over encoder tap 0 into the source
dictionary (stage 10, ASR WER); any other scoring decodes with the aux ST
decoder over the last tap into the target dictionary (stage 11, ST BLEU).
The model is rebuilt from the JAX ``.npz`` checkpoint's flag echo
(``__meta__["args"]``), or, for a fairseq ``.pt``, from the command line's
flags with the vocabularies and heads of the file's arrays
(``models/fairseq_checkpoint.py``). Batches are the JAX CLI's (length
order, ``--max-tokens``, ``--batch-size``, a multiple of
``--required-batch-size-multiple``); their padding rows are dropped
before the encoder, since no real row depends on them. Beam search runs
to ``min(200, max_target_positions)`` steps; ``--score-reference`` scores
the references teacher-forced instead. Prints fairseq's S-/T-/H-/D- lines
(P- lines under ``--score-reference``, C- lines under ``--constraints``)
and ``Generate <split> with beam=<k>: <score>`` to stdout; with
``--results-path`` each batch's phase times (encode, beam loop or
teacher-forced forward; the device is synchronised at each phase boundary)
and the run's sentences and tokens a second go to
``<results-path>/timing.json``. Runs on CUDA unless ``--device`` names
another device.

    python -m s2st_tpu_torch.cli.generate_for_s2st <data> \\
        --config-yaml config.yaml --gen-subset test --task s2s_translation \\
        --path ckpt.npz --max-tokens 50000 --beam 5 --fp16 \\
        --scoring wer --wer-lowercase --wer-remove-punct

With ``--use-hubert True`` the sources are the split's raw waveforms, as
in training, and the checkpoint's model runs its HuBERT frontend.

Search, as JAX's CLI chooses it (fairseq's ``build_generator``):
``--sampling`` (``--sampling-topk`` / ``--sampling-topp``; the Gumbel noise
from a ``torch.Generator`` on the device seeded with ``--seed``, so the
draws are not JAX's), else ``--diverse-beam-groups G``
(``--diverse-beam-strength``), else ``--diversity-rate`` (diverse
siblings), else beam search. ``--prefix-size N`` forces the first N
tokens of each reference; ``--constraints ordered|unordered`` with
``--constraints-file`` (``<id>\t<phrase>\t<phrase>...``, phrases in the
decoding dictionary; tables built once over the file) decodes under
lexical constraints. ``--path a:b`` decodes with the ensemble of the
checkpoints (each model encodes the batch once; their log-probs averaged
in probability).
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
from ..generate.constrained import build_constraint_tables, pack_constraints
from ..generate.sequence_generator import (EOS, BeamConfig, GumbelNoise,
                                           beam_search_aux, score_sequences)
from ..models.config_from_args import (add_model_args,
                                       add_model_overrides_arg,
                                       build_model_config,
                                       model_args_from_checkpoint)
from ..models.fairseq_checkpoint import (is_torch_checkpoint, s2st_config,
                                         s2st_from_fairseq, s2st_state_dict)
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
    p.add_argument("--path", required=True,
                   help="JAX .npz or fairseq .pt checkpoint; a:b an "
                        "ensemble")
    add_model_overrides_arg(p)
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
    add_search_args(p)
    p.add_argument("--constraints", choices=["ordered", "unordered"],
                   default=None)
    p.add_argument("--constraints-file", default=None,
                   help="<utt_id>\\t<phrase>\\t<phrase>... a line")
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    add_model_args(p)
    return p


def add_search_args(p: argparse.ArgumentParser) -> None:
    """The search flags of JAX's generation parser (options.py:636-649)."""
    p.add_argument("--sampling", action="store_true")
    p.add_argument("--sampling-topk", type=int, default=-1)
    p.add_argument("--sampling-topp", type=float, default=-1.0)
    p.add_argument("--diverse-beam-groups", type=int, default=-1)
    p.add_argument("--diverse-beam-strength", type=float, default=0.5)
    p.add_argument("--diversity-rate", type=float, default=-1.0)
    p.add_argument("--prefix-size", type=int, default=0)


def search_config(args, **kw) -> BeamConfig:
    """BeamConfig with the strategy fairseq's build_generator picks
    (fairseq_task.py:339-463): sampling, else diverse beam, else diverse
    siblings, else beam."""
    strategy = "beam"
    if args.sampling:
        if args.sampling_topk > 0 and args.sampling_topp > 0:
            raise ValueError(
                "--sampling-topk and --sampling-topp are mutually exclusive")
        strategy = "sampling"
    elif args.diverse_beam_groups > 0:
        strategy = "diverse_beam"
    elif args.diversity_rate > -1.0:
        strategy = "diverse_siblings"
    return BeamConfig(beam=args.beam, min_len=args.min_len,
                      len_penalty=args.lenpen,
                      no_repeat_ngram_size=args.no_repeat_ngram_size,
                      strategy=strategy, sampling_topk=args.sampling_topk,
                      sampling_topp=args.sampling_topp,
                      diversity_num_groups=max(args.diverse_beam_groups, 1),
                      diversity_strength=args.diverse_beam_strength,
                      diversity_rate=max(args.diversity_rate, 0.0), **kw)


def load_model(path: str, args, data_cfg, which: str, device,
               margs=None):
    """(model cast for inference on ``device``, the flag namespace it was
    built from) of one checkpoint: a JAX ``.npz`` with
    its flag echo, or a fairseq ``.pt`` with the command line's flags.
    ``margs`` (the first member's, for an ensemble) replaces the echo."""
    feat = data_cfg.input_feat_per_channel
    if is_torch_checkpoint(path):
        sd = s2st_state_dict(path)
        margs = margs or model_args_from_checkpoint(args, {})
        cfg = s2st_config(sd, margs, feat)
        if not getattr(cfg, which.replace("_decoder", "")):
            raise ValueError(f"{path} has no {which}; train with the "
                             f"matching ce-weight")
        model = s2st_from_fairseq(cfg, sd)
        logger.info(f"loaded fairseq checkpoint {path}")
    else:
        variables, meta = read_jax_checkpoint(path)
        margs = margs or model_args_from_checkpoint(args, meta)
        params = variables["params"]
        cfg = build_model_config(margs, variables, feat).replace(
            aux_asr="aux_asr_decoder" in params,
            aux_st="aux_st_decoder" in params,
            ctc="ctc_proj" in params["decoder"])
        if which not in params:
            raise ValueError(f"{path} has no {which}; train with the "
                             f"matching ce-weight")
        model = from_jax_variables(cfg, variables)
        logger.info(f"loaded {path} (step {meta.get('step', '?')})")
    return cast_for_inference(model.to(device).eval(), cfg.dtype), margs


def read_constraints(path: str, out_dict) -> tuple:
    """The constraints file: {id: [token ids a phrase]}, {id: [phrases]}
    (empty fields skipped)."""
    cons_map, cons_text = {}, {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            phrases = [ph for ph in parts[1:] if ph.strip()]
            cons_map[parts[0]] = [
                [int(t) for t in out_dict.encode_line(ph, append_eos=False)]
                for ph in phrases]
            cons_text[parts[0]] = phrases
    return cons_map, cons_text


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
    src_dict, tgt_dict = load_dictionaries(args.data, data_cfg)
    use_asr = args.scoring == "wer"
    which = "aux_asr_decoder" if use_asr else "aux_st_decoder"
    out_dict = src_dict if use_asr else tgt_dict
    models, margs = [], None
    for path in args.path.split(":"):
        model, margs = load_model(path, args, data_cfg, which, device,
                                  margs)
        models.append(model)
    cfg = models[0].cfg
    decs = [getattr(m, which) for m in models]
    logger.info(f"{which} of {len(models)} model(s) on {device}, compute "
                f"{cfg.dtype}")
    bs_cfg = search_config(args, max_len=min(200, cfg.max_target_positions))
    nbest = min(args.nbest, args.beam)
    noise = GumbelNoise(torch.Generator(device).manual_seed(args.seed)) \
        if bs_cfg.strategy == "sampling" else None

    split = TrainSplit(args.data, data_cfg, args.gen_subset, src_dict,
                       tgt_dict, n_frames_per_step=cfg.n_frames_per_step)
    tables = cons_text = None
    if args.constraints:
        if not args.constraints_file:
            raise ValueError("--constraints needs --constraints-file")
        if args.prefix_size > 0:
            raise ValueError("--constraints and --prefix-size are exclusive")
        cons_map, cons_text = read_constraints(args.constraints_file,
                                               out_dict)
        per_utt = [cons_map.get(str(uid), []) for uid in split.ids]
        logger.info(f"constrained decoding ({args.constraints}): "
                    f"{sum(1 for c in per_utt if c)}/{len(per_utt)} "
                    f"utterances have constraints")
        tables = build_constraint_tables(pack_constraints(per_utt),
                                         len(out_dict), args.constraints,
                                         device)
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
        taps, pads = [], []
        for model in models:
            enc = model.encode(src, src_lens)
            t = enc["out_middle_layers"]
            taps.append(t[0] if (use_asr or len(t) == 1) else t[1])
            pads.append(enc["encoder_padding_mask"])
        rec["encode_ms"] = clock.lap()
        if args.score_reference:
            toks = batch[text_key][:n_rows]
            lens = batch[f"{text_key}_len"][:n_rows]
            out = score_sequences(decs, taps, pads, toks.to(device),
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
        search = {"noise": noise}
        if tables is not None:
            search["constraints"] = tables.select(ids)
        elif args.prefix_size > 0:
            search["prefix_tokens"] = \
                batch[text_key][:n_rows, :args.prefix_size].to(device)
        out = beam_search_aux(decs, taps, pads, bs_cfg, **search)
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
            if tables is not None:
                for ph in cons_text.get(str(sid), []):
                    print(f"C-{sid}\t{ph}")
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
