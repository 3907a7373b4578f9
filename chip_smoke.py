#!/usr/bin/env python3
"""Drive the PyTorch port (s2st_tpu_torch) on one NVIDIA H100.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line). First
every kernel source under s2st_tpu_torch/csrc is built for sm_90a, one nvcc
a source, all started together; the build prints ptxas's report
(registers, spills) and the count of tensor-core instructions in each
library's SASS, and the attention libraries must hold some.

1. Hold csrc/flash_attention.cu's kernel against its plain PyTorch
   version at the serving path's shapes, in fp32 (scalar kernel) and bf16
   (tensor-core kernel), with its device time by CUDA-graph replay beside
   the plain version's, SDPA's (a yardstick only) and the card's bound;
   at the serving shape also torch.profiler's sums beside them. In bf16
   also at the encoder shapes of the training batch (B=8) and of batches
   of the recipe's size (B=60 to train, B=100 to serve, T'=250). Then
   MultiheadAttention at head_dims the kernel does not take, 4 (64-d, 16
   heads) and 256 (512-d, 2 heads), fp32 and bf16, causal and not, with key
   padding: it must run through attend, launch no kernel and match attend,
   while flash_attention itself refuses those head_dims.
2. Serve: write a small corpus (4 utterances of 80-d fbank), its GCMVN
   stats and a seeded random checkpoint of the recipe's model at full width
   (12 + 6 layers, 512-d, 4 heads, 2048 FFN, 1024 conv channels, prenet 32,
   4 frames a step, taps 4 and 9, 1-layer 64-d aux decoders), then run the
   port's generate_waveform CLI in bf16 with a 64-iteration Griffin-Lim.
   The kernel's launch count over that run must reach 12 per batch; the
   WAVs must be PCM16 of the expected length and the features finite.
3. Hold the card against the CPU on a small input (fp32, no prenet
   dropout): autoregressive generate_features and a teacher-forced decode.
4. Run one batch's encode, decode, postnet and Griffin-Lim under
   torch.profiler and print each phase's wall time, device kernel time
   and idle share.
5. Hold the backward kernel (csrc/flash_attention_bwd.cu) against the
   plain version's autograd at the training path's shapes (encoder
   self-attention at D=128, causal decoder self-attention, cross-attention,
   the aux decoders' D=16 self- and cross-attention, a row of length 0),
   in fp32 and bf16, with its device time by graph replay beside the plain
   backward's, SDPA's backward (a yardstick only) and the card's bound;
   in bf16 also at a training batch of the recipe's size (B=60, T'=250).
6. Train: write a corpus of 8 utterances (400-1000 80-d fbank frames,
   log-mel targets, phone and word lines, their dictionaries, GCMVN and
   SpecAugment in config.yaml) and run the port's train CLI in bf16 with
   the recipe's stage-5 flags at full width: (a) with
   --use-flash-attention --attention-dropout 0 for 5 updates, where both
   kernels must launch at least 27 times an update, the loss and grad norm
   stay finite, checkpoint_last.npz is written and the port's
   generate_waveform serves an utterance from it; (b) with the recipe's
   exact flags (--attention-dropout 0.1) for 2 updates, where the plain
   path runs and neither kernel launches, as in JAX.
7. Hold the card against the CPU on one fp32 update of a small model with
   dropout off: the loss, every gradient and every updated parameter.
8. Run one bf16 training update of 6(a) under torch.profiler and print its
   wall time, device kernel time, idle share, top kernels and the
   attention kernels' share of the device time.
9. Hold csrc/lightconv.cu and csrc/dynamicconv.cu against their plain
   versions in fp32 and bf16 at the LightConv path's shapes (B=64, T=64,
   C=512, H=4, K = 3, 7, 15, 31 with the encoder's padding K//2 and the
   decoder's K-1) and edge cases (T < K, T = 1, an all-pad row, H = 1; a K
   that is not compiled in, K = 40 above a warp's lanes, odd C for the
   one-element loads, T = 77 that fills no whole block, B = 1; bf16
   activations with fp32 dynamic weights), with device times (CUDA graph
   replay, and torch.profiler's sum beside it) beside the plain versions',
   PyTorch's depthwise conv1d (lightconv's yardstick only) and the card's
   bound, and their sums over one batch's launches at the path's K.
10. Serve text: write a binarized de-en test split (128 pairs, sources of
   8-64 tokens, dictionaries of 8848 and 6632 types) and seeded random
   checkpoints of lightconv_iwslt_de_en at full width (7 + 6 layers,
   512-d, kernels 3..31, 4 heads, FFN 1024), then run the port's text
   generate CLI in bf16 (--batch-size 64 --beam 5 --max-len-a 1.2
   --max-len-b 10 --remove-bpe): (a) lightweight and (b) dynamic convs,
   where the used kernel launches exactly 7 times a batch and the other
   never; (c) and (d) the same with --score-reference, 13 a batch. Each
   run prints 128 H- lines and a finite BLEU line.
11. Hold the card against the CPU on a small LightConv in fp32, both conv
   types: teacher-forced logits and the beam's hypotheses.
12. Run one batch of 10(a) (encode, beam loop) under torch.profiler and
   print each one's wall time, device kernel time, idle share and top
   kernels.
13. Train through the runtime (run after 8, with 6(a)'s flags plus
   --update-freq 2, --store-ema and --keep-last-epochs 2): time an update
   at --update-freq 1 and 2 in the recipe's batches (a corpus of 256
   utterances that --max-tokens 60000 cuts into 4 batches of 56-72; three
   epochs each, no saves) and profile one update of such a batch as in
   8; then, on 6(a)'s corpus in batches of 2 utterances, with
   deterministic algorithms on, (A) 3 epochs uninterrupted and (B) the
   same stopped by --max-update 3 in the
   middle of epoch 2 with --save-interval-updates 3, then resumed from
   checkpoint_last.npz to the end. B's checkpoint_last.npz and
   checkpoint_last_ema.npz (parameters, statistics, Adam state, EMA) must
   equal A's bit for bit; A must keep checkpoint2, checkpoint3,
   checkpoint_last and checkpoint_last_ema (checkpoint1 removed); both
   attention kernels must launch at least 27 times a microbatch in A; the
   stage-6 average of A's last two epoch files must equal their numpy mean
   and serve through generate_waveform. Prints ms per update, each save's
   ms and MB, and the seconds the average took.

Prints the card's name and power limit, one JSON line of kernel
measurements, and, last, {"ok": true, "device": {...}}.

    python3 chip_smoke.py --conv-timing [DIR ...]

runs no phase but times the conv kernels of one or more trees (this
checkout's s2st_tpu_torch by default, else the s2st_tpu_torch under each
DIR, used through its wrapper's functions only, so that a git archive of a
parent can be timed beside this tree: parent, change, change, parent). For
each tree, in its own process after all are built in parallel, it checks
both kernels against their plain versions at phase 9's bf16 encoder and
decoder shapes (K = 3, 7, 15, 31), times them, F.conv1d and a copy of x (the
bytes of the bound) by graph replay, and prints one ``conv_timing`` JSON
line with the sums over one batch's launches.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12                     # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,      # dense bf16 tensor cores
                  torch.float32: 67e12}        # fp32 outside tensor cores
TOL_FP32 = (1e-5, 1e-5)   # (atol, rtol): fp32 sums in another order
TOL_BF16 = 2e-2           # atol: output rounded to bf16 (8-bit mantissa)
# backward against the plain version's fp32 autograd on the same inputs.
# fp32: atol 1e-4 + rtol 1e-4, sums over up to 250 keys or queries in
# another order. bf16: within 3e-2 of each of dq, dk, dv's largest
# magnitude: the kernel takes D = rowsum(dO * o) from the bf16 output o,
# as the TPU kernel does, and dS = P (dP - D) cancels in rows whose
# probability sits on few keys, so an elementwise bound fails near 0
TOL_BWD_FP32 = (1e-4, 1e-4)
TOL_BWD_BF16 = 3e-2
HEADS, HEAD_DIM = 4, 128
UTT_FRAMES = (1000, 850, 620, 400)
MAX_ITER = 150


def gpu_identity() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: torch.profiler's sum over the device
    activities of ``iters`` calls, over ``iters``; host overhead (the
    autograd engine's, for a backward) is left out. A trace with no device
    activity (the profiler can drop a window's events) is taken again, up
    to three times, and then fails the run."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(_dev_us(e) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    raise AssertionError("torch.profiler recorded no device time")


def graph_ms(fn, iters: int = 20, replays: int = 5, stream=None) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``replays`` times between two CUDA events, over iters x
    replays. A replay does no host work, so this times the device alone,
    and unlike the profiler's sum it cannot lose part of a trace. Warm-up
    and capture run on ``stream`` (a new side stream by default)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def grad_graph_ms(forward, leaves, g) -> float:
    """Device time of one autograd backward of ``forward(*leaves)`` with
    output gradient g, by graph replay. The forward runs once, outside the
    graph, on the stream that then captures the backward: autograd runs
    each backward op on its forward op's stream, so all of them are
    captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = forward(*leaves)
    return graph_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                retain_graph=True),
                    stream=side)


def attention_inputs(b, tq, tk, lengths, dtype, seed, d=HEAD_DIM):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape_q, shape_k = (b, tq, HEADS, d), (b, tk, HEADS, d)
    q = (torch.randn(shape_q, generator=g, device="cuda")
         * d ** -0.5).to(dtype)
    k = torch.randn(shape_k, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape_k, generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, device="cuda")
    kpm = torch.arange(tk, device="cuda")[None, :] >= lens[:, None]
    return q, k, v, kpm


def attention_bound_ms(q, k, kpm, causal, backward=False) -> tuple:
    """Least time for the function on this card: each input read once and
    each output written once, against the products this data needs (a
    causal row that has a valid key needs only the keys up to itself).
    Forward: q, k, v in, o out; 2 products. Backward: q, k, v, o, dO and
    the fp32 row statistics in, dq, dk, dv out; 5 products (S recomputed,
    dV, dP, dQ, dK)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    size = q.element_size()
    if backward:
        nbytes = (4 * q.numel() + 4 * k.numel()) * size + kpm.numel() \
            + 2 * 4 * b * h * tq
    else:
        nbytes = (2 * q.numel() + 2 * k.numel()) * size + kpm.numel()
    pad = kpm.cpu().numpy()
    pairs = 0
    for bi in range(b):
        if not causal:
            pairs += tq * tk
            continue
        first_valid = np.flatnonzero(~pad[bi])
        for i in range(tq):
            ok = first_valid.size and first_valid[0] <= i
            pairs += min(i + 1, tk) if ok else tk
    ops = (10.0 if backward else 4.0) * h * d * pairs
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_fn(q, k, v, kpm, causal):
    """One PyTorch call computing the same function (timed as a yardstick;
    the port never calls it)."""
    tq, tk = q.shape[1], k.shape[1]
    add = torch.zeros((tq, tk), device="cuda")
    if causal:
        add = add + torch.triu(torch.full((tq, tk), -1e9, device="cuda"), 1)
    mask = torch.where(kpm[:, None, None, :], torch.tensor(-1e9, device="cuda"),
                       add).to(q.dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=1.0)


def check_case(ka, name, b, tq, tk, lengths, causal, dtype, card,
               device_times=False):
    q, k, v, kpm = attention_inputs(b, tq, tk, lengths, dtype, seed=tq + tk)
    out = ka.flash_attention(q, k, v, kpm, causal=causal)
    ref = ka.flash_attention_reference(q, k, v, kpm, causal=causal)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name} {dtype}: non-finite kernel output")
    err = (out.float() - ref.float()).abs()
    max_err = float(err.max())
    if dtype == torch.float32:
        atol, rtol = TOL_FP32
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
        tol = f"atol {atol} + rtol {rtol}"
    else:
        ok = max_err <= TOL_BF16
        tol = f"atol {TOL_BF16}"
    rec = {
        "case": name, "dtype": str(dtype).split(".")[-1],
        "B": b, "Tq": tq, "Tk": tk, "H": HEADS, "D": HEAD_DIM,
        "causal": causal, "max_abs_err": max_err, "tolerance": tol}
    # device times by CUDA-graph replay; with device_times also
    # torch.profiler's sum beside each
    for key, call in (("kernel", lambda: ka.flash_attention(q, k, v, kpm,
                                                            causal)),
                      ("plain", lambda: ka.flash_attention_reference(
                          q, k, v, kpm, causal)),
                      ("library", sdpa_fn(q, k, v, kpm, causal))):
        rec[f"{key}_graph_ms"] = graph_ms(call)
        if device_times:
            rec[f"{key}_device_ms"] = device_ms(call)
    rec["bound_ms"], rec["bound_by"] = attention_bound_ms(q, k, kpm, causal)
    rec["card"] = card
    print("kernel_case " + json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"{name} {dtype}: kernel disagrees with the "
                             f"plain version, max abs err {max_err} ({tol})")
    return rec


def build_kernels() -> dict:
    """Build every kernel library of the port, one nvcc a source, all
    started together; print what ptxas reports of each and
    how many tensor-core instructions (HMMA) cuobjdump finds in its SASS.
    Returns {library: HMMA count, or None without cuobjdump}."""
    from s2st_tpu_torch.kernels import nvcc
    t0 = time.perf_counter()
    libs = nvcc.build()
    print(f"built {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc a source, in "
          f"parallel)", flush=True)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    hmma_counts = {}
    for name, lib in libs.items():
        ptxas = lib.with_name(lib.stem + ".ptxas.txt")
        for line in ptxas.read_text().splitlines():
            if any(w in line for w in ("entry", "registers", "spill")):
                print("ptxas: " + line.strip(), flush=True)
        if not Path(cuobjdump).is_file():
            print(f"sass: {lib.name}: cuobjdump not found", flush=True)
            hmma_counts[name] = None
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        hmma = [w for w in sass.split() if w.startswith("HMMA")]
        print(f"sass: {lib.name}: {len(hmma)} HMMA instructions "
              f"({', '.join(sorted(set(hmma))) or 'none'})", flush=True)
        hmma_counts[name] = len(hmma)
    return hmma_counts


# batches of the recipe's size (recipes/run_baseline.sh: --max-tokens 60000
# to train, :31, and 100000 to serve, :167) over utterances of about 1000
# fbank frames, the longest of the smoke's: 60 and 100 utterances
RECIPE_BATCHES = {"recipe_train_B60": 60, "recipe_serve_B100": 100}


def recipe_lengths(batch: int) -> list:
    """Encoder lengths (T') of a length-bucketed batch of the recipe's
    size: ``batch`` utterances of 1000 down to 900 fbank frames."""
    from s2st_tpu_torch.models.s2st_transformer import subsampled_length
    return [subsampled_length(recipe_config(), 1000 - (100 * i) // batch)
            for i in range(batch)]


# MultiheadAttention widths whose head_dim the kernel does not take:
# (embed, heads) -> head_dim 4 (the 64-d aux decoders with
# decoder_attention_heads=16) and 256 (the encoder with
# encoder_attention_heads=2), both knobs of recipes/run_baseline.sh
GATE_WIDTHS = ((64, 16), (512, 2))


def mha_by_attend(m, x, kpm, causal):
    """MultiheadAttention's function through the plain attend, written
    out."""
    from s2st_tpu_torch.nn.attention import attend, causal_mask, split_heads
    from s2st_tpu_torch.nn.core import linear
    b, t, c = x.shape
    heads = [split_heads(linear(x, proj.weight, proj.bias), m.num_heads)
             for proj in (m.q_proj, m.k_proj, m.v_proj)]
    heads[0] = heads[0] * m.scale
    out, _ = attend(*heads, kpm, causal_mask(t, x.device) if causal
                    else None)
    return linear(out.reshape(b, t, c), m.out_proj.weight, m.out_proj.bias)


def head_dim_gate_cases(ka, card: str) -> None:
    """Phase 1's last part: at head_dims outside the kernel's contract the
    module runs through attend, with no launch, and matches it; the kernel
    itself still refuses those head_dims."""
    from s2st_tpu_torch.nn.attention import MultiheadAttention
    t, lengths = 75, [75, 60, 31, 8]
    for embed, heads in GATE_WIDTHS:
        for dtype in (torch.float32, torch.bfloat16):
            torch.manual_seed(embed + heads)
            m = MultiheadAttention(embed, heads).to("cuda", dtype)
            g = torch.Generator(device="cuda").manual_seed(embed)
            x = torch.randn((len(lengths), t, embed), generator=g,
                            device="cuda").to(dtype)
            kpm = torch.arange(t, device="cuda")[None, :] >= torch.tensor(
                lengths, device="cuda")[:, None]
            for causal in (False, True):
                before = ka.flash_attention.launches
                out, _ = m(x, x, x, kpm, causal=causal)
                ref = mha_by_attend(m, x, kpm, causal)
                torch.cuda.synchronize()
                launched = ka.flash_attention.launches - before
                err = (out.float() - ref.float()).abs()
                if dtype == torch.float32:
                    atol, rtol = TOL_FP32
                    ok = bool((err <= atol + rtol * ref.float().abs()).all())
                else:
                    ok = float(err.max()) <= TOL_BF16
                ok = ok and bool(torch.isfinite(out.float()).all())
                print("gate_case " + json.dumps({
                    "embed": embed, "heads": heads, "head_dim": embed // heads,
                    "dtype": str(dtype).split(".")[-1], "causal": causal,
                    "kernel_launches": launched,
                    "max_abs_err": float(err.max()), "card": card}),
                      flush=True)
                if launched or not ok:
                    raise AssertionError(
                        f"MultiheadAttention {embed}/{heads} {dtype} causal="
                        f"{causal}: {launched} kernel launches, max abs err "
                        f"{float(err.max())} against attend")
        q = torch.zeros((1, 3, heads, embed // heads), device="cuda")
        try:
            ka.flash_attention(q, q, q)
        except ValueError:
            continue
        raise AssertionError(f"flash_attention took head_dim "
                             f"{embed // heads}")


def kernel_phase(card: str, main_lengths, train_lengths) -> dict:
    """Phase 1; returns the bf16 records of the main shapes by case."""
    from s2st_tpu_torch.kernels import attention as ka
    cases = []
    for t in (75, 150, 300):
        cases.append((f"encoder_self_T{t}", 4, t, t,
                      [t, t - 7, t // 2 + 3, t // 3], False))
    cases.append(("decoder_causal_T150", 4, 150, 150, [150, 131, 90, 40],
                  True))
    cases.append(("cross_Tq150_Tk300", 4, 150, 300, [300, 260, 170, 75],
                  False))
    cases.append(("row_without_keys_T150", 4, 150, 150, [150, 120, 0, 60],
                  False))
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            check_case(ka, *case, dtype=dtype, card=card)
    # in bf16 the main path's encoder self-attention shapes: the served
    # batch, the training batch, and batches of the recipe's size
    main = {}
    for name, lengths in (("serving_encoder_self", main_lengths),
                          ("train_encoder_self", train_lengths),
                          *((n, recipe_lengths(b))
                            for n, b in RECIPE_BATCHES.items())):
        t = lengths[0]
        main[name] = check_case(ka, name, len(lengths), t, t, lengths, False,
                                torch.bfloat16, card,
                                device_times=name == "serving_encoder_self")
    head_dim_gate_cases(ka, card)
    return main


RECIPE_ARGS = {
    "arch": "s2st_transformer", "n_frames_per_step": 4,
    "middle_layers": "4,9", "asr_ce_weight": 0.3, "st_ce_weight": 0.3,
    "ctc_weight": 0.0, "asr_decoder_layers": 1, "st_decoder_layers": 1,
    "asr_decoder_embed_dim": 64, "st_decoder_embed_dim": 64,
    "prenet_dim": 32, "encoder_attention_heads": 4,
    "decoder_attention_heads": 4, "decoder_ffn_embed_dim": 2048,
    "max_source_positions": 3000, "fp16": True,
}


def write_corpus(root: Path, seed: int) -> None:
    """4 utterances of 80-d fbank (and 80-d log-mel targets), a TSV,
    GCMVN stats and config.yaml with the recipe's features block."""
    r = np.random.RandomState(seed)
    feat_dir = root / "features"
    feat_dir.mkdir(parents=True)
    rows, srcs, tgts = [], [], []
    for i, n in enumerate(UTT_FRAMES):
        src = (r.randn(n, 80) * 3.0 + 8.0).astype(np.float32)
        tgt = (r.randn(n // 2, 80) * 2.5 - 6.0).astype(np.float32)
        np.save(feat_dir / f"utt{i}_src.npy", src)
        np.save(feat_dir / f"utt{i}_tgt.npy", tgt)
        srcs.append(src)
        tgts.append(tgt)
        rows.append(f"utt{i}\tfeatures/utt{i}_src.npy\tfeatures/utt{i}_tgt.npy"
                    f"\t{n}\t{n // 2}\thola\thello\tspk0")
    (root / "tst.tsv").write_text(
        "id\tsrc_audio\ttgt_audio\tsrc_n_frames\ttgt_n_frames\tsrc_text"
        "\ttgt_text\tspeaker\n" + "\n".join(rows) + "\n")
    for side, feats in (("src", srcs), ("tgt", tgts)):
        allf = np.concatenate(feats)
        np.savez(root / f"gcmvn_{side}.npz", mean=allf.mean(0),
                 std=allf.std(0))
    (root / "config.yaml").write_text(f"""audio_root: {root.as_posix()}
input_feat_per_channel: 80
input_channels: 1
features:
  type: spectrogram+melscale+log
  sample_rate: 16000
  n_fft: 1024
  win_length: 1024
  hop_length: 256
  win_len_t: 0.064
  hop_len_t: 0.016
  n_mels: 80
  f_min: 20
  f_max: 8000
src_transforms:
  '*':
  - src_global_cmvn
tgt_transforms:
  '*':
  - tgt_global_cmvn
src_global_cmvn:
  stats_npz_path: {(root / 'gcmvn_src.npz').as_posix()}
tgt_global_cmvn:
  stats_npz_path: {(root / 'gcmvn_tgt.npz').as_posix()}
""")


def recipe_config():
    """The recipe's model (recipes/run_baseline.sh:30-51) at full width."""
    from s2st_tpu_torch.models.s2st_transformer import S2STConfig
    return S2STConfig(
        src_vocab_size=100, tgt_vocab_size=100, middle_layers=(4, 9),
        n_frames_per_step=4, prenet_dim=32, aux_asr=True, aux_st=True,
        asr_decoder_layers=1, st_decoder_layers=1, asr_decoder_embed_dim=64,
        st_decoder_embed_dim=64, dtype=torch.float32)


def recipe_model(seed: int):
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    return S2STTransformer(recipe_config()).init_weights(seed)


def serve_phase(work: Path, card: str) -> dict:
    from s2st_tpu_torch.cli import generate_waveform
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    data = work / "data"
    write_corpus(data, seed=0)
    ckpt = work / "checkpoint_random.npz"
    write_jax_checkpoint(str(ckpt), recipe_model(seed=0),
                         meta={"args": RECIPE_ARGS})
    out = work / "out"
    argv = [str(data), "--config-yaml", "config.yaml", "--gen-subset", "tst",
            "--task", "s2s_translation", "--path", str(ckpt),
            "--max-tokens", "100000", "--spec-bwd-max-iter", "64",
            "--n-frames-per-step", "4", "--fp16",
            "--max-iter", str(MAX_ITER), "--eos-prob-threshold", "1.5",
            "--dump-waveforms", "--dump-features", "--device", "cuda"]
    # a first run warms cuBLAS/cuDNN; the second is the one measured
    if generate_waveform.main(argv + ["--results-path",
                                      str(work / "warmup")]) != 0:
        raise AssertionError("generate_waveform (warm-up) failed")
    argv += ["--results-path", str(out)]
    ka.flash_attention.launches = 0
    t0 = time.perf_counter()
    rc = generate_waveform.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ka.flash_attention.launches
    if rc != 0:
        raise AssertionError(f"generate_waveform returned {rc}")
    timing = json.loads((out / "timing.json").read_text())
    n_batches = len(timing)
    print(f"serve: {n_batches} batch(es), flash_attention launches "
          f"{launches}, wall {wall:.2f} s ({card})", flush=True)
    if n_batches < 1 or launches < 12 * n_batches:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"for {n_batches} batches; want >= 12 a batch")
    for rec in timing:
        per_step = rec["decode_ms"] / rec["decode_steps"]
        print(f"serve_timing batch {rec['batch']}: rows {rec['rows']}, "
              f"src frames {rec['src_frames']}, encode_ms "
              f"{rec['encode_ms']:.3f}, decode_ms {rec['decode_ms']:.3f} over "
              f"{rec['decode_steps']} steps ({per_step:.3f} ms/step), "
              f"postnet_ms {rec['postnet_ms']:.3f}, griffin_lim_ms "
              f"{rec['vocoder_ms']:.3f} ({card})", flush=True)
        if rec["decode_steps"] != MAX_ITER:
            raise AssertionError(f"decoded {rec['decode_steps']} steps, "
                                 f"expected {MAX_ITER}")
    n_raw = MAX_ITER * 4
    want_samples = 256 * (n_raw - 1)
    for i in range(len(UTT_FRAMES)):
        with wave.open(str(out / "wav" / f"utt{i}_pred.wav"), "rb") as w:
            if (w.getsampwidth(), w.getnchannels(), w.getframerate()) != \
                    (2, 1, 16000):
                raise AssertionError(f"utt{i}: not 16 kHz mono PCM16")
            if w.getnframes() != want_samples:
                raise AssertionError(f"utt{i}: {w.getnframes()} samples, "
                                     f"want {want_samples}")
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        feat = np.load(out / "feat" / f"utt{i}_pred.npy")
        if feat.shape != (n_raw, 80) or not np.isfinite(feat).all():
            raise AssertionError(f"utt{i}: features {feat.shape} not finite "
                                 f"({n_raw}, 80)")
        if not np.any(pcm):
            raise AssertionError(f"utt{i}: silent waveform")
    print(f"serve: {len(UTT_FRAMES)} WAVs of {want_samples} PCM16 samples, "
          f"features ({n_raw}, 80) finite", flush=True)
    return {"launches": launches, "batches": n_batches}


def agreement_phase(card: str) -> None:
    """The card (kernel inside) against the CPU (plain attention), fp32,
    two utterances of 240 and 170 frames: 8 autoregressive steps, and a
    teacher-forced decode of 30 steps (causal and cross-attention)."""
    from s2st_tpu_torch.generate.speech_generator import (
        GenerationConfig, generate_features, teacher_forcing_features)
    model = recipe_model(seed=1).eval()
    gen_cfg = GenerationConfig(max_iter=8, eos_prob_threshold=1.5,
                               prenet_dropout_at_inference=False)
    r = np.random.RandomState(1)
    batch = {"src_speech": torch.from_numpy(
                 r.randn(2, 240, 80).astype(np.float32)),
             "src_speech_lens": torch.tensor([240, 170]),
             "prev_output_tokens": torch.from_numpy(
                 r.randn(2, 30, 320).astype(np.float32)),
             "target_lengths": torch.tensor([30, 21])}
    with torch.no_grad():
        cpu = (generate_features(model, gen_cfg, batch["src_speech"],
                                 batch["src_speech_lens"]),
               teacher_forcing_features(model, batch))
        model.to("cuda")
        dev = {k: v.cuda() for k, v in batch.items()}
        gpu = (generate_features(model, gen_cfg, dev["src_speech"],
                                 dev["src_speech_lens"]),
               teacher_forcing_features(model, dev))
    for name, c, g in (("generate_features", *[x[0] for x in (cpu, gpu)]),
                       ("teacher_forcing", *[x[1] for x in (cpu, gpu)])):
        err = float((g["feats"].cpu() - c["feats"]).abs().max())
        print(f"agreement: card vs CPU {name} (fp32) max abs err "
              f"{err:.3e}, tolerance 1e-3 ({card})", flush=True)
        if not err <= 1e-3:
            raise AssertionError(f"{name}: card and CPU disagree: {err}")


def _profiled(fn):
    """(result, wall ms, device kernel ms, device activities, every device
    activity as (name, ms, count), largest first) of one call under
    torch.profiler; the device idles for wall - kernel ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(_dev_us(e) for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=_dev_us, reverse=True)
    return out, wall, busy, launches, [(e.key, _dev_us(e) / 1e3,
                                        e.count) for e in top]


def profile_phase(card: str) -> None:
    """Where the serving time goes: each phase of one bf16 batch at the
    serving shape, under torch.profiler (the profiler slows the host)."""
    from s2st_tpu_torch.generate.speech_generator import (GenerationConfig,
                                                          decode_loop,
                                                          postprocess)
    from s2st_tpu_torch.generate.vocoder import GriffinLimVocoder
    from s2st_tpu_torch.models.s2st_transformer import (S2STTransformer,
                                                        cast_for_inference)
    cfg = recipe_config().replace(dtype=torch.bfloat16)
    model = cast_for_inference(
        S2STTransformer(cfg).init_weights(0).to("cuda").eval(), cfg.dtype)
    r = np.random.RandomState(2)
    src = torch.from_numpy(r.randn(4, UTT_FRAMES[0], 80).astype(np.float32)
                           ).cuda()
    lens = torch.tensor(UTT_FRAMES).cuda()
    gen_cfg = GenerationConfig(max_iter=MAX_ITER, eos_prob_threshold=1.5)
    vocoder = GriffinLimVocoder(16000, 1024, 256, 1024, 80, 20.0, 8000.0,
                                64, "cuda")
    g = torch.Generator("cuda").manual_seed(0)
    with torch.inference_mode():
        for _ in range(2):      # the second pass is the one reported
            enc, *rec_enc = _profiled(lambda: model.encode(src, lens))
            dec, *rec_dec = _profiled(
                lambda: decode_loop(model, gen_cfg, enc, generator=g))
            out, *rec_post = _profiled(
                lambda: postprocess(model, *dec[:2], dec[3]))
            _, *rec_voc = _profiled(
                lambda: vocoder(out["feats"], out["raw_out_lens"], g))
    for name, (wall, busy, launches, top) in (("encode", rec_enc),
                                              ("decode", rec_dec),
                                              ("postnet", rec_post),
                                              ("griffin_lim", rec_voc)):
        print(f"profile {name}: wall_ms {wall:.3f}, device_kernel_ms "
              f"{busy:.3f} in {launches} device activities, idle share "
              f"{1 - busy / wall:.3f} ({card})", flush=True)
        for key, ms, count in top[:6]:
            print(f"profile {name}:   {ms:9.3f} ms  {count:6d}x  {key[:60]}",
                  flush=True)


def sdpa_leaf_fn(q, k, v, kpm, causal):
    """SDPA on fresh leaves: (leaves, a call giving (B, Tq, H, D))."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    call = sdpa_fn(*leaves, kpm, causal)
    return leaves, lambda: call().transpose(1, 2)


def grad_fn(out, leaves, g):
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def check_bwd_case(ka, name, b, tq, tk, lengths, causal, d, dtype, card,
                   device_times=False):
    """The backward kernel against the plain version's autograd (run in
    fp32 on the same inputs and dO) at one shape; its time beside the
    plain backward's (in the working type), SDPA's backward and the
    bound: device times by graph replay, forward + backward times by CUDA
    events (host included), and with ``device_times`` torch.profiler's
    sums of the three backwards beside the graph times."""
    q, k, v, kpm = attention_inputs(b, tq, tk, lengths, dtype,
                                    seed=tq + tk + d, d=d)
    g = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(d),
                    device="cuda").to(dtype)
    out, row_max, row_logsum = ka.flash_attention_forward(q, k, v, kpm,
                                                          causal, stats=True)
    got = ka.flash_attention_backward(q, k, v, out, row_max, row_logsum, g,
                                      kpm, causal)
    ref_leaves = [x.float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ka.flash_attention_reference(
        *ref_leaves, kpm, causal), ref_leaves, g.float())
    torch.cuda.synchronize()
    atol, rtol = TOL_BWD_FP32
    max_err, ok = 0.0, True
    for x, y in zip(got, want):
        if not torch.isfinite(x.float()).all():
            raise AssertionError(f"bwd {name} {dtype}: non-finite gradient")
        err = (x.float() - y).abs()
        max_err = max(max_err, float(err.max()))
        if dtype == torch.float32:
            ok = ok and bool((err <= atol + rtol * y.abs()).all())
        else:
            ok = ok and float(err.max()) <= TOL_BWD_BF16 * float(y.abs().max())
    tol = (f"atol {atol} + rtol {rtol}" if dtype == torch.float32
           else f"{TOL_BWD_BF16} of each gradient's largest magnitude")
    plain_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    plain_out = ka.flash_attention_reference(*plain_leaves, kpm, causal)
    lib_leaves, lib_call = sdpa_leaf_fn(q, k, v, kpm, causal)
    lib_out = lib_call()
    kern_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    rec = {
        "case": name, "dtype": str(dtype).split(".")[-1], "B": b, "Tq": tq,
        "Tk": tk, "H": HEADS, "D": d, "causal": causal,
        "max_abs_err": max_err, "tolerance": tol,
        # device times of the three backwards by CUDA-graph replay: the
        # kernel's direct call, and autograd of the plain version and SDPA
        "bwd_graph_ms": graph_ms(lambda: ka.flash_attention_backward(
            q, k, v, out, row_max, row_logsum, g, kpm, causal)),
        "plain_bwd_graph_ms": grad_graph_ms(
            lambda *x: ka.flash_attention_reference(*x, kpm, causal),
            [x.detach().requires_grad_() for x in (q, k, v)], g),
        "library_bwd_graph_ms": grad_graph_ms(
            lambda *x: sdpa_fn(*x, kpm, causal)().transpose(1, 2),
            [x.detach().requires_grad_() for x in (q, k, v)], g),
        # forward + backward through autograd, CUDA events (host included)
        "fwd_bwd_ms": time_ms(lambda: ka.flash_attention(
            *kern_leaves, kpm, causal).backward(g), iters=20),
        "plain_fwd_bwd_ms": time_ms(lambda: ka.flash_attention_reference(
            *plain_leaves, kpm, causal).backward(g), iters=20),
        "library_fwd_bwd_ms": time_ms(lambda: lib_call().backward(g),
                                      iters=20),
    }
    if device_times:    # torch.profiler's sums beside the graph times
        rec["bwd_device_ms"] = device_ms(lambda: ka.flash_attention_backward(
            q, k, v, out, row_max, row_logsum, g, kpm, causal))
        rec["plain_bwd_device_ms"] = device_ms(
            grad_fn(plain_out, plain_leaves, g))
        rec["library_bwd_device_ms"] = device_ms(
            grad_fn(lib_out, lib_leaves, g))
    rec["bound_ms"], rec["bound_by"] = attention_bound_ms(q, k, kpm, causal,
                                                          backward=True)
    rec["card"] = card
    print("bwd_case " + json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"bwd {name} {dtype}: kernel disagrees with the "
                             f"plain version, max abs err {max_err}")
    return rec


TRAIN_FRAMES = (1000, 930, 860, 790, 700, 610, 520, 400)
N_PHONES, N_WORDS = 60, 200


def backward_phase(card: str, train_lengths) -> dict:
    """Phase 5 at the training batch's shapes (B=8, 4 heads) and, in bf16,
    at a training batch of the recipe's size; returns the bf16 records of
    the encoder self-attention shapes by case."""
    from s2st_tpu_torch.kernels import attention as ka
    t = train_lengths[0]
    cases = [
        ("encoder_self_T150", 8, 150, 150,
         [150, 141, 130, 117, 100, 88, 64, 40], False, HEAD_DIM),
        ("train_encoder_self", 8, t, t, train_lengths, False, HEAD_DIM),
        ("decoder_causal_T150", 8, 150, 150,
         [150, 139, 129, 118, 105, 91, 78, 60], True, HEAD_DIM),
        ("cross_Tq150_Tk250", 8, 150, 250, train_lengths, False, HEAD_DIM),
        ("aux_self_causal_T40_D16", 8, 40, 40,
         [40, 37, 35, 31, 28, 25, 22, 17], True, 16),
        ("aux_cross_Tq40_Tk250_D16", 8, 40, 250, train_lengths, False, 16),
        ("row_without_keys_T150", 8, 150, 150,
         [150, 120, 0, 60, 150, 99, 13, 70], False, HEAD_DIM),
        ("row_without_keys_causal_T40_D16", 8, 40, 40,
         [40, 0, 35, 31, 28, 25, 22, 17], True, 16),
    ]
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            is_main = case[0] == "train_encoder_self" \
                and dtype == torch.bfloat16
            rec = check_bwd_case(ka, *case, dtype=dtype, card=card,
                                 device_times=is_main)
            if is_main:
                main[case[0]] = rec
    lengths = recipe_lengths(RECIPE_BATCHES["recipe_train_B60"])
    main["recipe_train_B60"] = check_bwd_case(
        ka, "recipe_train_B60", len(lengths), lengths[0], lengths[0],
        lengths, False, HEAD_DIM, torch.bfloat16, card)
    return main


def write_train_corpus(root: Path, seed: int,
                       frames=TRAIN_FRAMES) -> None:
    """Training utterances of ``frames`` source frames (8 by default) of
    80-d fbank with 80-d log-mel targets (0.6 target frames a source
    frame), 20-40 phones and 8-20 words each,
    the two dictionaries, one serving utterance, GCMVN stats and the
    config.yaml get_feature_manifest.py writes (SpecAugment on train)."""
    r = np.random.RandomState(seed)
    feat_dir = root / "features"
    feat_dir.mkdir(parents=True)
    header = ("id\tsrc_audio\ttgt_audio\tsrc_n_frames\ttgt_n_frames\t"
              "src_text\ttgt_text\tspeaker\n")
    rows, srcs, tgts = [], [], []
    for i, n in enumerate(frames):
        src = (r.randn(n, 80) * 3.0 + 8.0).astype(np.float32)
        tgt = (r.randn(int(0.6 * n), 80) * 2.5 - 6.0).astype(np.float32)
        np.save(feat_dir / f"utt{i}_src.npy", src)
        np.save(feat_dir / f"utt{i}_tgt.npy", tgt)
        srcs.append(src)
        tgts.append(tgt)
        phones = " ".join(f"p{j}" for j in r.randint(0, N_PHONES,
                                                     r.randint(20, 41)))
        words = " ".join(f"w{j}" for j in r.randint(0, N_WORDS,
                                                    r.randint(8, 21)))
        rows.append(f"utt{i}\tfeatures/utt{i}_src.npy\tfeatures/utt{i}_tgt.npy"
                    f"\t{n}\t{len(tgt)}\t{phones}\t{words}\tspk0")
    (root / "train.tsv").write_text(header + "\n".join(rows) + "\n")
    (root / "tst.tsv").write_text(header + rows[3] + "\n")
    for name, prefix, n in (("src_vocab.txt", "p", N_PHONES),
                            ("tgt_vocab.txt", "w", N_WORDS)):
        (root / name).write_text("".join(f"{prefix}{j} 10\n"
                                         for j in range(n)))
    for side, feats in (("src", srcs), ("tgt", tgts)):
        allf = np.concatenate(feats)
        np.savez(root / f"gcmvn_{side}.npz", mean=allf.mean(0),
                 std=allf.std(0))
    (root / "config.yaml").write_text(f"""audio_root: {root.as_posix()}
src_vocab_filename: src_vocab.txt
tgt_vocab_filename: tgt_vocab.txt
input_feat_per_channel: 80
input_channels: 1
features:
  type: spectrogram+melscale+log
  sample_rate: 16000
  n_fft: 1024
  win_length: 1024
  hop_length: 256
  win_len_t: 0.064
  hop_len_t: 0.016
  n_mels: 80
  f_min: 20
  f_max: 8000
src_transforms:
  '*':
  - src_global_cmvn
  _train:
  - src_global_cmvn
  - specaugment
tgt_transforms:
  '*':
  - tgt_global_cmvn
src_global_cmvn:
  stats_npz_path: {(root / 'gcmvn_src.npz').as_posix()}
tgt_global_cmvn:
  stats_npz_path: {(root / 'gcmvn_tgt.npz').as_posix()}
specaugment:
  freq_mask_F: 27
  freq_mask_N: 2
  time_mask_N: 2
  time_mask_T: 100
  time_mask_p: 1.0
  time_wrap_W: 0
""")


def recipe_train_argv(data: Path, save: Path, max_update: int) -> list:
    """recipes/run_baseline.sh:117-151 with its own values (max_tokens
    60000 puts the 8 utterances in one batch), and a log line a step."""
    return [
        str(data), "--save-dir", str(save), "--config-yaml", "config.yaml",
        "--train-subset", "train", "--valid-subset", "dev",
        "--num-workers", "4", "--max-tokens", "60000",
        "--max-update", str(max_update), "--task", "s2s_translation",
        "--criterion", "s2st_loss", "--arch", "s2st_transformer",
        "--clip-norm", "1.0", "--n-frames-per-step", "4",
        "--bce-pos-weight", "5.0", "--dropout", "0.1",
        "--attention-dropout", "0.1", "--activation-dropout", "0.01",
        "--encoder-normalize-before", "--decoder-normalize-before",
        "--optimizer", "adam", "--lr", "1.5e-3", "--lr-scheduler",
        "inverse_sqrt", "--warmup-updates", "4000", "--seed", "1",
        "--update-freq", "1", "--eval-inference",
        "--best-checkpoint-metric", "mcd_loss", "--use-hubert", "False",
        "--label-smoothing", "0.1", "--asr-ce-weight", "0.3",
        "--st-ce-weight", "0.3", "--report-accuracy",
        "--skip-invalid-size-inputs-valid-test", "--ctc-weight", "0.0",
        "--middle-layers", "4,9", "--log-file", str(save / "log.jsonl"),
        "--log-format", "json", "--tensorboard-logdir", str(save / "tb"),
        "--asr-decoder-layers", "1", "--st-decoder-layers", "1",
        "--asr-decoder-embed-dim", "64", "--st-decoder-embed-dim", "64",
        "--prenet-dim", "32", "--max-source-positions", "3000", "--fp16",
        "--validate-after-updates", "300000", "--disable-validation",
        "--keep-best-checkpoints", "50", "--keep-last-epochs", "50",
        "--encoder-attention-heads", "4", "--decoder-attention-heads", "4",
        "--decoder-ffn-embed-dim", "2048", "--device", "cuda",
        "--log-interval", "1"]


def run_train_cli(argv, save: Path, card: str, label: str) -> dict:
    """One run of the port's train CLI with every kernel count set to 0
    just before it; returns the counts, the per-update log and peak
    memory."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.kernels import attention as ka
    save.mkdir(parents=True)
    torch.cuda.reset_peak_memory_stats()
    ka.flash_attention.launches = ka.flash_attention.bwd_launches = 0
    t0 = time.perf_counter()
    rc = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = ka.flash_attention.launches, ka.flash_attention.bwd_launches
    if rc != 0:
        raise AssertionError(f"train ({label}) returned {rc}")
    log = [json.loads(line) for line in
           (save / "log.jsonl").read_text().splitlines()]
    for rec in log:
        if not (np.isfinite(rec["loss"]) and np.isfinite(rec["gnorm"])):
            raise AssertionError(f"train ({label}): non-finite loss or grad "
                                 f"norm at update {rec['num_updates']}")
    steady = [r["step_ms"] for r in log[1:]] or [log[0]["step_ms"]]
    frames = log[-1]["ntokens"] * 4          # packed steps * 4 frames
    out = {"updates": len(log), "fwd_launches": fwd, "bwd_launches": bwd,
           "wall_s": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first_step_ms": log[0]["step_ms"],
           "step_ms": sum(steady) / len(steady),
           "losses": [r["loss"] for r in log],
           "gnorms": [r["gnorm"] for r in log]}
    out["target_frames_per_s"] = frames / (out["step_ms"] / 1e3)
    print(f"train ({label}): {out['updates']} updates in {wall:.1f} s; "
          f"{out['step_ms']:.3f} ms/update after the first "
          f"({out['first_step_ms']:.1f} ms), {out['target_frames_per_s']:.0f} "
          f"target frames/s ({frames} a batch), peak memory "
          f"{out['peak_gib']:.2f} GiB; flash_attention launches fwd {fwd} "
          f"bwd {bwd}; losses {out['losses']}; grad norms {out['gnorms']} "
          f"({card})", flush=True)
    return out


def serve_from_checkpoint(work: Path, data: Path, ckpt: Path) -> None:
    from s2st_tpu_torch.cli import generate_waveform
    out = work / "served"
    argv = [str(data), "--config-yaml", "config.yaml", "--gen-subset", "tst",
            "--task", "s2s_translation", "--path", str(ckpt),
            "--results-path", str(out), "--max-iter", "30",
            "--eos-prob-threshold", "1.5", "--spec-bwd-max-iter", "8",
            "--fp16", "--dump-waveforms", "--dump-features",
            "--device", "cuda"]
    if generate_waveform.main(argv) != 0:
        raise AssertionError("generate_waveform from the trained "
                             "checkpoint failed")
    feat = np.load(out / "feat" / "utt3_pred.npy")
    if feat.shape != (120, 80) or not np.isfinite(feat).all():
        raise AssertionError(f"served features {feat.shape} not finite "
                             f"(120, 80)")
    print(f"train: served utt3 from {ckpt.name}: features {feat.shape} "
          f"finite, {out / 'wav' / 'utt3_pred.wav'} written", flush=True)


def train_phase(card: str) -> dict:
    """Phase 6: (a) the kernel configuration, (b) the recipe's flags."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        data = work / "data"
        write_train_corpus(data, seed=3)
        n_a = 5
        argv = recipe_train_argv(data, work / "a", n_a) + [
            "--use-flash-attention", "--attention-dropout", "0"]
        a = run_train_cli(argv, work / "a", card, "a: --use-flash-attention "
                          "--attention-dropout 0")
        if a["updates"] != n_a or a["fwd_launches"] < 27 * n_a \
                or a["bwd_launches"] < 27 * n_a:
            raise AssertionError(f"train (a): {a['updates']} updates with "
                                 f"{a['fwd_launches']} forward and "
                                 f"{a['bwd_launches']} backward kernel "
                                 f"launches; want >= 27 each an update")
        ckpt = work / "a" / "checkpoint_last.npz"
        if not ckpt.is_file():
            raise AssertionError("train (a) wrote no checkpoint_last.npz")
        serve_from_checkpoint(work, data, ckpt)
        b = run_train_cli(recipe_train_argv(data, work / "b", 2), work / "b",
                          card, "b: the recipe's flags")
        if b["updates"] != 2 or b["fwd_launches"] or b["bwd_launches"]:
            raise AssertionError(f"train (b): {b['updates']} updates, kernel "
                                 f"launches fwd {b['fwd_launches']} bwd "
                                 f"{b['bwd_launches']}; want 2 and 0, 0")
        return {"a": a, "b": b, "data": data, "work": work}
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


def train_agreement_phase(card: str) -> None:
    """Phase 7: one fp32 update with dropout off of a 2 + 2 layer model at
    the recipe's widths (D=128 and the aux decoders' D=16), CTC on, on
    the card (kernels) and on the CPU (plain versions), from one init.

    Tolerances: the loss and grad norm 1e-4 relative; each leaf's
    gradient within 1e-4 of its largest magnitude plus 1e-6 of the largest
    of all (fp32 sums in another order; leaves whose gradient is 0 in exact
    arithmetic hold fp32 noise); each parameter after the update within
    1e-6 + 1e-5 |p| where the gradient Adam sees (divided by the
    sample size, as in JAX) is above 100 eps, else within lr: Adam's first
    step is g / (|g| + eps), which fp32 noise in a g near eps moves by up
    to lr."""
    from s2st_tpu_torch.data.s2st_dataset import collate, to_device
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from s2st_tpu_torch.train.losses import LossConfig, s2st_loss
    from s2st_tpu_torch.train.optim import inverse_sqrt_schedule
    from s2st_tpu_torch.train.trainer import Trainer
    cfg = recipe_config().replace(
        encoder_layers=2, decoder_layers=2, middle_layers=(0, 1), ctc=True,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        prenet_dropout=0.0, postnet_dropout=0.0)
    lcfg = LossConfig(label_smoothing=0.1, ctc_weight=0.3, asr_ce_weight=0.3,
                      st_ce_weight=0.3)
    lr, eps = 1.5e-3, 1e-8
    r = np.random.RandomState(4)
    items = [{"index": i,
              "src_speech": r.randn(n, 80).astype(np.float32),
              "tgt_speech": r.randn(n // 5, 320).astype(np.float32),
              "src_text": np.append(r.randint(4, 100, n // 10), 2),
              "tgt_text": np.append(r.randint(4, 100, n // 20), 2)}
             for i, n in enumerate((240, 200, 150))]
    batch = collate(items)
    cpu = S2STTransformer(cfg).init_weights(7)
    dev = copy.deepcopy(cpu).to("cuda")
    results = []
    for model, b in ((cpu, batch), (dev, to_device(batch, "cuda"))):
        loss, ex = s2st_loss(model, lcfg, b, train=True)
        loss.backward()
        sample_size = float(ex["sample_size"])
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters()}
        tr = Trainer(model, lcfg, inverse_sqrt_schedule(lr, 4000, lr),
                     clip_norm=1.0)
        met = tr.train_step(b)
        params = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        results.append((loss.item(), grads, met, params))
    (l_c, g_c, m_c, p_c), (l_d, g_d, m_d, p_d) = results
    if m_c["gnorm"] >= 1.0:
        raise AssertionError("train agreement: the clip acted; the bounds "
                             "assume it does not")
    g_max = max(float(g.abs().max()) for g in g_c.values())
    worst_g = worst_p = 0.0
    for name in g_c:
        dg = float((g_d[name] - g_c[name]).abs().max())
        scale = float(g_c[name].abs().max())
        if scale > 1e-3 * g_max:     # not a leaf of fp32 noise
            worst_g = max(worst_g, dg / scale)
        dp = (p_d[name] - p_c[name]).abs()
        steady = g_c[name].abs() / sample_size > 100 * eps
        bound = torch.where(steady, 1e-6 + 1e-5 * p_c[name].abs(),
                            torch.full_like(dp, lr + 1e-6))
        if steady.any():
            worst_p = max(worst_p, float(dp[steady].max()))
        if dg > 1e-4 * scale + 1e-6 * g_max or bool((dp > bound).any()):
            raise AssertionError(f"train agreement: {name} differs, grad "
                                 f"{dg:.3e}, param {float(dp.max()):.3e}")
    rel_loss = abs(l_d - l_c) / abs(l_c)
    rel_gnorm = abs(m_d["gnorm"] - m_c["gnorm"]) / m_c["gnorm"]
    print(f"train agreement: card vs CPU (fp32, one update): loss "
          f"{l_d:.6f} vs {l_c:.6f} (rel {rel_loss:.2e}), grad norm rel "
          f"{rel_gnorm:.2e}, worst per-leaf grad error {worst_g:.2e} of the "
          f"leaf's max among leaves above 1e-3 of the largest (tolerance "
          f"1e-4), worst param error {worst_p:.2e} "
          f"where the scaled gradient is above 100 eps (tolerance 1e-6 + "
          f"1e-5 |p|) ({card})", flush=True)
    if rel_loss > 1e-4 or rel_gnorm > 1e-4:
        raise AssertionError("train agreement: loss or grad norm differ")


def train_profile_phase(card: str, data: Path,
                        label: str = "train_update") -> None:
    """Phase 8: one bf16 update of 6(a)'s model and batch (the corpus's
    first batch under --max-tokens 60000, as the train CLI cuts it) under
    torch.profiler, after two warm-up updates."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.data.iterators import EpochBatchIterator
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit, to_device
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from s2st_tpu_torch.train.optim import schedule_from_args
    from s2st_tpu_torch.train.trainer import Trainer
    args = train.get_parser().parse_args(
        recipe_train_argv(data, data / "unused", 1)
        + ["--use-flash-attention", "--attention-dropout", "0"])
    data_cfg = S2STDataConfig(data / "config.yaml")
    dicts = [Dictionary.load(str(data / f)) for f in ("src_vocab.txt",
                                                      "tgt_vocab.txt")]
    cfg = model_config(args, len(dicts[0]), len(dicts[1]), 80)
    split = TrainSplit(str(data), data_cfg, "train", *dicts,
                       n_frames_per_step=4)
    model = S2STTransformer(cfg).init_weights(1).to("cuda")
    trainer = Trainer(model, train.loss_config(args), schedule_from_args(args),
                      clip_norm=1.0)
    batch = to_device(next(EpochBatchIterator(
        split, 60000, required_batch_size_multiple=8).next_epoch_itr()),
        "cuda")

    def update():
        return trainer.train_step(
            batch, [torch.Generator("cuda").manual_seed(trainer.step)])
    for _ in range(2):
        update()
    _, wall, busy, launches, top = _profiled(update)
    print(f"profile {label}: rows {batch['src_speech'].shape[0]}, source "
          f"frames {batch['src_speech'].shape[1]}, wall_ms {wall:.3f}, "
          f"device_kernel_ms {busy:.3f} in {launches} device activities, "
          f"idle share {1 - busy / wall:.3f} ({card})", flush=True)
    for key, ms, count in top[:6]:
        print(f"profile {label}:   {ms:9.3f} ms  {count:6d}x  "
              f"{key[:60]}", flush=True)
    attn = [(re.search(r"(flash_fwd|attn_bwd)\w*(<[\d, ]+>)?", key), ms,
             count)
            for key, ms, count in top]
    attn = [(m.group(0), ms, count) for m, ms, count in attn if m]
    attn_ms = sum(ms for _, ms, _ in attn)
    print(f"profile {label}: attention kernels {attn_ms:.3f} ms of "
          f"{busy:.3f} ms device time ({attn_ms / busy:.3f}): "
          + "; ".join(f"{name} {ms:.3f} ms {count}x"
                      for name, ms, count in attn)
          + f" ({card})", flush=True)


def runtime_argv(data: Path, save: Path, *extra, small=True) -> list:
    """Phase 13's flags: the recipe's stage-5 line with --update-freq 2,
    the kernel configuration (--use-flash-attention --attention-dropout
    0), EMA, --keep-last-epochs 2 and, with ``small``, batches of 2
    utterances (on 6(a)'s corpus, 4 an epoch, 2 updates); else the
    recipe's batches of --max-tokens 60000."""
    return recipe_train_argv(data, save, 100000) + [
        "--use-flash-attention", "--attention-dropout", "0",
        "--update-freq", "2", "--store-ema", "--keep-last-epochs", "2",
        *(["--batch-size", "2"] if small else []), *extra]


# Phase 13's timing corpus: 256 utterances of 600-1000 source frames, which
# --max-tokens 60000 (and --required-batch-size-multiple 8) cuts into 4
# batches of 56, 64, 72 and 64 utterances, padded to 1024, 1024, 896 and
# 768 frames: the recipe's batch of about 60 utterances.
RECIPE_BATCH_FRAMES = tuple(np.random.RandomState(11).randint(600, 1001, 256))


def run_counted(argv) -> tuple:
    """One run of the port's train CLI with the attention kernels' counts
    set to 0 just before it; returns (forward, backward) launches."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.kernels import attention as ka
    ka.flash_attention.launches = ka.flash_attention.bwd_launches = 0
    if train.main(argv) != 0:
        raise AssertionError(f"train {argv[-6:]} failed")
    torch.cuda.synchronize()
    return ka.flash_attention.launches, ka.flash_attention.bwd_launches


class TimedSaves:
    """Times each checkpoint the train CLI writes, from the device-to-host
    copy of its state (``state_flat``) to the last name's link, with the
    file's size."""

    def __enter__(self):
        from s2st_tpu_torch.cli import train
        self.train, self.records = train, []
        self.flat, self.save = train.state_flat, train.CheckpointManager.save

        def flat(trainer):
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()
            return self.flat(trainer)

        def save(mgr, *args, **kw):
            paths = self.save(mgr, *args, **kw)
            self.records.append({
                "ms": (time.perf_counter() - self.t0) * 1e3,
                "mb": Path(paths[0]).stat().st_size / 1e6,
                "names": [Path(p).name for p in paths]})
            return paths
        train.state_flat, train.CheckpointManager.save = flat, save
        return self

    def __exit__(self, *exc):
        self.train.state_flat = self.flat
        self.train.CheckpointManager.save = self.save


class Deterministic:
    """cuDNN's deterministic convolutions and PyTorch's deterministic
    algorithms (scatter-add by sorting), so that two runs of the same
    updates give the same bits; the other kernels of the path (the
    attention kernels, cuBLAS on one stream) are deterministic already."""

    def __enter__(self):
        self.cudnn = torch.backends.cudnn.deterministic
        self.fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.cudnn
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = self.fill


def recipe_batch_timing(root: Path, card: str) -> dict:
    """Phase 13's timing: ms per update at --update-freq 1 and 2 in the
    recipe's batches (RECIPE_BATCH_FRAMES), 3 epochs each without saves;
    the mean over epochs 2 and 3, where each batch shape has run once.
    Then one update of the first batch under torch.profiler (phase 8's
    readings at the recipe's batch)."""
    from s2st_tpu_torch.data.iterators import batch_by_size, ordered_indices
    data = root / "recipe_batch"
    write_train_corpus(data, seed=5, frames=RECIPE_BATCH_FRAMES)
    lengths = np.asarray(RECIPE_BATCH_FRAMES)
    sizes = [len(b) for b in batch_by_size(
        ordered_indices(lengths, True, 1, 1), lengths, 60000, None, 8)]
    out = {"batches": sizes}
    for uf in (1, 2):
        save = root / f"uf{uf}"
        save.mkdir()
        torch.cuda.reset_peak_memory_stats()
        run_counted(runtime_argv(data, save, "--update-freq", str(uf),
                                 "--max-epoch", "3", "--no-save",
                                 small=False))
        log = [json.loads(line) for line in
               (save / "log.jsonl").read_text().splitlines()]
        want = 3 * len(sizes) // uf
        if len(log) != want or not all(np.isfinite(r["loss"]) for r in log):
            raise AssertionError(f"update-freq {uf}: {len(log)} updates in "
                                 f"3 epochs; want {want}, finite losses")
        steady = [r["step_ms"] for r in log if r["epoch"] > 1]
        out[uf] = {"ms": sum(steady) / len(steady), "min_ms": min(steady),
                   "max_ms": max(steady), "first_ms": log[0]["step_ms"],
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"train runtime: ms/update in the recipe's batches ({sizes} "
          f"utterances, --max-tokens 60000), mean of epochs 2-3: "
          + ", ".join(f"--update-freq {uf}: {out[uf]['ms']:.3f} (min "
                      f"{out[uf]['min_ms']:.3f}, max {out[uf]['max_ms']:.3f}"
                      f", first {out[uf]['first_ms']:.1f}; peak memory "
                      f"{out[uf]['peak_gib']:.2f} GiB)" for uf in (1, 2))
          + f" ({card})", flush=True)
    train_profile_phase(card, data, "train_update_recipe_batch")
    return out


def runtime_phase(card: str, data: Path) -> dict:
    """Phase 13: the training runtime at the recipe's width: ms per update
    in the recipe's batches, then resume, retention and averaging on
    6(a)'s corpus in batches of 2 utterances at --update-freq 2."""
    from s2st_tpu_torch.cli import average_checkpoints
    from s2st_tpu_torch.train.checkpoint import load_checkpoint_file
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_runtime_"))
    try:
        out = {"ms_per_update": recipe_batch_timing(root, card)}
        with Deterministic():
            with TimedSaves() as saves:
                fwd, bwd = run_counted(runtime_argv(data, root / "a",
                                                    "--max-epoch", "3"))
            micro = 3 * 4
            if fwd < 27 * micro or bwd < 27 * micro:
                raise AssertionError(f"train runtime (A): {fwd} forward and "
                                     f"{bwd} backward launches over {micro} "
                                     f"microbatches; want >= 27 each")
            run_counted(runtime_argv(data, root / "b", "--max-epoch", "3",
                                     "--max-update", "3",
                                     "--save-interval-updates", "3"))
            run_counted(runtime_argv(data, root / "b", "--max-epoch", "3"))
        files = sorted(p.name for p in (root / "a").glob("*.npz"))
        want = ["checkpoint2.npz", "checkpoint3.npz", "checkpoint_last.npz",
                "checkpoint_last_ema.npz"]
        if files != want:
            raise AssertionError(f"train runtime (A) kept {files}; want "
                                 f"{want}")
        keys = 0
        for name in ("checkpoint_last.npz", "checkpoint_last_ema.npz"):
            a, _ = load_checkpoint_file(str(root / "a" / name))
            b, _ = load_checkpoint_file(str(root / "b" / name))
            diff = sorted(k for k in a if k not in b
                          or not np.array_equal(a[k], b[k]))
            if diff or set(a) != set(b):
                raise AssertionError(f"train runtime: the resumed run's "
                                     f"{name} differs from the "
                                     f"uninterrupted run's in {diff[:5]}")
            keys += len(a)
        avg = root / "avg.npz"
        t0 = time.perf_counter()
        if average_checkpoints.main(["--inputs", str(root / "a"),
                                     "--num-epoch-checkpoints", "2",
                                     "--output", str(avg)]) != 0:
            raise AssertionError("average_checkpoints failed")
        out["average_s"] = time.perf_counter() - t0
        got, _ = load_checkpoint_file(str(avg))
        pair = [load_checkpoint_file(str(root / "a" / f"checkpoint{e}.npz"))[0]
                for e in (2, 3)]
        for k, v in got.items():
            if k.startswith("params::"):
                mean = np.mean([pair[0][k].astype(np.float64),
                                pair[1][k].astype(np.float64)], axis=0)
                if not np.array_equal(v, mean.astype(v.dtype)):
                    raise AssertionError(f"average: {k} is not the mean of "
                                         f"checkpoint2 and checkpoint3")
        serve_from_checkpoint(root, data, avg)
        out.update(fwd_launches=fwd, bwd_launches=bwd, microbatches=micro,
                   saves=saves.records)
        print(f"train runtime: resumed run (stopped at update 3 in epoch 2) "
              f"equals the uninterrupted run bit for bit in {keys} arrays "
              f"(parameters, statistics, Adam state, EMA; deterministic "
              f"algorithms on); A kept {files}; attention launches fwd {fwd} "
              f"bwd {bwd} over {micro} microbatches ({card})", flush=True)
        print(f"train runtime: checkpoint saves (device copy, write, "
              f"links): "
              + ", ".join(f"{r['ms']:.1f} ms for {r['mb']:.1f} MB "
                          f"{'+'.join(r['names'])}" for r in saves.records)
              + f"; average of 2 files {out['average_s']:.3f} s, equal to "
              f"their numpy mean; served from the average ({card})",
              flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# phases 9-12: LightConv / DynamicConv text serving
# --------------------------------------------------------------------------

CONV_B, CONV_C, CONV_H = 64, 512, 4
CONV_MAIN_CASE = "encoder_K31"     # the encoder's widest kernel, bf16


def conv_inputs(kind, b, t, c, h, k, dtype, seed, zero_row=False):
    """x (B, T, C) in ``dtype``; the raw weights: (H, K) fp32 for lightconv
    (the model's parameter), (B, T, H, K) logits in ``dtype`` for
    dynamicconv (the model's weight_linear output)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, t, c), generator=g, device="cuda")
    if zero_row:
        x[-1] = 0.0
    shape = (h, k) if kind == "lightconv" else (b, t, h, k)
    w = torch.randn(shape, generator=g, device="cuda") * 2
    return x.to(dtype), (w if kind == "lightconv" else w.to(dtype))


def conv_bound_ms(x, w) -> tuple:
    """x read once, y written once, the weights read once; 2 K operations
    (a multiply and an add) an output element, fp32 on the CUDA cores."""
    k = w.shape[-1]
    nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2.0 * k * x.numel() / PEAK_OPS_PER_S[torch.float32]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def depthwise_fn(x, w, pad, heads):
    """PyTorch's depthwise conv1d (groups=C) computing lightconv on the
    same inputs, the softmaxed weights prepared outside the call (a
    yardstick only; the port never calls it)."""
    b, t, c = x.shape
    k = w.shape[-1]
    wc = torch.softmax(w.float(), -1).repeat_interleave(c // heads, 0)
    wc = wc[:, None, :].to(x.dtype).contiguous()
    xt = x.transpose(1, 2)
    if pad == k // 2 and k % 2 == 1:
        return lambda: torch.nn.functional.conv1d(xt, wc, padding=pad,
                                                  groups=c)
    return lambda: torch.nn.functional.conv1d(xt, wc, padding=k - 1,
                                              groups=c)[:, :, :t]


def check_conv_case(kind, name, b, t, c, h, k, pad, zero_row, dtype, card,
                    device_times=False):
    from s2st_tpu_torch.kernels import conv as kc
    fn, plain = getattr(kc, kind), getattr(kc, f"{kind}_reference")
    x, w = conv_inputs(kind, b, t, c, h, k, dtype, seed=t * 100 + k,
                       zero_row=zero_row)
    out = fn(x, w, pad, h)
    ref = plain(x, w, pad, h)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{kind} {name} {dtype}: non-finite output")
    err = (out.float() - ref.float()).abs()
    max_err = float(err.max())
    if dtype == torch.float32:
        atol, rtol = TOL_FP32
        ok = bool((err <= atol + rtol * ref.float().abs()).all())
        tol = f"atol {atol} + rtol {rtol}"
    else:
        ok = max_err <= TOL_BF16
        tol = f"atol {TOL_BF16}"
    if zero_row and out[-1].any():
        ok = False
    rec = {"kernel": kind, "case": name, "dtype": str(dtype).split(".")[-1],
           "B": b, "T": t, "C": c, "H": h, "K": k, "padding_l": pad,
           "max_abs_err": max_err, "tolerance": tol,
           "kernel_ms": time_ms(lambda: fn(x, w, pad, h)),
           "plain_ms": time_ms(lambda: plain(x, w, pad, h))}
    lib = depthwise_fn(x, w, pad, h) if kind == "lightconv" else None
    if lib is not None:
        rec["library_ms"] = time_ms(lib)
        lib_err = float((lib().transpose(1, 2).float()
                         - ref.float()).abs().max())
        rec["library_max_abs_err"] = lib_err
    if device_times:    # CUDA-graph replay, and torch.profiler beside it
        for key, call in (("kernel", lambda: fn(x, w, pad, h)),
                          ("plain", lambda: plain(x, w, pad, h)),
                          ("library", lib)):
            rec[f"{key}_graph_ms"] = graph_ms(call) if call else None
            rec[f"{key}_device_ms"] = device_ms(call) if call else None
    rec["bound_ms"], rec["bound_by"] = conv_bound_ms(x, w)
    rec["card"] = card
    print("conv_case " + json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"{kind} {name} {dtype}: kernel disagrees with "
                             f"the plain version, max abs err {max_err} "
                             f"({tol})")
    return rec


# the kernel sizes of lightconv_iwslt_de_en's 7 encoder and 6 decoder
# layers (s2st_tpu/options.py:1219-1234): a beam batch launches the
# encoder's, a --score-reference batch both
TEXT_ENCODER_K = (3, 7, 15, 31, 31, 31, 31)
TEXT_DECODER_K = (3, 7, 15, 31, 31, 31)


def conv_batch_sums(recs: dict) -> dict:
    """A kernel's graph-replay times and bounds summed over one batch's
    launches at the path's K, from phase 9's bf16 records by case."""
    out = {}
    for key, rec_key in (("ms", "kernel_graph_ms"), ("bound_ms", "bound_ms")):
        beam = sum(recs[f"encoder_K{k}"][rec_key] for k in TEXT_ENCODER_K)
        out[f"batch_{key}"] = {
            "beam": beam,
            "score_reference": beam + sum(recs[f"decoder_K{k}"][rec_key]
                                          for k in TEXT_DECODER_K)}
    return out


def conv_timing_tree(root: Path) -> dict:
    """--conv-timing, one tree: both conv kernels of the s2st_tpu_torch
    under root against their plain versions (bf16 tolerance) and timed by
    graph replay at every K of the path, F.conv1d and a copy of x beside
    them."""
    sys.path.insert(0, str(root))
    from s2st_tpu_torch.kernels import conv as kc
    if not Path(kc.__file__).resolve().is_relative_to(root.resolve()):
        raise AssertionError(f"imported {kc.__file__}, not under {root}")
    b, t, c, h = CONV_B, 64, CONV_C, CONV_H
    x = conv_inputs("lightconv", b, t, c, h, 3, torch.bfloat16, seed=0)[0]
    y = torch.empty_like(x)
    out = {"tree": str(root), "B": b, "T": t, "C": c, "H": h,
           "dtype": "bfloat16", "copy_ms": graph_ms(lambda: y.copy_(x))}
    for kind in ("lightconv", "dynamicconv"):
        fn, plain = getattr(kc, kind), getattr(kc, f"{kind}_reference")
        recs = {}
        for side in ("encoder", "decoder"):
            for k in sorted(set(TEXT_ENCODER_K)):
                pad = k // 2 if side == "encoder" else k - 1
                x, w = conv_inputs(kind, b, t, c, h, k, torch.bfloat16,
                                   seed=k)
                err = float((fn(x, w, pad, h).float()
                             - plain(x, w, pad, h).float()).abs().max())
                if not err <= TOL_BF16:
                    raise AssertionError(f"{root} {kind} {side} K={k}: err "
                                         f"{err}")
                rec = {"kernel_graph_ms": graph_ms(lambda: fn(x, w, pad, h)),
                       "max_abs_err": err}
                rec["bound_ms"], rec["bound_by"] = conv_bound_ms(x, w)
                if kind == "lightconv":
                    rec["library_ms"] = graph_ms(depthwise_fn(x, w, pad, h))
                recs[f"{side}_K{k}"] = rec
        out[kind] = {"by_k": recs, **conv_batch_sums(recs)}
    return out


def conv_timing(roots: list) -> int:
    """--conv-timing: build every tree's conv kernels in parallel, then
    time each tree in a process of its own."""
    card = gpu_identity()
    print(f"gpu: {card}", flush=True)
    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from s2st_tpu_torch.kernels import nvcc; nvcc.build(["
         "'lightconv', 'dynamicconv'])", str(root)])
        for root in dict.fromkeys(roots)]
    if any([p.wait() for p in builds]):
        print("chip_smoke: a conv build failed", file=sys.stderr)
        return 1
    print(f"built {len(builds)} trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    failed = [str(root) for root in roots if subprocess.run(
        [sys.executable, __file__, "--conv-timing-tree", str(root)]
    ).returncode]
    print(f"gpu: {card}", flush=True)
    if failed:
        print(f"chip_smoke: conv timing failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


def conv_kernel_phase(card: str) -> dict:
    """Phase 9: both conv kernels against their plain versions at the
    LightConv path's shapes and edge cases, fp32 and bf16; device times at
    every encoder and decoder shape in bf16. Returns the main case's
    record for each kernel, with its times and bounds summed over one
    batch's launches."""
    b, c, h = CONV_B, CONV_C, CONV_H
    cases = [(f"encoder_K{k}", b, 64, c, h, k, k // 2, False)
             for k in (3, 7, 15, 31)]
    cases += [(f"decoder_K{k}", b, 64, c, h, k, k - 1, False)
              for k in (3, 7, 15, 31)]
    cases += [("T_below_K", b, 9, c, h, 31, 15, False),
              ("T_1", b, 1, c, h, 31, 30, False),
              ("all_pad_row", b, 64, c, h, 15, 7, True),
              ("H_1", b, 64, c, 1, 7, 3, False),
              ("K_9", b, 64, c, h, 9, 4, False),
              ("K_40", b, 64, c, h, 40, 20, False),
              ("odd_C", b, 64, 129, 3, 7, 3, False),
              ("T_77", b, 77, c, h, 31, 15, False),
              ("B_1", 1, 64, c, h, 31, 15, False)]
    main = {}
    for kind in ("lightconv", "dynamicconv"):
        timed_recs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for case in cases:
                timed = dtype == torch.bfloat16 and \
                    case[0].startswith(("encoder", "decoder"))
                rec = check_conv_case(kind, *case, dtype=dtype, card=card,
                                      device_times=timed)
                if timed:
                    timed_recs[case[0]] = rec
        main[kind] = dict(timed_recs[CONV_MAIN_CASE],
                          **conv_batch_sums(timed_recs))
        print(f"conv_batch {kind}: " + json.dumps(
            {k: v for k, v in main[kind].items() if k.startswith("batch")}),
              flush=True)
        x, w = conv_inputs(kind, b, 64, c, h, 31, torch.bfloat16, seed=7)
        if kind == "dynamicconv":       # bf16 activations, fp32 weights
            from s2st_tpu_torch.kernels import conv as kc
            w = w.float()
            err = float((kc.dynamicconv(x, w, 15, h).float()
                         - kc.dynamicconv_reference(x, w, 15, h).float())
                        .abs().max())
            print(f"conv_case dynamicconv bf16 x, fp32 logits, K=31: max abs "
                  f"err {err:.3e} (atol {TOL_BF16})", flush=True)
            if not err <= TOL_BF16:
                raise AssertionError("dynamicconv bf16/fp32 disagrees")
    return main


TEXT_SRC_TYPES, TEXT_TGT_TYPES = 8848, 6632   # IWSLT'14 de-en BPE dicts
TEXT_PAIRS, TEXT_BATCH = 128, 64
TEXT_GEN_FLAGS = ["--batch-size", str(TEXT_BATCH), "--beam", "5",
                  "--max-len-a", "1.2", "--max-len-b", "10", "--remove-bpe",
                  "--fp16"]


def write_text_corpus(root: Path, seed: int) -> None:
    """A binarized de-en test split written with the port's builder: 128
    sentence pairs, source lengths of 8-64 tokens (EOS included), targets
    0.8-1.2 times as long, over dictionaries of 8848 and 6632 types (a
    quarter of them BPE pieces ending in "@@")."""
    from s2st_tpu_torch.data.indexed_dataset import write_dataset
    r = np.random.RandomState(seed)
    root.mkdir(parents=True)
    for lang, n in (("de", TEXT_SRC_TYPES), ("en", TEXT_TGT_TYPES)):
        (root / f"dict.{lang}.txt").write_text("".join(
            f"{lang}{i}{'@@' if i % 4 == 0 else ''} {n - i}\n"
            for i in range(n - 4)))
    src, tgt = [], []
    for _ in range(TEXT_PAIRS):
        ns = r.randint(8, 65)
        nt = int(np.clip(round(ns * r.uniform(0.8, 1.2)), 2, 80))
        src.append(np.append(r.randint(4, TEXT_SRC_TYPES, ns - 1), 2))
        tgt.append(np.append(r.randint(4, TEXT_TGT_TYPES, nt - 1), 2))
    write_dataset(str(root / "test.de-en.de"), src, TEXT_SRC_TYPES)
    write_dataset(str(root / "test.de-en.en"), tgt, TEXT_TGT_TYPES)


def text_model(conv_type: str, dtype=torch.float32, seed: int = 0):
    """lightconv_iwslt_de_en at full width with seeded random weights, and
    its flag echo (the model flags, as a checkpoint's __meta__ holds them)."""
    from s2st_tpu_torch.models.lightconv_args import (arch_args,
                                                      build_lightconv_config)
    from s2st_tpu_torch.models.lightconv_model import LightConvModel
    flags = [] if conv_type == "lightweight" else [
        "--encoder-conv-type", "dynamic", "--decoder-conv-type", "dynamic"]
    args = arch_args("lightconv_iwslt_de_en", flags)
    echo = {k: v for k, v in vars(args).items() if k not in ("fp16", "bf16")}
    args.fp16 = dtype == torch.bfloat16
    cfg = build_lightconv_config(args, TEXT_SRC_TYPES, TEXT_TGT_TYPES)
    return LightConvModel(cfg).init_weights(seed), echo


def run_text_cli(data: Path, ckpt: Path, out: Path, score_reference: bool,
                 card: str, label: str) -> dict:
    """One run of the port's text generate CLI with both conv kernels'
    counts set to 0 just before it; returns the counts, the batches and the
    run's timing, after checking its lines."""
    from s2st_tpu_torch.cli import generate
    from s2st_tpu_torch.kernels import conv as kc
    argv = [str(data), "--source-lang", "de", "--target-lang", "en",
            "--gen-subset", "test", "--path", str(ckpt), *TEXT_GEN_FLAGS,
            "--results-path", str(out), "--device", "cuda"]
    if score_reference:
        argv.append("--score-reference")
    kc.lightconv.launches = kc.dynamicconv.launches = 0
    t0 = time.perf_counter()
    rc = generate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"lightconv": kc.lightconv.launches,
              "dynamicconv": kc.dynamicconv.launches}
    if rc != 0:
        raise AssertionError(f"text generate ({label}) returned {rc}")
    lines = (out / "generate-test.txt").read_text().splitlines()
    hyps = [ln for ln in lines if ln.startswith("H-")]
    scores = [float(ln.split("\t")[1]) for ln in hyps]
    bleu = float(lines[-1].rsplit("=", 1)[1])
    if len(hyps) != TEXT_PAIRS or not np.isfinite(scores).all() or \
            not lines[-1].startswith("Generate test with beam=5: BLEU4 = ") \
            or not np.isfinite(bleu):
        raise AssertionError(f"text generate ({label}): {len(hyps)} H- lines "
                             f"(want {TEXT_PAIRS}), last line {lines[-1]!r}")
    timing = json.loads((out / "timing.json").read_text())
    rec = {"counts": counts, "batches": len(timing["batches"]),
           "timing": timing, "wall_s": wall, "bleu": bleu}
    for b in timing["batches"]:
        if score_reference:
            detail = f"forward_ms {b['forward_ms']:.3f}"
        else:
            detail = (f"encode_ms {b['encode_ms']:.3f}, beam_ms "
                      f"{b['beam_ms']:.3f} over {b['decode_steps']} steps "
                      f"({b['beam_ms'] / b['decode_steps']:.3f} ms/step)")
        print(f"text ({label}) batch {b['batch']}: rows {b['rows']}, source "
              f"tokens {b['src_tokens']}, {detail} ({card})", flush=True)
    print(f"text ({label}): {len(hyps)} H- lines, {lines[-1]}; "
          f"{timing['sentences_per_s']:.2f} sentences/s, "
          f"{timing['target_tokens_per_s']:.1f} target tokens/s, wall "
          f"{wall:.2f} s; launches lightconv {counts['lightconv']}, "
          f"dynamicconv {counts['dynamicconv']} ({card})", flush=True)
    return rec


def text_serve_phase(work: Path, card: str) -> dict:
    """Phase 10: lightconv_iwslt_de_en at full width in bf16 through the
    port's text generate CLI: (a) lightweight, (b) dynamic, (c) and (d)
    the same with --score-reference. Each kernel launches exactly 7 times
    a batch in the beam runs (the encoder) and 13 under --score-reference
    (encoder and teacher-forced decoder), the other kernel never."""
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    data = work / "text"
    write_text_corpus(data, seed=11)
    ckpts = {}
    for conv_type in ("lightweight", "dynamic"):
        model, echo = text_model(conv_type, seed=12)
        ckpts[conv_type] = work / f"lightconv_{conv_type}.npz"
        write_jax_checkpoint(str(ckpts[conv_type]), model,
                             meta={"args": echo})
    # a first run warms cuBLAS; the runs after it are the ones measured
    run_text_cli(data, ckpts["lightweight"], work / "warmup", False, card,
                 "warm-up")
    runs = {}
    for label, conv_type, score_ref, per_batch in (
            ("a", "lightweight", False, 7), ("b", "dynamic", False, 7),
            ("c", "lightweight", True, 13), ("d", "dynamic", True, 13)):
        rec = run_text_cli(data, ckpts[conv_type], work / label, score_ref,
                           card, f"{label}: {conv_type}"
                           + (", --score-reference" if score_ref else ""))
        used = "lightconv" if conv_type == "lightweight" else "dynamicconv"
        other = "dynamicconv" if used == "lightconv" else "lightconv"
        want = per_batch * rec["batches"]
        if rec["counts"][used] != want or rec["counts"][other] != 0:
            raise AssertionError(f"text ({label}): launches {rec['counts']} "
                                 f"over {rec['batches']} batches; want "
                                 f"{used} {want} and {other} 0")
        runs[label] = rec
    runs["data"], runs["ckpts"] = data, ckpts
    return runs


def text_agreement_phase(card: str) -> None:
    """Phase 11: a small LightConv in fp32 on the card (kernels) and on the
    CPU (plain versions), both conv types: teacher-forced logits within
    1e-5 + 1e-5 |ref|, and the beam's hypotheses (identical tokens and
    lengths, scores and per-position scores within 1e-5)."""
    from s2st_tpu_torch.generate.sequence_generator import (BeamConfig,
                                                            beam_search)
    from s2st_tpu_torch.models.lightconv_model import (LightConvConfig,
                                                       LightConvModel)
    from s2st_tpu_torch.models.transformer_text import TransformerTextConfig
    r = np.random.RandomState(13)
    b, ts, tt, vocab = 4, 17, 15, 60
    src = np.full((b, ts), 1, np.int64)
    prev = np.full((b, tt), 1, np.int64)
    for i, (sl, tl) in enumerate(((17, 15), (12, 9), (7, 11), (3, 2))):
        src[i, ts - sl:] = np.append(r.randint(4, vocab, sl - 1), 2)
        prev[i, 0] = 2
        prev[i, 1:tl] = r.randint(4, vocab, tl - 1)
    src_t, prev_t = torch.from_numpy(src), torch.from_numpy(prev)
    for conv_type in ("lightweight", "dynamic"):
        base = TransformerTextConfig(
            src_vocab_size=vocab, tgt_vocab_size=vocab, encoder_layers=3,
            encoder_embed_dim=64, encoder_ffn_embed_dim=128,
            encoder_attention_heads=4, decoder_layers=2,
            decoder_embed_dim=64, decoder_ffn_embed_dim=128,
            decoder_attention_heads=4, max_source_positions=128,
            max_target_positions=128)
        cfg = LightConvConfig(base=base, conv_type=conv_type,
                              encoder_kernel_sizes=(3, 7, 15),
                              decoder_kernel_sizes=(3, 7),
                              encoder_conv_dim=64, decoder_conv_dim=64)
        cpu = LightConvModel(cfg).init_weights(14).eval()
        dev = copy.deepcopy(cpu).to("cuda")
        bs = BeamConfig(beam=4, max_len=20, max_len_a=1.0, max_len_b=3.0)
        outs = []
        with torch.inference_mode():
            for model, device in ((cpu, torch.device("cpu")),
                                  (dev, torch.device("cuda"))):
                s, p = src_t.to(device), prev_t.to(device)
                logits = model(s, p)
                enc = model.encode(s)
                step = model.make_beam_step(
                    enc["encoder_out"].repeat_interleave(4, 0),
                    enc["encoder_padding_mask"].repeat_interleave(4, 0))
                beam = beam_search(step, model.init_beam_cache(b * 4, device),
                                   b, vocab, bs, device,
                                   src_lengths=(s != 1).sum(1))
                outs.append((logits.cpu(), {k: v.cpu() if torch.is_tensor(v)
                                            else v for k, v in beam.items()}))
        (lc, bc), (lg, bg) = outs
        err = float((lg - lc).abs().max())
        ok = bool(((lg - lc).abs() <= 1e-5 + 1e-5 * lc.abs()).all())
        same = torch.equal(bg["tokens"], bc["tokens"]) and \
            torch.equal(bg["lengths"], bc["lengths"])
        s_err = float((bg["scores"] - bc["scores"]).abs().max())
        p_err = float((bg["pos_scores"] - bc["pos_scores"]).abs().max())
        print(f"text agreement ({conv_type}): card vs CPU (fp32) logits max "
              f"abs err {err:.3e} (tolerance 1e-5 + 1e-5 |ref|); beam tokens "
              f"identical {same}, score err {s_err:.3e}, per-position err "
              f"{p_err:.3e} (tolerance 1e-5) ({card})", flush=True)
        if not (ok and same and s_err <= 1e-5 and p_err <= 1e-5):
            raise AssertionError(f"text agreement ({conv_type}): card and CPU "
                                 f"disagree")


def text_profile_phase(card: str, runs: dict) -> None:
    """Phase 12: one batch of 10(a) (lightweight, bf16, the first and
    longest batch) under torch.profiler, after a warm-up pass: encode and
    the beam loop, each with its wall time, device kernel time, idle share
    and top kernels."""
    from s2st_tpu_torch.cli import generate
    from s2st_tpu_torch.generate.sequence_generator import beam_search
    from s2st_tpu_torch.models.lightconv_model import cast_for_inference
    from s2st_tpu_torch.tasks.translation import TranslationTask
    args = generate.get_parser().parse_args(
        [str(runs["data"]), "--source-lang", "de", "--target-lang", "en",
         "--path", "unused", *TEXT_GEN_FLAGS])
    task = TranslationTask.setup_task(args)
    ds = task.load_dataset("test")
    batch = ds.collate(ds.batches(args.max_tokens, TEXT_BATCH, 8)[0])
    model, _ = text_model("lightweight", torch.bfloat16, seed=12)
    model = cast_for_inference(model.to("cuda").eval(), torch.bfloat16)
    bs = generate.beam_config(args, model.cfg)
    src = batch["src_tokens"].cuda()
    n = src.shape[0]

    def beam(enc):
        step = model.make_beam_step(
            enc["encoder_out"].repeat_interleave(5, 0),
            enc["encoder_padding_mask"].repeat_interleave(5, 0))
        return beam_search(step, model.init_beam_cache(n * 5, "cuda"), n,
                           TEXT_TGT_TYPES, bs, torch.device("cuda"),
                           src_lengths=(src != 1).sum(1))

    with torch.inference_mode():
        for _ in range(2):      # the second pass is the one reported
            enc, *rec_enc = _profiled(lambda: model.encode(src))
            out, *rec_beam = _profiled(lambda: beam(enc))
    for name, (wall, busy, launches, top) in (("text_encode", rec_enc),
                                              ("text_beam", rec_beam)):
        extra = f", {out['steps']} steps" if name == "text_beam" else ""
        print(f"profile {name}: rows {n}, wall_ms {wall:.3f}, "
              f"device_kernel_ms {busy:.3f} in {launches} device activities"
              f"{extra}, idle share {1 - busy / wall:.3f} ({card})",
              flush=True)
        for key, ms, count in top[:6]:
            print(f"profile {name}:   {ms:9.3f} ms  {count:6d}x  {key[:60]}",
                  flush=True)


def attention_shapes(fwd: dict, bwd: dict) -> dict:
    """The attention kernels' graph-replay times at each main shape of
    phases 1 and 5 beside SDPA's, the plain version's and the bound."""
    def row(rec, kernel, plain, library):
        return {"B": rec["B"], "T": rec["Tq"], "ms": rec[kernel],
                "plain_ms": rec[plain], "library_ms": rec[library],
                "bound_ms": rec["bound_ms"],
                "max_abs_err": rec["max_abs_err"]}
    return {
        "forward": {name: row(rec, "kernel_graph_ms", "plain_graph_ms",
                              "library_graph_ms")
                    for name, rec in fwd.items()},
        "backward": {name: row(rec, "bwd_graph_ms", "plain_bwd_graph_ms",
                               "library_bwd_graph_ms")
                     for name, rec in bwd.items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--conv-timing", nargs="*", type=Path, metavar="DIR",
                        help="only time the conv kernels of these trees "
                             "(this checkout without a DIR)")
    parser.add_argument("--conv-timing-tree", type=Path,
                        help=argparse.SUPPRESS)   # one tree, this process
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.conv_timing_tree:
        print("conv_timing " + json.dumps(
            conv_timing_tree(args.conv_timing_tree.resolve())), flush=True)
        return 0
    if args.conv_timing is not None:
        return conv_timing([p.resolve() for p in args.conv_timing] or [REPO])
    sys.path.insert(0, str(REPO))
    import s2st_tpu_torch  # noqa: F401  (fails outside the repository)
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.models.s2st_transformer import subsampled_length
    # fp32 means fp32 here: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = gpu_identity()
    print(f"gpu: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    main_lengths = [subsampled_length(recipe_config(), n)
                    for n in UTT_FRAMES]
    train_lengths = [subsampled_length(recipe_config(), n)
                     for n in TRAIN_FRAMES]
    for name, hmma in build_kernels().items():
        if name.startswith("flash_attention") and hmma == 0:
            raise AssertionError(f"{name}: no tensor-core instruction in "
                                 f"the SASS")
    fwd = kernel_phase(card, main_lengths, train_lengths)
    serving = fwd["serving_encoder_self"]
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        served = serve_phase(work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    agreement_phase(card)
    profile_phase(card)
    bwds = backward_phase(card, train_lengths)
    bwd = bwds["train_encoder_self"]
    trained = train_phase(card)
    try:
        train_agreement_phase(card)
        train_profile_phase(card, trained["data"])
        runtime = runtime_phase(card, trained["data"])
    finally:
        shutil.rmtree(trained["work"], ignore_errors=True)
    conv = conv_kernel_phase(card)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_text_"))
    try:
        text = text_serve_phase(work, card)
        text_agreement_phase(card)
        text_profile_phase(card, text)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    a = trained["a"]
    shapes = attention_shapes(fwd, bwds)
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "s2st_tpu_torch/csrc/flash_attention.cu",
        "replaces": "s2st_tpu/nn/attention.py:85",
        "design": ka.DESIGNS,
        "launches": served["launches"],
        "launches_by_path": {"serve": served["launches"],
                             "train": a["fwd_launches"],
                             "train_runtime": runtime["fwd_launches"]},
        "max_abs_err": serving["max_abs_err"],
        "ms": serving["kernel_graph_ms"],
        "plain_ms": serving["plain_graph_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_graph_ms"],
        "shapes": shapes["forward"],
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "s2st_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "s2st_tpu/nn/attention.py:85",
        "design": ka.DESIGNS,
        "launches": a["bwd_launches"],
        "launches_by_path": {"train": a["bwd_launches"],
                             "train_runtime": runtime["bwd_launches"]},
        "launches_per_update": a["bwd_launches"] / a["updates"],
        "max_abs_err": bwd["max_abs_err"],
        "ms": bwd["bwd_graph_ms"],
        "plain_ms": bwd["plain_bwd_graph_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_bwd_graph_ms"],
        "shapes": shapes["backward"],
    }]
    from s2st_tpu_torch.kernels import conv as kc
    for kind, beam_run, score_run, line in (("lightconv", "a", "c", 81),
                                            ("dynamicconv", "b", "d", 162)):
        rec = conv[kind]
        kernels.append({
            "name": kind,
            "route": "cuda",
            "source": f"s2st_tpu_torch/csrc/{kind}.cu",
            "replaces": f"s2st_tpu/ops/conv_kernels.py:{line}",
            "design": kc.DESIGNS[kind],
            "launches": text[beam_run]["counts"][kind],
            "launches_by_path": {
                "beam": text[beam_run]["counts"][kind],
                "score_reference": text[score_run]["counts"][kind]},
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["kernel_graph_ms"],
            "plain_ms": rec["plain_graph_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_graph_ms"],
            "batch_ms": rec["batch_ms"],
            "batch_bound_ms": rec["batch_bound_ms"],
        })
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"gpu: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
