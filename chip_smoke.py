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
   version at the serving path's shapes, in fp32 (the CUDA-core design:
   register tiles, a cp.async ring, head_dim compiled in) at head_dim 128,
   16 (the aux decoders') and 64 (the HuBERT frontend's, 12 heads) and in
   bf16 (the tensor-core design) at 128, with its device time by
   CUDA-graph replay beside the plain version's, SDPA's (a yardstick only)
   and the card's bound; at the bf16 serving shape also torch.profiler's
   sums beside them. At the serving encoder shape (B=4) in fp32 too; in
   bf16 also at the encoder shapes of the training batch (B=8) and of
   batches of the recipe's size (B=60 to train, B=100 to serve, T'=250).
   Then MultiheadAttention at head_dims the kernel does not take, 4 (64-d,
   16 heads) and 256 (512-d, 2 heads), fp32 and bf16, causal and not, with
   key padding: it must run through attend, launch no kernel and match
   attend, while flash_attention itself refuses those head_dims.
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
   in fp32 (the CUDA-core design: register tiles, two launches) and bf16,
   with its device time by graph replay beside the plain backward's,
   SDPA's backward (a yardstick only) and the card's bound; in bf16 also
   at a training batch of the recipe's size (B=60, T'=250). In each type,
   two calls on the same inputs must give equal bits (no atomics).
6. Train: write a corpus of 8 utterances (400-1000 80-d fbank frames,
   log-mel targets, phone and word lines, their dictionaries, GCMVN and
   SpecAugment in config.yaml) and run the port's train CLI in bf16 with
   the recipe's stage-5 flags at full width: (a) with
   --use-flash-attention --attention-dropout 0 for 5 updates, where both
   kernels must launch at least 27 times an update, the loss and grad norm
   stay finite, checkpoint_last.npz is written and the port's
   generate_waveform serves an utterance from it with stage 7's exact line
   (--dump-target --dump-plots: finite target features and *_targ.wav
   too; plots skipped with a warning where matplotlib is missing); (b)
   with the recipe's
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
   ms and MB, and the seconds the average took. (b) The fp32 backward
   kernel's path end to end: the train CLI in fp32 (the recipe's flags
   without --fp16, with --use-flash-attention --attention-dropout 0) for
   one epoch of the recipe's batches, where both kernels launch at least
   27 times an update; ms an update, then one update under torch.profiler:
   device ms, idle share, and the backward kernel's device ms and
   launches.
14. Stages 10-11: write a corpus of 64 utterances (400-1000 80-d fbank
   frames, 20-40 phones, 8-20 words) and a seeded random checkpoint of
   the recipe's model at full width, then run the port's
   generate_for_s2st in bf16 with the recipe's lines (--max-tokens 50000
   --beam 5): (a) --scoring wer --wer-lowercase --wer-remove-punct, (b)
   --scoring sacrebleu, (c) --score-reference. The attention kernel
   launches exactly 12 times a batch in (a) and (b) (the encoder) and 14
   in (c) (the aux ST decoder's two at D = 16); each run prints 64 finite
   H- lines and its score line, sentences/s, encode ms and beam ms a step.
   The first kernel call of each distinct shape in the three runs (the
   encoder at each batch size, the D = 16 causal and cross calls of (c))
   is kept with its inputs and held against the plain version on them.
   Then one beam batch (encode, beam loop) under torch.profiler.
15. Validate: the port's train CLI at full width in bf16 with 6(a)'s flags
   and validation on (--eval-inference --best-checkpoint-metric mcd_loss
   --valid-subset dev, no --disable-validation), 2 epochs of one update
   on 16 utterances, each validated on a dev split of 16: each
   validation's loss, mcd_loss, ins_rate, del_rate and the synchronised ms
   of its loss pass, AR decode, Griffin-Lim, MFCC and DTW;
   checkpoint_best.npz follows the second validation's mcd_loss; the
   attention kernel launches 27 times an update and 27 + 12 a validation
   batch; the first kernel call of each distinct shape in the run is held
   against the plain version on its inputs. The card's DTW on the first
   validation batch's distance matrix
   must equal the CPU's (insertions and deletions; distortion within rtol
   1e-5); its device time and launches under torch.profiler.
16. The frozen HuBERT frontend (--use-hubert True) at hubert-base width
   (7 convs of 512 channels, 12 post-LN layers of 768-d, 12 heads, FFN
   3072) before the recipe's model: (a) the attention kernel at the
   frontend's shape (B=16, T'=511 keys of which 199-499 valid, H=12,
   D=64), fp32 (the path's type: the frontend computes in fp32 past its
   GroupNorm, as JAX's does; the CUDA-core design) and bf16, held against
   the plain version and timed by graph replay beside SDPA and the bound
   (``shape`` lines, which name the design); (b) a
   small frontend of head_dim 64 on the card against the CPU in fp32
   (atol 1e-4); (c) on 16 source WAVs of 10 s down to 4 s (a ``src_orig``
   column; ``src_n_frames`` the fbank frames stage 3 writes), a seeded
   hubert-base .pt in fairseq's layout (weight_g/weight_v and the
   pretraining leaves): the port's train CLI with the recipe's flags,
   --fp16, --use-hubert True --load-pretrained-hubert-from for 3 updates,
   validated after the third with --eval-inference on a dev split of the
   16, where the kernel launches 12 times an update (the frontend; the
   recipe's attention dropout keeps the S2ST layers plain) and 39 + 24 in
   the validation, and the frontend's parameters stay bit-unchanged with
   zero Adam moments;
   generate_waveform with stage 7's line plus --use-hubert True (24
   launches a batch: frontend and encoder); generate_for_s2st --scoring
   wer with --use-hubert True (24 a batch). The first kernel call of each
   distinct shape of the three runs is held against the plain version.
   Prints launches by path, peak memory, and the wall and device ms and
   idle share of one served batch's frontend, encoder (device ms by graph
   replay) and 30-step decode (torch.profiler's sum); a device time past
   the wall fails the phase.

Prints the card's name and power limit, one JSON line of kernel
measurements, and, last, {"ok": true, "device": {...}}.

    python3 chip_smoke.py --fp32-update-timing [DIR ...]

runs phase 13(b) alone, for this checkout's s2st_tpu_torch or the one
under each DIR (each in its own process, on one corpus; parent, change,
change, parent), and prints one ``fp32_update`` JSON line a tree.

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


def attention_inputs(b, tq, tk, lengths, dtype, seed, d=HEAD_DIM, h=HEADS):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape_q, shape_k = (b, tq, h, d), (b, tk, h, d)
    q = (torch.randn(shape_q, generator=g, device="cuda")
         * d ** -0.5).to(dtype)
    k = torch.randn(shape_k, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape_k, generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, device="cuda")
    kpm = torch.arange(tk, device="cuda")[None, :] >= lens[:, None]
    return q, k, v, kpm


def attention_bound_ms(q, k, kpm, causal, backward=False) -> tuple:
    """Least time for the function on this card: each input read once and
    each output written once, against the products this data needs. A
    query row needs the valid keys it may see (those up to itself where
    causal); a row that sees none needs every key, since its output is
    the mean of all of v. Only the rows of k and v that some query needs
    are read: a batch row's valid keys, or all tk where it has none.
    Forward: q, k, v in, o out; 2 products. Backward: q, k, v, o, dO and
    the fp32 row statistics in, dq, dk, dv out (dk and dv in full); 5
    products (S recomputed, dV, dP, dQ, dK)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    size = q.element_size()
    valid = ~kpm.cpu().numpy()
    seen = np.cumsum(valid, axis=1)          # valid keys 0..j of each row
    pairs = kv_rows = 0
    for bi in range(b):
        n_valid = int(seen[bi, -1])
        kv_rows += n_valid or tk
        if causal:
            sees = seen[bi, np.minimum(np.arange(tq), tk - 1)]
        else:
            sees = np.full(tq, n_valid)
        pairs += int(np.where(sees > 0, sees, tk).sum())
    kv_bytes = 2 * kv_rows * h * d * size
    if backward:
        nbytes = (4 * q.numel() + 2 * k.numel()) * size + kv_bytes \
            + kpm.numel() + 2 * 4 * b * h * tq
    else:
        nbytes = 2 * q.numel() * size + kv_bytes + kpm.numel()
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
               device_times=False, h=HEADS, d=HEAD_DIM):
    q, k, v, kpm = attention_inputs(b, tq, tk, lengths, dtype, seed=tq + tk,
                                    d=d, h=h)
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
        "B": b, "Tq": tq, "Tk": tk, "H": h, "D": d,
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
    """Phase 1; returns the records of the main shapes by case (bf16, and
    fp32 at the serving encoder's)."""
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
    # fp32 also at the aux decoders' head_dim 16 (64-d, 4 heads) and the
    # HuBERT frontend's 64 (768-d, 12 heads)
    for d, h in ((16, 4), (64, 12)):
        for name, *case in cases:
            check_case(ka, f"{name}_D{d}", *case, dtype=torch.float32,
                       card=card, h=h, d=d)
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
    t = main_lengths[0]
    main["serving_encoder_self_fp32"] = check_case(
        ka, "serving_encoder_self_fp32", len(main_lengths), t, t,
        main_lengths, False, torch.float32, card)
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
            is_main = case[0] == "train_encoder_self"
            rec = check_bwd_case(ka, *case, dtype=dtype, card=card,
                                 device_times=is_main
                                 and dtype == torch.bfloat16)
            if is_main:
                main[case[0] + ("_fp32" if dtype == torch.float32
                                else "")] = rec
        bwd_reproducible(ka, t, train_lengths, dtype, card)
    lengths = recipe_lengths(RECIPE_BATCHES["recipe_train_B60"])
    main["recipe_train_B60"] = check_bwd_case(
        ka, "recipe_train_B60", len(lengths), lengths[0], lengths[0],
        lengths, False, HEAD_DIM, torch.bfloat16, card)
    return main


def bwd_reproducible(ka, t, lengths, dtype, card) -> None:
    """Two backward calls on the same inputs (phase 5's training encoder
    shape) give equal bits: no atomics, every sum in a fixed order."""
    q, k, v, kpm = attention_inputs(len(lengths), t, t, lengths, dtype,
                                    seed=5)
    g = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(6),
                    device="cuda").to(dtype)
    out, row_max, row_logsum = ka.flash_attention_forward(q, k, v, kpm,
                                                          stats=True)
    first = ka.flash_attention_backward(q, k, v, out, row_max, row_logsum, g,
                                        kpm)
    again = ka.flash_attention_backward(q, k, v, out, row_max, row_logsum, g,
                                        kpm)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"bwd_reproducible {str(dtype).split('.')[-1]}: two calls at B="
          f"{len(lengths)}, T'={t} give equal dq, dk, dv: {equal} ({card})",
          flush=True)
    if not equal:
        raise AssertionError(f"bwd {dtype}: two calls on the same inputs "
                             f"differ")


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
    just before it; returns the counts, the per-update log, the
    validations' records and peak memory."""
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
    valid = [rec for rec in log if "valid" in rec]
    log = [rec for rec in log if "valid" not in rec]
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
           "gnorms": [r["gnorm"] for r in log], "valid": valid}
    out["target_frames_per_s"] = frames / (out["step_ms"] / 1e3)
    print(f"train ({label}): {out['updates']} updates in {wall:.1f} s; "
          f"{out['step_ms']:.3f} ms/update after the first "
          f"({out['first_step_ms']:.1f} ms), {out['target_frames_per_s']:.0f} "
          f"target frames/s ({frames} a batch), peak memory "
          f"{out['peak_gib']:.2f} GiB; flash_attention launches fwd {fwd} "
          f"bwd {bwd}; losses {out['losses']}; grad norms {out['gnorms']} "
          f"({card})", flush=True)
    return out


def serve_from_checkpoint(work: Path, data: Path, ckpt: Path,
                          extra: tuple = ()) -> None:
    """Stage 7's exact line (recipes/run_baseline.sh:177-178, with
    --dump-target --dump-plots, and ``extra``) on the trained checkpoint:
    every utterance gets finite predicted and target features and both
    WAVs; the plots are drawn where matplotlib is importable, else skipped
    with a warning."""
    import importlib.util
    from s2st_tpu_torch.cli import generate_waveform
    out = work / "served"
    argv = [str(data), "--config-yaml", "config.yaml", "--gen-subset", "tst",
            "--task", "s2s_translation", "--path", str(ckpt),
            "--results-path", str(out), "--max-iter", "30",
            "--eos-prob-threshold", "1.5", "--spec-bwd-max-iter", "8",
            "--fp16", "--dump-waveforms", "--dump-features",
            "--dump-target", "--dump-plots", "--device", "cuda", *extra]
    if generate_waveform.main(argv) != 0:
        raise AssertionError("generate_waveform from the trained "
                             "checkpoint failed")
    ids = [line.split("\t")[0] for line in
           (data / "tst.tsv").read_text().splitlines()[1:]]
    plots = importlib.util.find_spec("matplotlib") is not None
    for uid in ids:
        feat = np.load(out / "feat" / f"{uid}_pred.npy")
        if feat.shape != (120, 80) or not np.isfinite(feat).all():
            raise AssertionError(f"served {uid} features {feat.shape} not "
                                 f"finite (120, 80)")
        targ = np.load(out / "feat" / f"{uid}_targ.npy")
        if targ.ndim != 2 or targ.shape[1] != 80 or not len(targ) \
                or not np.isfinite(targ).all():
            raise AssertionError(f"served {uid} target features "
                                 f"{targ.shape} not finite (T, 80)")
        for kind, n_frames in (("pred", 120), ("targ", len(targ))):
            with wave.open(str(out / "wav" / f"{uid}_{kind}.wav"), "rb") as w:
                if (w.getsampwidth(), w.getnchannels(), w.getframerate(),
                        w.getnframes()) != (2, 1, 16000, 256 * (n_frames - 1)):
                    raise AssertionError(
                        f"{uid}_{kind}.wav: not 16 kHz mono PCM16 of "
                        f"{256 * (n_frames - 1)} samples")
        if plots != (out / "plots" / f"{uid}.png").is_file():
            raise AssertionError(f"{uid}: plot written {not plots} with "
                                 f"matplotlib importable {plots}")
    print(f"train: served {ids} from {ckpt.name} with stage 7's exact line: "
          f"pred features (120, 80) and target features {targ.shape} "
          f"finite, *_pred.wav and *_targ.wav written, plots "
          f"{'drawn' if plots else 'skipped (no matplotlib)'}", flush=True)


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


def train_profile_phase(card: str, data: Path, label: str = "train_update",
                        fp16: bool = True) -> dict:
    """Phase 8: one bf16 update (fp32 without ``fp16``) of 6(a)'s model
    and batch (the corpus's first batch under --max-tokens 60000, as the
    train CLI cuts it) under torch.profiler, after two warm-up updates;
    returns its wall and device ms and the attention kernels' device ms
    and launches by name."""
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
        [a for a in recipe_train_argv(data, data / "unused", 1)
         if fp16 or a != "--fp16"]
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
    bwd = [(ms, count) for name, ms, count in attn
           if name.startswith("attn_bwd")]
    return {"wall_ms": wall, "device_ms": busy, "idle": 1 - busy / wall,
            "attention_ms": attn_ms,
            "bwd_kernel_ms": sum(ms for ms, _ in bwd),
            "bwd_kernel_launches": sum(count for _, count in bwd)}


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
    out["fp32"] = fp32_update_phase(card, data, root)
    return out


def fp32_update_phase(card: str, data: Path, root: Path) -> dict:
    """Phase 13(b), the fp32 backward kernel's path end to end: stage-5
    training in fp32 through the kernels, the train CLI with the recipe's
    flags but no --fp16, with --use-flash-attention --attention-dropout 0,
    over one epoch of the recipe's batches (``data``: RECIPE_BATCH_FRAMES,
    4 batches of 56-72 utterances), every count set to 0 just before; ms an
    update (the mean of updates 2-4); then one update of the first batch
    under torch.profiler, as phase 8: device ms, idle share, and the
    backward kernel's device ms and launches."""
    save = root / "fp32_update"
    save.mkdir()
    argv = [a for a in recipe_train_argv(data, save, 4) if a != "--fp16"] \
        + ["--use-flash-attention", "--attention-dropout", "0", "--no-save"]
    torch.cuda.reset_peak_memory_stats()
    fwd, bwd = run_counted(argv)
    log = [json.loads(line) for line in
           (save / "log.jsonl").read_text().splitlines()]
    if len(log) != 4 or not all(np.isfinite(r["loss"]) for r in log):
        raise AssertionError(f"fp32 update: {len(log)} updates; want 4 with "
                             f"finite losses")
    if fwd < 27 * 4 or bwd < 27 * 4:
        raise AssertionError(f"fp32 update: {fwd} forward and {bwd} backward "
                             f"kernel calls over 4 updates; want >= 27 each "
                             f"an update")
    steady = [r["step_ms"] for r in log[1:]]
    out = {"ms": sum(steady) / len(steady), "min_ms": min(steady),
           "max_ms": max(steady), "first_ms": log[0]["step_ms"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "fwd_launches": fwd, "bwd_launches": bwd,
           "bwd_calls_per_update": bwd / len(log),
           "profile": train_profile_phase(
               card, data, "train_update_fp32_recipe_batch", fp16=False)}
    prof = out["profile"]
    print(f"train fp32: ms/update in the recipe's batches (no --fp16, "
          f"--use-flash-attention --attention-dropout 0), mean of updates "
          f"2-4: {out['ms']:.3f} (min {out['min_ms']:.3f}, max "
          f"{out['max_ms']:.3f}, first {out['first_ms']:.1f}; peak memory "
          f"{out['peak_gib']:.2f} GiB); {bwd / len(log):.1f} backward calls "
          f"an update; one update under the profiler: device "
          f"{prof['device_ms']:.3f} ms of {prof['wall_ms']:.3f} wall (idle "
          f"{prof['idle']:.3f}), the backward kernel "
          f"{prof['bwd_kernel_ms']:.3f} ms in "
          f"{prof['bwd_kernel_launches']} launches "
          f"({prof['bwd_kernel_ms'] / prof['device_ms']:.3f} of the device "
          f"time) ({card})", flush=True)
    return out


def fp32_update_timing(roots: list) -> int:
    """--fp32-update-timing: phase 13(b) for each tree (this checkout's
    s2st_tpu_torch by default, else the one under each DIR, through its
    train CLI), each in a process of its own after every tree's attention
    kernels are built in parallel, on one corpus: parent, change, change,
    parent in one call."""
    card = gpu_identity()
    print(f"gpu: {card}", flush=True)
    if not build_trees(roots, ["flash_attention", "flash_attention_bwd"]):
        print("chip_smoke: an attention build failed", file=sys.stderr)
        return 1
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fp32_"))
    try:
        write_train_corpus(work / "data", seed=5, frames=RECIPE_BATCH_FRAMES)
        failed = [str(root) for root in roots if subprocess.run(
            [sys.executable, __file__, "--fp32-update-tree", str(root),
             str(work / "data")]).returncode]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"gpu: {card}", flush=True)
    if failed:
        print(f"chip_smoke: fp32 update failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


def fp32_update_tree(root: Path, data: Path) -> dict:
    """One tree of --fp32-update-timing, in this process."""
    sys.path.insert(0, str(root))
    from s2st_tpu_torch.kernels import attention as ka
    if not Path(ka.__file__).resolve().is_relative_to(root.resolve()):
        raise AssertionError(f"imported {ka.__file__}, not under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fp32_tree_"))
    try:
        return {"tree": str(root),
                **fp32_update_phase(gpu_identity(), data, work)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


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


def build_trees(roots, names) -> bool:
    """Build the named kernel libraries of each tree's s2st_tpu_torch, one
    process a tree, all started together; whether every build passed."""
    t0 = time.perf_counter()
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from s2st_tpu_torch.kernels import nvcc; nvcc.build(sys.argv[2:])",
         str(root), *names])
        for root in dict.fromkeys(roots)]
    ok = not any([p.wait() for p in builds])
    print(f"built {len(builds)} trees in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ok


def conv_timing(roots: list) -> int:
    """--conv-timing: build every tree's conv kernels in parallel, then
    time each tree in a process of its own."""
    card = gpu_identity()
    print(f"gpu: {card}", flush=True)
    if not build_trees(roots, ["lightconv", "dynamicconv"]):
        print("chip_smoke: a conv build failed", file=sys.stderr)
        return 1
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
    found = re.match(r"Generate test with beam=5: BLEU = (\S+) ", lines[-1])
    bleu = float(found.group(1)) if found else float("nan")
    if len(hyps) != TEXT_PAIRS or not np.isfinite(scores).all() or \
            not np.isfinite(bleu):
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


# --------------------------------------------------------------------------
# phases 14-15: aux-decoder text serving (stages 10-11) and validation
# --------------------------------------------------------------------------

# Phase 14's corpus: 64 utterances of 400-1000 source frames, which
# --max-tokens 50000 (and --required-batch-size-multiple 8) cuts into
# batches of about 48 and 16
S2T_FRAMES = tuple(int(n) for n in
                   np.random.RandomState(12).randint(400, 1001, 64))
# Phase 15's dev split: 16 utterances, one batch under --max-tokens 60000
VALID_FRAMES = tuple(int(n) for n in
                     np.random.RandomState(13).randint(400, 1001, 16))


def s2t_argv(data: Path, ckpt: Path, out: Path, mode: str) -> list:
    """recipes/run_baseline.sh:213-240 (stage 10 with ``wer``, 11 with
    ``sacrebleu``) with the recipe's values, or stage 11 scoring the
    references."""
    argv = [str(data), "--config-yaml", "config.yaml", "--gen-subset", "test",
            "--task", "s2s_translation", "--path", str(ckpt),
            "--max-tokens", "50000", "--beam", "5", "--middle-layers", "4,9",
            "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3",
            "--encoder-normalize-before", "--decoder-normalize-before",
            "--fp16", "--asr-decoder-layers", "1", "--st-decoder-layers", "1",
            "--asr-decoder-embed-dim", "64", "--st-decoder-embed-dim", "64",
            "--prenet-dim", "32", "--results-path", str(out),
            "--device", "cuda"]
    return argv + {"wer": ["--scoring", "wer", "--wer-lowercase",
                           "--wer-remove-punct"],
                   "sacrebleu": ["--scoring", "sacrebleu"],
                   "score_reference": ["--scoring", "sacrebleu",
                                       "--score-reference"]}[mode]


def run_s2t_cli(argv, card: str, label: str,
                n_rows: int = len(S2T_FRAMES)) -> dict:
    """One run of the port's generate_for_s2st over ``n_rows`` utterances
    with the attention kernel's count set to 0 just before it; its lines
    are kept, not printed."""
    import contextlib
    import io
    from s2st_tpu_torch.cli import generate_for_s2st
    from s2st_tpu_torch.kernels import attention as ka
    buf = io.StringIO()
    ka.flash_attention.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = generate_for_s2st.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ka.flash_attention.launches
    if rc != 0:
        raise AssertionError(f"generate_for_s2st ({label}) returned {rc}")
    lines = [ln for ln in buf.getvalue().splitlines()
             if re.match(r"^[STHDP]-|^Generate ", ln)]
    hyps = [ln for ln in lines if ln.startswith("H-")]
    scores = [float(ln.split("\t")[1]) for ln in hyps]
    if len(hyps) != n_rows or not np.isfinite(scores).all():
        raise AssertionError(f"generate_for_s2st ({label}): {len(hyps)} "
                             f"H- lines, want {n_rows} finite")
    timing = json.loads((Path(argv[argv.index("--results-path") + 1])
                         / "timing.json").read_text())
    return {"lines": lines, "launches": launches, "wall_s": wall,
            "timing": timing, "result": lines[-1]}


def s2t_phase(card: str) -> dict:
    """Phase 14: stages 10 and 11 at the recipe's width in bf16 through
    the port's generate_for_s2st, on 64 utterances, from a seeded random
    checkpoint: (a) --scoring wer --wer-lowercase --wer-remove-punct, (b)
    --scoring sacrebleu, (c) --score-reference. The attention kernel must
    launch exactly 12 times a batch in (a) and (b) (the encoder; the beam's
    one-token steps take the plain attend) and 14 in (c) (the aux ST
    decoder's causal self- and cross-attention at D = 16). Then one beam
    batch (encode, beam loop) under torch.profiler."""
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.iterators import EpochBatchIterator
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit, to_device
    from s2st_tpu_torch.generate.sequence_generator import (BeamConfig,
                                                            beam_search_aux)
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import (S2STTransformer,
                                                        cast_for_inference)
    from s2st_tpu_torch.tasks.s2s_translation import load_dictionaries
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_s2t_"))
    try:
        data = work / "data"
        write_train_corpus(data, seed=7, frames=S2T_FRAMES)
        shutil.copy(data / "train.tsv", data / "test.tsv")
        data_cfg = S2STDataConfig(data / "config.yaml")
        dicts = load_dictionaries(str(data), data_cfg)
        cfg = recipe_config().replace(src_vocab_size=len(dicts[0]),
                                      tgt_vocab_size=len(dicts[1]))
        model = S2STTransformer(cfg).init_weights(4)
        ckpt = work / "checkpoint_random.npz"
        write_jax_checkpoint(str(ckpt), model, meta={"args": RECIPE_ARGS})
        # a first run warms cuBLAS/cuDNN for these shapes
        run_s2t_cli(s2t_argv(data, ckpt, work / "warmup", "wer"), card,
                    "warm-up")
        runs = {}
        with RecordAttention() as rec_attn:
            for mode in ("wer", "sacrebleu", "score_reference"):
                runs[mode] = run_s2t_cli(
                    s2t_argv(data, ckpt, work / mode, mode), card, mode)
        for mode, rec in runs.items():
            batches = rec["timing"]["batches"]
            per_batch = 14 if mode == "score_reference" else 12
            if rec["launches"] != per_batch * len(batches):
                raise AssertionError(
                    f"generate_for_s2st ({mode}): flash_attention launched "
                    f"{rec['launches']} times for {len(batches)} batches; "
                    f"want {per_batch} a batch")
            for b in batches:
                detail = (f"forward_ms {b['forward_ms']:.3f}"
                          if mode == "score_reference" else
                          f"beam_ms {b['beam_ms']:.3f} over "
                          f"{b['decode_steps']} steps "
                          f"({b['beam_ms'] / b['decode_steps']:.3f} ms/step)")
                print(f"s2t ({mode}) batch {b['batch']}: rows {b['rows']}, "
                      f"source frames {b['src_frames']}, encode_ms "
                      f"{b['encode_ms']:.3f}, {detail} ({card})", flush=True)
            t = rec["timing"]
            print(f"s2t ({mode}): {t['sentences']} sentences, "
                  f"{t['sentences_per_s']:.2f} sentences/s, "
                  f"{t['target_tokens_per_s']:.1f} tokens/s, wall "
                  f"{rec['wall_s']:.2f} s; flash_attention launches "
                  f"{rec['launches']} ({per_batch} a batch); "
                  f"{rec['result']} ({card})", flush=True)
        if not runs["wer"]["result"].startswith(
                "Generate test with beam=5: WER: ") or not all(
                runs[m]["result"].startswith("Generate test with beam=5: "
                                             "BLEU = ")
                for m in ("sacrebleu", "score_reference")):
            raise AssertionError("generate_for_s2st: unexpected score lines "
                                 + repr([r["result"] for r in runs.values()]))
        runs["path_max_abs_err"] = hold_path_attention(
            rec_attn.calls, "generate_for_s2st", card)

        # one beam batch of (b) under the profiler
        bf = cast_for_inference(
            S2STTransformer(cfg.replace(dtype=torch.bfloat16)).to("cuda"),
            torch.bfloat16)
        bf.load_state_dict(model.state_dict())
        bf.eval()
        split = TrainSplit(str(data), data_cfg, "test", *dicts,
                           n_frames_per_step=4)
        batch = next(EpochBatchIterator(split, 50000, None,
                                        required_batch_size_multiple=8,
                                        shuffle=False).next_epoch_itr())
        n = len(batch["id"])
        batch = to_device({k: v[:n] for k, v in batch.items()
                           if isinstance(v, torch.Tensor)}, "cuda")
        bs_cfg = BeamConfig(beam=5, max_len=200)
        with torch.inference_mode():
            for _ in range(2):        # the second pass is the one reported
                enc, *rec_enc = _profiled(lambda: bf.encode(
                    batch["src_speech"], batch["src_speech_lens"]))
                out, *rec_beam = _profiled(lambda: beam_search_aux(
                    bf.aux_st_decoder, enc["out_middle_layers"][1],
                    enc["encoder_padding_mask"], bs_cfg))
        for name, (wall, busy, launches, top) in (("encode", rec_enc),
                                                  ("beam", rec_beam)):
            print(f"profile s2t_{name}: rows {n}, wall_ms {wall:.3f}, "
                  f"device_kernel_ms {busy:.3f} in {launches} device "
                  f"activities, idle share {1 - busy / wall:.3f}"
                  + (f", {out['steps']} steps" if name == "beam" else "")
                  + f" ({card})", flush=True)
            for key, ms, count in top[:6]:
                print(f"profile s2t_{name}:   {ms:9.3f} ms  {count:6d}x  "
                      f"{key[:60]}", flush=True)
        return runs
    finally:
        shutil.rmtree(work, ignore_errors=True)


class RecordAttention:
    """Keeps, for each distinct call of the attention forward kernel on a
    main path (shapes, dtype, causal, with or without a key padding mask),
    the first call's inputs and the output the path got. It launches
    nothing; ``hold_path_attention`` then holds each against the plain
    version."""

    def __enter__(self):
        from s2st_tpu_torch.kernels import attention as ka
        self.ka, self.fn, self.calls = ka, ka.flash_attention_forward, {}

        def record(q, k, v, kpm=None, causal=False, stats=False):
            out = self.fn(q, k, v, kpm, causal, stats)
            key = (tuple(q.shape), k.shape[1], str(q.dtype).split(".")[-1],
                   bool(causal), kpm is not None)
            if key not in self.calls:
                self.calls[key] = tuple(
                    None if x is None else x.detach().clone()
                    for x in (q, k, v, kpm, out[0]))
            return out
        ka.flash_attention_forward = record
        return self

    def __exit__(self, *exc):
        self.ka.flash_attention_forward = self.fn


def hold_path_attention(calls: dict, label: str, card: str) -> float:
    """Each recorded call's kernel output against the plain version on the
    same inputs. fp32: atol 1e-5 + rtol 1e-5 (TOL_FP32); bf16: max abs err
    <= 2e-2 x max(1, max |v| / 4): phase 1's bound (TOL_BF16) for its
    unit-normal values, whose largest |v| is about 4, scaled with |v|
    beyond that, since the output is a convex combination of v's rows
    rounded to bf16. Returns the largest error."""
    from s2st_tpu_torch.kernels import attention as ka
    worst = 0.0
    with torch.inference_mode():
        for (shape, tk, dtype, causal, masked), (q, k, v, kpm, out) in \
                calls.items():
            ref = ka.flash_attention_reference(q, k, v, kpm, causal)
            err = (out.float() - ref.float()).abs()
            max_err = float(err.max()) if err.numel() else 0.0
            if dtype == "float32":
                atol, rtol = TOL_FP32
                ok = bool((err <= atol + rtol * ref.float().abs()).all())
                tol = f"atol {atol} + rtol {rtol}"
            else:
                bound = TOL_BF16 * max(1.0,
                                       float(v.float().abs().max()) / 4)
                ok = max_err <= bound
                tol = f"atol {bound:.4g}"
            ok = ok and bool(torch.isfinite(out.float()).all())
            b, tq, h, d = shape
            print("path_case " + json.dumps({
                "path": label, "B": b, "Tq": tq, "Tk": tk, "H": h, "D": d,
                "dtype": dtype, "causal": causal, "key_padding": masked,
                "max_abs_err": max_err, "tolerance": tol, "card": card}),
                flush=True)
            if not ok:
                raise AssertionError(
                    f"{label}: the attention kernel's output at B={b} "
                    f"Tq={tq} Tk={tk} D={d} {dtype} causal={causal} "
                    f"disagrees with the plain version: max abs err "
                    f"{max_err} ({tol})")
            worst = max(worst, max_err)
    print(f"{label}: {len(calls)} distinct attention kernel calls held "
          f"against the plain version, max abs err {worst:.3e} ({card})",
          flush=True)
    return worst


class RecordDTW:
    """Keeps the first distance matrix (and lengths) that the validation's
    ``batch_dtw`` is given, and its result."""

    def __enter__(self):
        from s2st_tpu_torch.ops import mcd
        self.mcd, self.fn, self.first = mcd, mcd.batch_dtw, None

        def record(dist, m_lens, n_lens):
            out = self.fn(dist, m_lens, n_lens)
            if self.first is None:
                self.first = (dist.clone(), m_lens.clone(), n_lens.clone(),
                              out)
            return out
        mcd.batch_dtw = record
        return self

    def __exit__(self, *exc):
        self.mcd.batch_dtw = self.fn


def validate_phase(card: str) -> dict:
    """Phase 15: the port's train CLI at the recipe's width in bf16 with
    6(a)'s flags and validation on (--eval-inference
    --best-checkpoint-metric mcd_loss --valid-subset dev), no
    --disable-validation: 2 epochs of one update on 16 utterances, each
    epoch validated on a dev split of 16. Prints each validation's loss,
    mcd_loss, ins_rate, del_rate and the synchronised wall ms of its loss
    pass, AR decode, Griffin-Lim, MFCC and DTW; checkpoint_best.npz must
    follow the second validation's mcd_loss. Then the card's batch_dtw on
    the first validation batch's distance matrix against the CPU's
    (insertions and deletions equal, distortion within rtol 1e-5), and
    its device time and launches under torch.profiler."""
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.ops import mcd
    from s2st_tpu_torch.train import checkpoint as pckpt
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_valid_"))
    try:
        data = work / "data"
        write_train_corpus(data, seed=9, frames=VALID_FRAMES)
        shutil.copy(data / "train.tsv", data / "dev.tsv")
        save = work / "ckpt"
        save.mkdir()
        argv = [a for a in recipe_train_argv(data, save, 100)
                if a != "--disable-validation"]
        i = argv.index("--validate-after-updates")
        del argv[i:i + 2]
        argv += ["--use-flash-attention", "--attention-dropout", "0",
                 "--max-epoch", "2"]
        from s2st_tpu_torch.cli import train
        ka.flash_attention.launches = ka.flash_attention.bwd_launches = 0
        t0 = time.perf_counter()
        with RecordDTW() as rec, RecordAttention() as rec_attn:
            rc = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = ka.flash_attention.launches, ka.flash_attention.bwd_launches
        if rc != 0:
            raise AssertionError(f"train with validation returned {rc}")
        log = [json.loads(line) for line in
               (save / "log.jsonl").read_text().splitlines()]
        valid = [r for r in log if "valid" in r]
        updates = [r for r in log if "valid" not in r]
        if len(valid) != 2 or len(updates) != 2:
            raise AssertionError(f"validate: {len(updates)} updates and "
                                 f"{len(valid)} validations; want 2 and 2")
        for v in valid:
            st, ms = v["valid"], v["ms"]
            if not all(np.isfinite(st[k]) for k in ("loss", "mcd_loss",
                                                    "ins_rate", "del_rate")):
                raise AssertionError(f"validate: non-finite stats {st}")
            print(f"validate at update {v['num_updates']}: loss "
                  f"{st['loss']:.4f}, mcd_loss {st['mcd_loss']:.4f}, "
                  f"ins_rate {st['ins_rate']:.4f}, del_rate "
                  f"{st['del_rate']:.4f}; ms: loss {ms['loss']:.1f}, decode "
                  f"{ms['decode']:.1f}, griffin_lim {ms['griffin_lim']:.1f}, "
                  f"mfcc {ms['mfcc']:.1f}, dtw {ms['dtw']:.1f}, total "
                  f"{sum(ms.values()):.1f} ({card})", flush=True)
        m1, m2 = (v["valid"]["mcd_loss"] for v in valid)
        best = pckpt.peek_meta(str(save / "checkpoint_best.npz"))
        want = 2 if m2 < m1 else 1
        if best["step"] != want:
            raise AssertionError(f"validate: checkpoint_best.npz from update "
                                 f"{best['step']}; mcd_loss {m1} then {m2} "
                                 f"picks update {want}")
        # launches: 27 a training update, and per validation batch 27 in
        # the loss pass and 12 in the AR decode's encoder
        n_batches = 1
        want_fwd = 27 * 2 + 2 * n_batches * (27 + 12)
        print(f"validate: {wall:.1f} s; flash_attention launches fwd {fwd} "
              f"(want {want_fwd}: 27 an update, 27 + 12 a validation batch)"
              f", bwd {bwd}; checkpoint_best.npz from update {best['step']} "
              f"(mcd_loss {m1:.4f} then {m2:.4f}) ({card})", flush=True)
        if fwd != want_fwd or bwd != 27 * 2:
            raise AssertionError(f"validate: flash_attention launches fwd "
                                 f"{fwd} bwd {bwd}; want {want_fwd} and 54")

        path_err = hold_path_attention(rec_attn.calls,
                                       "train_with_validation", card)

        dist, m_lens, n_lens, (dd, di, dl) = rec.first
        cpu_d, cpu_i, cpu_l = mcd.batch_dtw(dist.cpu(), m_lens.cpu(),
                                            n_lens.cpu())
        err = float(((dd.cpu() - cpu_d).abs() / cpu_d.abs()).max())
        print(f"validate: DTW on the card vs the CPU on a {tuple(dist.shape)}"
              f" distance matrix ({dist.shape[1] + dist.shape[2] - 1} "
              f"diagonals): nins {di.tolist()} / {cpu_i.tolist()}, ndel "
              f"equal {bool((dl == cpu_l).all())}, distortion max rel err "
              f"{err:.2e} (tolerance 1e-5) ({card})", flush=True)
        if not ((di == cpu_i).all() and (dl == cpu_l).all() and err <= 1e-5):
            raise AssertionError("validate: the card's DTW and the CPU's "
                                 "disagree")
        mcd.batch_dtw(dist, m_lens, n_lens)          # warm
        _, dtw_wall, busy, launches, top = _profiled(
            lambda: mcd.batch_dtw(dist, m_lens, n_lens))
        print(f"profile dtw: wall_ms {dtw_wall:.3f}, device_kernel_ms "
              f"{busy:.3f} in {launches} device activities, idle share "
              f"{1 - busy / dtw_wall:.3f} ({card})", flush=True)
        for key, ms, count in top[:5]:
            print(f"profile dtw:   {ms:9.3f} ms  {count:6d}x  {key[:60]}",
                  flush=True)
        return {"fwd_launches": fwd, "valid": valid,
                "path_max_abs_err": path_err,
                "dtw": {"wall_ms": dtw_wall, "device_ms": busy,
                        "launches": launches}}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# Phase 16: the frozen HuBERT frontend (--use-hubert True) at hubert-base
# width in front of the recipe's model. 16 source WAVs of 10 s down to 4 s
# at 16 kHz: one batch of the recipe's --max-tokens 60000 over their fbank
# frames, padded to 163840 samples, so the frontend's self-attention runs at
# B=16, T'=511 keys (199-499 valid), 12 heads of head_dim 64
HUBERT_SECONDS = tuple(float(x) for x in np.linspace(10.0, 4.0, 16))
HUBERT_HEADS, HUBERT_HEAD_DIM = 12, 64
HUBERT_FLAGS = ("--use-hubert", "True")     # hubert-base widths by default
# the frontend card vs CPU: fp32 sums in another order through 2 layers
TOL_HUBERT_AGREEMENT = 1e-4


def hubert_samples() -> list:
    return [int(round(sec * 16000)) for sec in HUBERT_SECONDS]


def hubert_lengths() -> tuple:
    """(the frontend's valid frames of each utterance, the batch's frames:
    the padded waveform's, padded as the port's iterators pad it)."""
    from s2st_tpu_torch.data.iterators import snap_len
    from s2st_tpu_torch.models.hubert import HubertConfig
    cfg, samples = HubertConfig(), hubert_samples()
    return ([cfg.output_length(n) for n in samples],
            cfg.output_length(snap_len(max(samples))))


def hubert_kernel_phase(card: str) -> dict:
    """16(a): the attention kernel at the frontend's shape, fp32 (the path's
    type: past its GroupNorm the frontend computes in fp32, as JAX's does)
    and bf16, against the plain version, timed by graph replay beside SDPA
    and the bound."""
    from s2st_tpu_torch.kernels import attention as ka
    lengths, t = hubert_lengths()
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        kind = str(dtype).split('.')[-1]
        name = f"hubert_encoder_self_D64_{kind}"
        rec = check_case(ka, name, len(lengths), t, t, lengths, False, dtype,
                         card, h=HUBERT_HEADS, d=HUBERT_HEAD_DIM)
        print("shape " + json.dumps({
            "name": name, "design": ka.DESIGNS[kind], "B": rec["B"],
            "T": t, "H": HUBERT_HEADS, "D": HUBERT_HEAD_DIM,
            "valid_keys": [min(lengths), max(lengths)],
            "ms": rec["kernel_graph_ms"], "plain_ms": rec["plain_graph_ms"],
            "library_ms": rec["library_graph_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "max_abs_err": rec["max_abs_err"], "card": card}), flush=True)
        recs[name] = rec
    return recs


def hubert_agreement_phase(card: str) -> None:
    """16(b): a small frontend (3 convs of 32 channels, 2 layers of 128-d
    with 2 heads of head_dim 64) on the card (the kernel inside) against the
    CPU (the plain attention), fp32, on rows of 1, 0.75 and 0.4 s."""
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.models.hubert import HubertConfig, HubertModel
    cfg = HubertConfig(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
                       encoder_layers=2, encoder_embed_dim=128,
                       encoder_ffn_embed_dim=256, encoder_attention_heads=2,
                       conv_pos=16, conv_pos_groups=4)
    model = HubertModel(cfg).init_weights(
        torch.Generator().manual_seed(5)).eval()
    lengths = torch.tensor([16000, 12000, 6400])
    src = np.random.RandomState(5).randn(3, 16000).astype(np.float32) * 0.1
    for i, n in enumerate(lengths.tolist()):
        src[i, n:] = 0.0
    src = torch.from_numpy(src)
    with torch.no_grad():
        cpu, cpu_lens = model.extract_features(src, lengths)
        model.to("cuda")
        ka.flash_attention.launches = 0
        gpu, gpu_lens = model.extract_features(src.cuda(), lengths.cuda())
        torch.cuda.synchronize()
    launched = ka.flash_attention.launches
    err = float((gpu.cpu() - cpu).abs().max())
    print(f"hubert agreement: card vs CPU frontend (fp32, head_dim 64) max "
          f"abs err {err:.3e}, tolerance {TOL_HUBERT_AGREEMENT}; kernel "
          f"launches {launched} ({card})", flush=True)
    if not (err <= TOL_HUBERT_AGREEMENT and launched == 2
            and gpu_lens.tolist() == cpu_lens.tolist()):
        raise AssertionError(f"hubert agreement: err {err}, {launched} "
                             f"launches, lengths {gpu_lens.tolist()} vs "
                             f"{cpu_lens.tolist()}")


def write_hubert_pt(path: Path, seed: int) -> dict:
    """A seeded hubert-base frontend in fairseq's checkpoint layout:
    pos_conv as weight_g/weight_v, the pretraining leaves of
    hubert_base_ls960.pt (mask_emb, final_proj 768 -> 256,
    label_embs_concat 504 x 256) and a plain-dict cfg. Returns the
    port reader's state dict of it."""
    from s2st_tpu_torch.models import hubert as hub
    g = torch.Generator().manual_seed(seed)
    sd = dict(hub.HubertModel(hub.HubertConfig()).init_weights(g)
              .state_dict())
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_g"] = w.pow(2).sum(
        dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv.0.weight_v"] = w
    sd["mask_emb"] = torch.rand(768, generator=g)
    sd["final_proj.weight"] = torch.randn(256, 768, generator=g) / 768 ** 0.5
    sd["final_proj.bias"] = torch.zeros(256)
    sd["label_embs_concat"] = torch.rand(504, 256, generator=g)
    torch.save({"model": sd, "cfg": {"model": {
        "conv_feature_layers": "[(512,10,5)] + [(512,3,2)] * 4 + "
                               "[(512,2,2)] * 2",
        "encoder_layers": 12, "encoder_embed_dim": 768,
        "encoder_ffn_embed_dim": 3072, "encoder_attention_heads": 12,
        "conv_pos": 128, "conv_pos_groups": 16, "layer_norm_first": False}}},
        str(path))
    return hub.load_torch_hubert(str(path))[0]


def write_hubert_corpus(root: Path, seed: int) -> None:
    """Phase 6's corpus layout over the 16 utterances, each with a source
    WAV (PCM16, seeded noise) in a ``src_orig`` column beside its fbank
    (``src_n_frames`` the fbank's 25 ms / 10 ms frames, as stage 3 writes
    them); train, dev, tst and test list all 16."""
    from s2st_tpu_torch.data.audio_utils import write_wav
    samples = hubert_samples()
    write_train_corpus(root, seed, frames=tuple(1 + (n - 400) // 160
                                                for n in samples))
    r = np.random.RandomState(seed)
    (root / "wavs").mkdir()
    for i, n in enumerate(samples):
        write_wav(str(root / "wavs" / f"utt{i}.wav"),
                  np.clip(r.randn(n) * 0.1, -1.0, 1.0), 16000)
    header, *rows = (root / "train.tsv").read_text().splitlines()
    lines = [header + "\tsrc_orig"] + [f"{row}\twavs/utt{i}.wav"
                                      for i, row in enumerate(rows)]
    for split in ("train", "dev", "tst", "test"):
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")


def hubert_frontend_state(ckpt: Path):
    """(the port model a checkpoint holds, on the CPU, built as
    generate_waveform builds it, and its flat arrays)."""
    from s2st_tpu_torch.cli.generate_waveform import get_parser
    from s2st_tpu_torch.models.config_from_args import (
        build_model_config, model_args_from_checkpoint)
    from s2st_tpu_torch.models.jax_bridge import read_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import from_jax_variables
    from s2st_tpu_torch.train import checkpoint as pckpt
    variables, meta = read_jax_checkpoint(str(ckpt))
    args = get_parser().parse_args([".", "--path", str(ckpt),
                                    "--results-path", "."])
    cfg = build_model_config(model_args_from_checkpoint(args, meta),
                             variables, 80)
    return from_jax_variables(cfg, variables), \
        pckpt.load_checkpoint_file(str(ckpt))[0]


def hubert_phase(card: str) -> dict:
    """16(c): train 3 updates with the recipe's flags, --fp16 and
    --use-hubert True --load-pretrained-hubert-from a seeded hubert-base
    .pt, validated once with --eval-inference; serve the checkpoint with
    stage 7's line plus --use-hubert True; run stage 10 (--scoring wer) on
    it; hold the first kernel call of each distinct attention shape of the
    three runs against the plain version; then the wall ms of one served
    batch's frontend, encoder and decode, their device ms and idle
    share."""
    from s2st_tpu_torch.data.manifest import GenerationSplit
    from s2st_tpu_torch.generate.speech_generator import (GenerationConfig,
                                                          decode_loop)
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.models.jax_bridge import jax_layout
    from s2st_tpu_torch.models.s2st_transformer import cast_for_inference
    from s2st_tpu_torch.tasks.s2s_translation import data_config
    from s2st_tpu_torch.train import checkpoint as pckpt
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_hubert_"))
    try:
        data = work / "data"
        write_hubert_corpus(data, seed=13)
        pt = work / "hubert_base.pt"
        trunk = write_hubert_pt(pt, seed=14)
        save = work / "ckpt"
        # the recipe's flags with its validation (--eval-inference
        # --best-checkpoint-metric mcd_loss) once, after the third update
        argv = [a for a in recipe_train_argv(data, save, 3)
                if a != "--disable-validation"]
        i = argv.index("--validate-after-updates")
        del argv[i:i + 2]
        argv += [*HUBERT_FLAGS, "--load-pretrained-hubert-from", str(pt),
                 "--save-interval", "3", "--validate-interval", "3"]
        with RecordAttention() as rec_attn:
            trained = run_train_cli(argv, save, card, "hubert: the recipe's "
                                    "flags + --use-hubert True")
            # the frontend's 12 an update (the recipe's attention dropout
            # keeps the S2ST model's attention plain in training, as in
            # JAX); the validation's loss pass 12 + 27, its decode's
            # encode 12 + 12
            want = 12 * 3 + (12 + 27) + (12 + 12)
            if trained["updates"] != 3 or \
                    trained["fwd_launches"] != want or \
                    trained["bwd_launches"]:
                raise AssertionError(
                    f"train (hubert): {trained['updates']} updates, kernel "
                    f"launches fwd {trained['fwd_launches']} bwd "
                    f"{trained['bwd_launches']}; want 3, {want}, 0")
            st = trained["valid"][0]
            if len(trained["valid"]) != 1 or not all(
                    np.isfinite(st["valid"][k])
                    for k in ("loss", "mcd_loss", "ins_rate", "del_rate")):
                raise AssertionError(f"train (hubert): validations "
                                     f"{trained['valid']}")
            print(f"validate (hubert) at update {st['num_updates']}: loss "
                  f"{st['valid']['loss']:.4f}, mcd_loss "
                  f"{st['valid']['mcd_loss']:.4f}; ms: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in st["ms"].items())
                  + f" ({card})", flush=True)
            ckpt = save / "checkpoint_last.npz"
            model, flat = hubert_frontend_state(ckpt)
            frontend = model.encoder.hubert.state_dict()
            if set(frontend) != set(trunk) or not all(
                    torch.equal(frontend[k], trunk[k]) for k in trunk):
                raise AssertionError("train (hubert): the frontend's "
                                     "parameters moved")
            keys = [key for name, key, _ in jax_layout(model)
                    if name.startswith("encoder.hubert.")]
            if any(flat[pckpt.opt_key(m, key)].any()
                   for key in keys for m in ("mu", "nu")):
                raise AssertionError("train (hubert): the frontend's Adam "
                                     "moments are not 0")
            print(f"train (hubert): the frontend's {len(keys)} parameter "
                  f"arrays ({sum(v.numel() for v in trunk.values()):,} "
                  f"values) bit-unchanged over 3 updates, their Adam "
                  f"moments 0 ({card})", flush=True)
            del model, flat

            torch.cuda.reset_peak_memory_stats()
            ka.flash_attention.launches = 0
            serve_from_checkpoint(work, data, ckpt, HUBERT_FLAGS)
            torch.cuda.synchronize()
            serve_launches = ka.flash_attention.launches
            serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
            served = json.loads((work / "served" / "timing.json").read_text())
            # 12 in the frontend (fp32) and 12 in the encoder (bf16)
            if serve_launches != 24 * len(served):
                raise AssertionError(f"serve (hubert): {serve_launches} "
                                     f"kernel launches for {len(served)} "
                                     f"batches; want 24 a batch")
            s2t = run_s2t_cli(s2t_argv(data, ckpt, work / "s2t", "wer")
                              + list(HUBERT_FLAGS), card, "hubert wer",
                              n_rows=len(HUBERT_SECONDS))
            n_s2t = len(s2t["timing"]["batches"])
            if s2t["launches"] != 24 * n_s2t or not s2t["result"].startswith(
                    "Generate test with beam=5: WER: "):
                raise AssertionError(f"generate_for_s2st (hubert): "
                                     f"{s2t['launches']} launches for "
                                     f"{n_s2t} batches, {s2t['result']}")
        print(f"hubert launches by path: train {trained['fwd_launches']} "
              f"(3 updates), serve {serve_launches} ({len(served)} batch), "
              f"generate_for_s2st {s2t['launches']} ({n_s2t} batch); peak "
              f"memory train {trained['peak_gib']:.2f} GiB, serve "
              f"{serve_peak:.2f} GiB; generate_for_s2st {s2t['result']} "
              f"({card})", flush=True)
        for rec in served:
            print(f"serve_timing (hubert) batch {rec['batch']}: rows "
                  f"{rec['rows']}, source samples {rec['src_frames']}, "
                  f"encode_ms {rec['encode_ms']:.3f} (frontend + encoder), "
                  f"decode_ms {rec['decode_ms']:.3f} over "
                  f"{rec['decode_steps']} steps ({card})", flush=True)
        path_err = hold_path_attention(rec_attn.calls, "hubert", card)

        # one served batch, phase by phase, as generate_waveform runs it
        model, _ = hubert_frontend_state(ckpt)
        model = cast_for_inference(model.to("cuda").eval(),
                                   model.cfg.dtype)
        args = argparse.Namespace(data=str(data), config_yaml="config.yaml",
                                  use_hubert=True)
        split = GenerationSplit(str(data), data_config(args), "tst", 4)
        batch = split.collate(list(range(len(split.ids))))
        src = batch["src_speech"].cuda()
        lens = batch["src_speech_lens"].cuda()
        gen_cfg = GenerationConfig(max_iter=30, eos_prob_threshold=1.5)
        g = torch.Generator("cuda").manual_seed(0)
        hub = model.encoder.hubert

        def frontend():
            return hub.extract_features(src, lens)

        def encoder():
            return model.encode(feats, flens)

        def wall_ms(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        timing = {}
        with torch.inference_mode():
            feats, flens = frontend()
            model.encoder.hubert = None          # the encoder alone
            enc = encoder()
            # the frontend and the encoder: the host's wall ms of an eager
            # call (the second of two), and the device ms of the same call
            # by graph replay, which no host gap or profiler loss enters;
            # the top kernels from torch.profiler, for their names
            for name, fn in (("frontend", frontend), ("encoder", encoder)):
                for _ in range(2):
                    _, wall = wall_ms(fn)
                busy = graph_ms(fn, iters=2, replays=3)
                _, _, _, launches, top = _profiled(fn)
                timing[name] = (wall, busy, launches, top, "graph replay")
            model.encoder.hubert = hub
            # the decode: a host loop that reads the device each step, so
            # no graph; the device ms are torch.profiler's sum
            for _ in range(2):       # the second pass is the one reported
                _, wall, busy, launches, top = _profiled(
                    lambda: decode_loop(model, gen_cfg, enc, generator=g))
            timing["decode"] = (wall, busy, launches, top, "profiler sum")
        for name, (wall, busy, launches, top, how) in timing.items():
            timing[name] = {"wall_ms": wall, "device_ms": busy,
                            "idle_share": 1 - busy / wall}
            print(f"profile hubert_{name}: rows {src.shape[0]}, samples "
                  f"{src.shape[1]}, wall_ms {wall:.3f}, device_ms "
                  f"{busy:.3f} ({how}; {launches} device activities under "
                  f"the profiler), device / wall {busy / wall:.3f}, idle "
                  f"share {1 - busy / wall:.3f} ({card})", flush=True)
            for key, ms, count in top[:6]:
                print(f"profile hubert_{name}:   {ms:9.3f} ms  {count:6d}x  "
                      f"{key[:60]}", flush=True)
            if busy > wall:
                raise AssertionError(f"hubert_{name}: device {busy} ms "
                                     f"inside a wall of {wall} ms")
        return {"train_launches": trained["fwd_launches"],
                "train_bwd_launches": trained["bwd_launches"],
                "serve_launches": serve_launches,
                "s2t_launches": s2t["launches"],
                "path_max_abs_err": path_err, "timing": timing,
                "peak_gib": {"train": trained["peak_gib"],
                             "serve": serve_peak}}
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    parser.add_argument("--fp32-update-timing", nargs="*", type=Path,
                        metavar="DIR",
                        help="only time phase 13(b), the fp32 update, with "
                             "these trees (this checkout without a DIR)")
    parser.add_argument("--fp32-update-tree", nargs=2, type=Path,
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
    if args.fp32_update_tree:
        root, data = args.fp32_update_tree
        print("fp32_update " + json.dumps(fp32_update_tree(root.resolve(),
                                                           data)), flush=True)
        return 0
    if args.fp32_update_timing is not None:
        return fp32_update_timing([p.resolve()
                                   for p in args.fp32_update_timing]
                                  or [REPO])
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
    s2t = s2t_phase(card)
    validation = validate_phase(card)
    hubert_kernel = hubert_kernel_phase(card)
    hubert_agreement_phase(card)
    hubert = hubert_phase(card)

    a = trained["a"]
    shapes = attention_shapes({**fwd, **hubert_kernel}, bwds)
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "s2st_tpu_torch/csrc/flash_attention.cu",
        "replaces": "s2st_tpu/nn/attention.py:85",
        "design": ka.DESIGNS,
        "launches": served["launches"],
        "launches_by_path": {
            "serve": served["launches"], "train": a["fwd_launches"],
            "train_runtime": runtime["fwd_launches"],
            "generate_for_s2st_wer": s2t["wer"]["launches"],
            "generate_for_s2st_sacrebleu": s2t["sacrebleu"]["launches"],
            "generate_for_s2st_score_reference":
                s2t["score_reference"]["launches"],
            "train_with_validation": validation["fwd_launches"],
            "train_hubert": hubert["train_launches"],
            "serve_hubert": hubert["serve_launches"],
            "generate_for_s2st_hubert": hubert["s2t_launches"]},
        "max_abs_err": serving["max_abs_err"],
        "path_max_abs_err": {
            "generate_for_s2st": s2t["path_max_abs_err"],
            "train_with_validation": validation["path_max_abs_err"],
            "hubert": hubert["path_max_abs_err"]},
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
        "launches_by_path": {
            "train": a["bwd_launches"],
            "train_runtime": runtime["bwd_launches"],
            "train_fp32": runtime["ms_per_update"]["fp32"]["bwd_launches"],
            "train_hubert": hubert["train_bwd_launches"]},
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
