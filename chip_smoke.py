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
10. Serve text: write a binarized de-en test split (64 pairs, sources of
   8-64 tokens, dictionaries of 8848 and 6632 types) and seeded random
   checkpoints of lightconv_iwslt_de_en at full width (7 + 6 layers,
   512-d, kernels 3..31, 4 heads, FFN 1024), then run the port's text
   generate CLI in bf16 (--batch-size 64 --beam 5 --max-len-a 1.2
   --max-len-b 10 --remove-bpe): (a) lightweight and (b) dynamic convs,
   where the used kernel launches exactly 7 times a batch and the other
   never; (c) and (d) the same with --score-reference, 13 a batch. Each
   run prints 64 H- lines and a finite BLEU line.
11. Hold the card against the CPU on a small LightConv in fp32, both conv
   types: teacher-forced logits and the beam's hypotheses.
12. Run one batch of 10(a) (encode, beam loop) under torch.profiler and
   print each one's wall time, device kernel time, idle share and top
   kernels.
13. Train through the runtime (run after 8, with 6(a)'s flags plus
   --update-freq 2, --store-ema and --keep-last-epochs 2): time an update
   at --update-freq 1 and 2 in the recipe's batches (a corpus of 256
   utterances that --max-tokens 60000 cuts into 4 batches of 56-72; two
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
14. Stages 10-11: write a corpus of 32 utterances (400-1000 80-d fbank
   frames, 20-40 phones, 8-20 words) and a seeded random checkpoint of
   the recipe's model at full width, then run the port's
   generate_for_s2st in bf16 with the recipe's lines (--max-tokens 50000
   --beam 5): (a) --scoring wer --wer-lowercase --wer-remove-punct, (b)
   --scoring sacrebleu, (c) --score-reference. The attention kernel
   launches exactly 12 times a batch in (a) and (b) (the encoder) and 14
   in (c) (the aux ST decoder's two at D = 16); each run prints 32 finite
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
17. Stages 8-9 at the recipe ASR's full width: a seeded random
   checkpoint of wav2vec2-large-960h-lv60-self's width and files in the
   hub's layout (config.json, the processor's and tokenizer's files,
   pytorch_model.bin with pos_conv's weight_g/weight_v; 7 convs of 512
   with bias and LayerNorm, 24 stable-LN layers of 1024-d, 16 heads, FFN
   4096, pos_conv 128/16, 32 tokens; 1.26 GB); recipes/run_baseline_torch.sh
   --stage 8 --stop-stage 9 over 16 WAVs at 16 kHz (phase 2's 4 stage-7
   WAVs and 12 seeded ones of 2.5-14.3 s), an audio manifest in another
   order than the files' and 4 seeded reference files. Each ``python`` of
   the recipe runs through this script (``--counted``, a ``python`` on its
   PATH), which sets the kernel counts to 0 before the module and reads
   them after: stage 8 must launch the attention kernel exactly 24 times
   an utterance (fp32, D=64, H=16, B=1), each distinct call held against
   the plain version (fp32 atol/rtol 1e-5); decode.txt must have a line a
   manifest row in the manifest's order, and stages 8 and 9 a finite BLEU
   line each. Then, in this process, the transcriber's wall ms an
   utterance, audio seconds a second, the device ms of one forward of
   the longest utterance by graph replay, the idle share of the 16
   (torch.profiler) and peak memory; the kernel at that shape (B=1, H=16,
   D=64, fp32, no mask) beside the plain version, SDPA and the bound; and
   a small wav2vec2 of head_dim 64 in each layout on the card against the
   CPU in fp32 (atol 1e-4, equal argmax ids, 2 launches).
18. The end-to-end gate (s2st_tpu_torch.tools.convergence_gate) in its
   --fast mode under --fp16 on the card: the learnable corpus, 12 epochs
   of JAX's s2st vertical through the train CLI, validated with
   --eval-inference every 4; its gates must pass (one ``convergence``
   line), and the first kernel call of each distinct shape of its
   training and validation (bf16, D=16) is held against the plain
   version.
19. Stages 1-7 from raw audio at recipe width: 32 seeded WAV pairs
   (sources 2-12 s, targets 1.5-10 s, 16 kHz, two speakers; 24 train, 4
   dev, 4 tst; target texts in Chinese characters, since the recipe's
   stage 2 drops a target row with Latin letters) through
   recipes/run_baseline_torch.sh --stage 1 --stop-stage 2 and then
   --stage 3 (the chars g2p fallback: no phonemizer is installed; the
   features computed on the card), which must write every output with
   finite 80-d features of the frame counts its TSVs state; utterance
   pairs and seconds of audio a second of extraction; in this process
   each utterance's fbank and log-mel under torch.profiler (device ms an
   utterance, idle share) and four of them, as this process and stage 3
   stored them, against the CPU (atol 1e-5, float64 both); stage 3 with
   --src-sample-rate 8000 on 4 pairs; 2 updates of the recipe's model at
   full width with stage 5's flags and --fp16 on those features (no
   kernel launch: the recipe's attention dropout); stage 7's line on the
   tst split (--max-iter 100, no stop) with bf16 caches, with
   --kv-cache-dtype int8 (ms a decode step beside bf16's) and with
   --vocoder hifigan at jik876/hifi-gan's config_v1.json width from a
   seeded fairseq-layout generator: 12 kernel launches a batch each, every
   distinct call held against the plain version, WAVs of the expected
   length; both vocoders' device ms on one served batch.

20. The search options, fairseq .pt serving and asynchronous saves at
   the recipe's width, bf16, seeded weights: (a) stages 10-11 on 16 of
   phase 14's utterances (one batch) through generate_for_s2st with beam
   search, --sampling --sampling-topk 10, --diverse-beam-groups 5,
   --diversity-rate 0.5, --prefix-size 1 (stage 10), --constraints
   ordered and unordered from a file the port's constraints_tools
   extract wrote (C- lines), and the ensemble of two checkpoints: 12
   attention launches a batch a model (24 for the ensemble), each
   distinct call held against the plain version; (b) the first
   checkpoint saved in fairseq's layout (.pt, the model from the
   command line's flags): generate_for_s2st prints the .npz run's lines
   and generate_waveform (30 steps) its features, equal; (c) LightConv
   text generate on phase 10's corpus with --sampling, --diverse-beam-
   groups 5 and a 2-checkpoint ensemble, and DynamicConv with top-p
   sampling: 7 conv launches a batch a model, each distinct conv call
   held against the plain version; (d) phase 13's training run with
   --warmup-updates 1 --stop-min-lr 8e-4 (deterministic algorithms), with
   synchronous saves and with --save-async: both stop after epoch 2 at
   update 4 (e), their files (epoch, last and EMA) equal bit for bit;
   each save's stall of the loop and its write, peak memory and ms an
   update, side by side; both kernels >= 27 launches a microbatch.
21. The paper's training recipes at their widths (512-d, 12 + 6 layers,
   4 heads, --max-tokens 40000), --fp16 with --use-flash-attention
   --attention-dropout 0, 3 updates each, each line's flags recorded from
   recipes/run_pretraining_torch.sh and run_mix_tuning_torch.sh (a
   ``python`` on their PATH that writes its arguments) and run through
   the train CLI in this process: (a) pretraining stage 1 (l1/mse/eos/attn
   weights 0, CTC and aux CE 1.0, taps 6,8) on phase 6's corpus; (b)
   stage 2 warm-started from (a)'s checkpoint_last.npz, whose encoder
   arrays the model must hold bit for bit right after the warm start; (c)
   mix-tuning stage 1 (--arch s2t_transformer_hubert --criterion s2t_loss
   --test-type st) on phase 16's corpus from a seeded hubert-base .pt,
   the frontend bit-unchanged with zero Adam moments; (d) mix-tuning stage
   2 over train_fisher (10 utterances) and train_mls (6) with
   sampling_alpha 0.5, warm-started from (c), without --speaker-to-id and
   with --asr-ce-weight 0 --st-ce-weight 0 (JAX's line as written raises:
   the S2T encoder lacks the aux norms and speaker table): each epoch's
   rows must be the draw numpy computes here. Each update must launch
   exactly the attention kernels the model holds (forward: 47 in (a) and
   (b), 36 in (c), 35 in (d), the frontend's 12 included; backward: 47,
   24, 23); the first forward and backward kernel call of each distinct
   shape is held against the plain version (each backward check must
   also refuse two wrong answers); prints the second update's
   ms, the third's device ms and idle share (torch.profiler) and peak
   memory.
22. The train CLI's left-outs at the recipe's width (--fp16, seeded
   weights, --use-flash-attention --attention-dropout 0): (a) host
   overlap on 128 utterances of phase 13's lengths (2 recipe-size
   batches an epoch), deterministic algorithms on: 8 updates with
   --num-workers 1 and with 4 (the collate pool, the collate thread and
   the device prefetch on a side stream) must give the same losses and
   grad norms bit for bit, and a run stopped at update 3 (1 batch into
   epoch 2), saved and resumed under --num-workers 4 must take the
   uninterrupted run's updates bit for bit (the save counts 1 consumed
   batch); prints ms an update, the loop's wait for its batches, each
   collate's host ms and the sixth update's device ms and idle share
   (torch.profiler) for each; (b) each of the 9 optimizers for 3 updates
   under fixed, step, triangular, pass_through, manual (--update2lr) or
   reduce_lr_on_plateau: finite losses and each update's rate the
   schedule's formula's; adafactor and lamb held card vs CPU on one fp32
   update of phase 7's model (see optimizer_agreement); (c) --log-format
   json, --tensorboard-logdir, --profile and --heartbeat-timeout 600 on 3
   updates: JAX's json lines, TensorBoard events or JAX's warning where it
   is absent, and the profiler's trace holding the attention kernels'
   launches by symbol, equal to the port's counters; (d) every distinct
   attention call of (a)-(c), forward and backward, held against the plain
   version; (e) synthesize_streaming on phase 19's HiFi-GAN width against
   the whole sequence (fp32, away from the ends) with both device ms; (f)
   recipes/valide_during_train_torch.sh on (a)'s epoch checkpoints: the
   average (their numpy mean) and generate_waveform on the card (12
   launches a batch, each call held), PCM16 WAVs.
23. The other archs of the s2s_translation task at full width, --fp16,
   seeded weights, --use-flash-attention --attention-dropout 0, 3 updates
   each through the train CLI in this process, every update launching
   exactly the attention calls its model holds (forward, backward: 17, 17
   in (a); 27, 27 in (b); 36, 24 in (c), the trunk's 12 forward
   included; 18, 18 and 24, 24 in (d)), each distinct call held against
   the plain version: (a) t2s_transformer at JAX's defaults (512-d, 3
   conv layers of kernel 5, 6 + 6 layers, 4 heads, prenet 2 x 256,
   postnet 5 x 512, 80-d frames) over phase 6's corpus's phone lines, then
   generate_waveform from its checkpoint on the tst split's text with a
   64-iteration Griffin-Lim (6 launches a batch); (b) --task
   s2s_translation_mtl --arch s2st_transformer_mtl with stage 5's flags
   and --ctc-weight 0.3 --ctc-weight-tgt 0.3, its target CTC term above 0,
   then stage 7's line on its checkpoint (12 a batch); (c) xm_transformer
   --test-type st on phase 16's 16 WAVs behind a seeded hubert-base .pt,
   the trunk bit-unchanged with zero Adam moments; (d) convtransformer and
   convtransformer_espnet --test-type st. Prints each run's losses, ms an
   update, the third update's device ms and idle share, and peak memory.
24. The task's last arch families at full width, --fp16, seeded weights,
   3 updates each through the train CLI in this process, as 23: first the
   packed biLSTM layer at Berard's first layer on phase 6's batch (B=8,
   250 steps, 512 in, 256 a direction) on the card in fp32 and bf16
   against the CPU's fp32 (atol 1e-4 and 5e-2) with its device ms; (a)
   s2t_berard at JAX's defaults --test-type st on phase 6's corpus (no
   attention kernel); (b) tacotron_2 at its defaults with guided attention
   over phase 6's phone lines and target mels (no attention kernel), then
   generate_features of its checkpoint (fp32, 40 steps) against its own
   teacher-forced first step (atol 1e-5); (c) fastspeech2 at its defaults
   on the same lines with seeded duration, pitch and energy columns: 8
   forward and 8 backward attention launches an update (D=128), each
   distinct call held; then generate_waveform from its checkpoint on the
   tst split's text (--duration-factor 1.0 --min-duration 1): 8 launches
   a batch, each call held, finite 80-d features of at least a frame a
   token, PCM16 WAVs of their length.
25. Self-supervised speech training at hubert-base / wav2vec2-base width
   (7 convs of 512, 12 post-LN layers of 768-d, 12 heads, FFN 3072,
   pos_conv 128/16), --fp16 (the trunk computes in fp32 past its
   GroupNorm: the kernels take fp32 at D=64), seeded weights, 3 updates
   each through the train CLI in this process, on phase 16's 16 WAVs as
   a wav2vec manifest in batches of 8, every distinct forward and
   backward kernel call held against the plain version (fp32 backward
   also by direction against the float64 plain version where fp32
   resolves the gradient): (a) hubert_pretraining on seeded 500-unit
   labels at 50 Hz: 12 forward and 12 backward launches an update; (b)
   audio_finetuning --arch hubert_ctc from (a)'s checkpoint_last.npz with
   --freeze-finetune-updates 1, seeded letters, validated once: 12
   forward an update, 0 backward in the first and 12 in the second and
   third, the trunk equal to (a)'s bit for bit after the first and the
   extractor after all three, the validation's c_errors, c_total,
   w_errors and w_total finite; (c) audio_pretraining --arch wav2vec2
   --quantize-targets --attention-dropout 0 (320 x 2 codes, 100
   negatives): 12 and 12 an update, the logged temperature max(2 *
   0.999995^n, 0.5), stats::num_updates 3 in its checkpoint. Prints each
   run's losses, the second update's ms, the third's device ms, device
   activities and idle share, peak memory and the kernels' dtype.

Prints the card's name and power limit, one JSON line of kernel
measurements, and, last, {"ok": true, "device": {...}}.

    python3 chip_smoke.py --convergence

runs no phase but the full end-to-end gate on the card, in fp32 and under
--fp16, prints one ``convergence`` JSON line each (with the card's name
and power limit) and merges both into
chiprun_out/CONVERGENCE_TORCH.card.json; exits 1 if either fails.

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
import logging
import math
import os
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
    valid = np.ones((b, tk), bool) if kpm is None else ~kpm.cpu().numpy()
    mask_bytes = 0 if kpm is None else kpm.numel()
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
            + mask_bytes + 2 * 4 * b * h * tq
    else:
        nbytes = 2 * q.numel() * size + kv_bytes + mask_bytes
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


def _profiled(fn, host_events: bool = True):
    """(result, wall ms, device kernel ms, device activities, every device
    activity as (name, ms, count), largest first) of one call under
    torch.profiler; the device idles for wall - kernel ms. Without
    ``host_events`` only the device is traced (a smaller trace for calls
    of tens of thousands of launches)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU] * host_events
                 + [ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the trace's device records summed by name, read from kineto's
    # results: key_averages() first builds the profiler's Python event
    # tree, which took most of the wall of the updates of 100,000 and more
    # launches (phase 24's Tacotron2)
    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                not e.is_user_annotation():
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    top = sorted(((name, us / 1e3, n) for name, (us, n) in by_name.items()),
                 key=lambda rec: rec[1], reverse=True)
    busy = sum(ms for _, ms, _ in top)
    launches = sum(n for _, _, n in top)
    return out, wall, busy, launches, top


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
        # a warm-up pass outside the profiler (its trace of the decode's
        # ~46,000 launches costs tens of seconds to read), then the
        # reported one under it
        dec = decode_loop(model, gen_cfg, model.encode(src, lens),
                          generator=g)
        out = postprocess(model, *dec[:2], dec[3])
        vocoder(out["feats"], out["raw_out_lens"], g)
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


def run_train_cli(argv, save: Path, card: str, label: str,
                  s2t: bool = False, frames_per_step: int = 4) -> dict:
    """One run of the port's train CLI with every kernel count set to 0
    just before it; returns the counts, the per-update log, the
    validations' records and peak memory. An ``s2t`` run's targets are
    text tokens, another's spectrogram frames, ``frames_per_step`` a
    decoder step."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.kernels import attention as ka
    save.mkdir(parents=True, exist_ok=True)
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
    # packed steps * their frames, or the text model's target tokens
    frames, unit = (log[-1]["ntokens"], "tokens") if s2t else \
        (log[-1]["ntokens"] * frames_per_step, "frames")
    out = {"updates": len(log), "fwd_launches": fwd, "bwd_launches": bwd,
           "wall_s": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "first_step_ms": log[0]["step_ms"],
           "step_ms": sum(steady) / len(steady),
           "losses": [r["loss"] for r in log],
           "gnorms": [r["gnorm"] for r in log], "valid": valid}
    out[f"target_{unit}_per_s"] = frames / (out["step_ms"] / 1e3)
    print(f"train ({label}): {out['updates']} updates in {wall:.1f} s; "
          f"{out['step_ms']:.3f} ms/update after the first "
          f"({out['first_step_ms']:.1f} ms), "
          f"{out[f'target_{unit}_per_s']:.0f} target {unit}/s ({frames} a "
          f"batch), peak memory "
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
    """Times each checkpoint save of the train CLI: the stall of its loop
    (from the snapshot of the state, ``StateSnapshot``, the device
    synchronised before it, to the return of ``CheckpointManager.save``)
    and the write (from the host copy of the state, ``StateSnapshot.flat``,
    to the last name's link, in the writer's thread when saves are
    asynchronous), with the file's size. ``records`` pairs them, in order,
    once the run has waited for its writes."""

    def __enter__(self):
        from s2st_tpu_torch.train import checkpoint as ck
        self.ck, self.stalls, self.writes = ck, [], []
        self.init, self.save = ck.StateSnapshot.__init__, \
            ck.CheckpointManager.save
        self.flat, self.files = ck.StateSnapshot.flat, ck.save_checkpoint_files
        snapped, starts = [], []

        def init(snap, *args, **kw):
            torch.cuda.synchronize()
            snapped.append(time.perf_counter())
            self.init(snap, *args, **kw)

        def save(mgr, *args, **kw):
            paths = self.save(mgr, *args, **kw)
            self.stalls.append({
                "stall_ms": (time.perf_counter() - snapped.pop()) * 1e3,
                "names": [Path(p).name for p in paths]})
            return paths

        def flat(snap):
            starts.append(time.perf_counter())
            return self.flat(snap)

        def files(paths, arrays, meta):
            self.files(paths, arrays, meta)
            self.writes.append({
                "write_ms": (time.perf_counter() - starts.pop(0)) * 1e3,
                "mb": Path(paths[0]).stat().st_size / 1e6})
        ck.StateSnapshot.__init__, ck.CheckpointManager.save = init, save
        ck.StateSnapshot.flat, ck.save_checkpoint_files = flat, files
        return self

    @property
    def records(self) -> list:
        return [dict(s, **w) for s, w in zip(self.stalls, self.writes)]

    def __exit__(self, *exc):
        self.ck.StateSnapshot.__init__ = self.init
        self.ck.CheckpointManager.save = self.save
        self.ck.StateSnapshot.flat = self.flat
        self.ck.save_checkpoint_files = self.files


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
    recipe's batches (RECIPE_BATCH_FRAMES), 2 epochs each without saves;
    the mean over epoch 2, where each batch shape has run once.
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
                                 "--max-epoch", "2", "--no-save",
                                 small=False))
        log = [json.loads(line) for line in
               (save / "log.jsonl").read_text().splitlines()]
        want = 2 * len(sizes) // uf
        if len(log) != want or not all(np.isfinite(r["loss"]) for r in log):
            raise AssertionError(f"update-freq {uf}: {len(log)} updates in "
                                 f"2 epochs; want {want}, finite losses")
        steady = [r["step_ms"] for r in log if r["epoch"] > 1]
        out[uf] = {"ms": sum(steady) / len(steady), "min_ms": min(steady),
                   "max_ms": max(steady), "first_ms": log[0]["step_ms"],
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"train runtime: ms/update in the recipe's batches ({sizes} "
          f"utterances, --max-tokens 60000), mean of epoch 2: "
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
        print(f"train runtime: checkpoint saves (device-to-host copy, "
              f"write, links; synchronous): "
              + ", ".join(f"{r['stall_ms']:.1f} ms for {r['mb']:.1f} MB "
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
TEXT_PAIRS, TEXT_BATCH = 64, 64
TEXT_GEN_FLAGS = ["--batch-size", str(TEXT_BATCH), "--beam", "5",
                  "--max-len-a", "1.2", "--max-len-b", "10", "--remove-bpe",
                  "--fp16"]


def write_text_corpus(root: Path, seed: int) -> None:
    """A binarized de-en test split written with the port's builder: 64
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


def run_text_cli(data: Path, ckpt, out: Path, score_reference: bool,
                 card: str, label: str, extra: tuple = ()) -> dict:
    """One run of the port's text generate CLI (``ckpt`` a path, or a:b
    for an ensemble; ``extra`` flags after the recipe's) with both conv
    kernels' counts set to 0 just before it; returns the counts, the
    batches and the run's timing, after checking its lines."""
    from s2st_tpu_torch.cli import generate
    from s2st_tpu_torch.kernels import conv as kc
    argv = [str(data), "--source-lang", "de", "--target-lang", "en",
            "--gen-subset", "test", "--path", str(ckpt), *TEXT_GEN_FLAGS,
            "--results-path", str(out), "--device", "cuda", *extra]
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
           "timing": timing, "wall_s": wall, "bleu": bleu, "lines": lines}
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
        beam(model.encode(src))     # warm-up, outside the profiler
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

# Phase 14's corpus: 32 utterances of 400-1000 source frames, one batch
# under --max-tokens 50000 (the first 16 are phase 20's)
S2T_FRAMES = tuple(int(n) for n in
                   np.random.RandomState(12).randint(400, 1001, 32))
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
             if re.match(r"^[STHDPC]-|^Generate ", ln)]
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
    the port's generate_for_s2st, on 32 utterances, from a seeded random
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
            # a warm-up outside the profiler, then the reported pass
            enc = bf.encode(batch["src_speech"], batch["src_speech_lens"])
            beam_search_aux(bf.aux_st_decoder, enc["out_middle_layers"][1],
                            enc["encoder_padding_mask"], bs_cfg)
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
        # 300-step validation decodes (a cut of the script's depth; the
        # recipe's 2400 positions decode 600)
        argv += ["--use-flash-attention", "--attention-dropout", "0",
                 "--max-epoch", "2", "--max-target-positions", "1200"]
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
                 "--save-interval", "3", "--validate-interval", "3",
                 "--max-target-positions", "1200"]   # a 300-step decode
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
            decode_loop(model, gen_cfg, enc, generator=g)   # warm-up
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


# stage 8's ASR: wav2vec2-large-960h-lv60-self's width and files
# (transformers' Wav2Vec2Config of the hub model), with random weights
W2V2_LARGE_CONFIG = {
    "architectures": ["Wav2Vec2ForCTC"], "model_type": "wav2vec2",
    "conv_dim": [512] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
    "conv_stride": [5, 2, 2, 2, 2, 2, 2], "conv_bias": True,
    "feat_extract_norm": "layer", "feat_extract_activation": "gelu",
    "do_stable_layer_norm": True, "hidden_size": 1024,
    "num_hidden_layers": 24, "num_attention_heads": 16,
    "intermediate_size": 4096, "hidden_act": "gelu", "layer_norm_eps": 1e-5,
    "num_conv_pos_embeddings": 128, "num_conv_pos_embedding_groups": 16,
    "vocab_size": 32, "pad_token_id": 0, "bos_token_id": 1,
    "eos_token_id": 2, "mask_time_prob": 0.05, "mask_feature_prob": 0.0,
    "add_adapter": False}
W2V2_VOCAB = ("<pad> <s> </s> <unk> | E T A O N I H S R D L U M W C F G Y "
              "P B V K ' X J Q Z").split()
ASR_LAYERS, ASR_HEADS, ASR_HEAD_DIM = 24, 16, 64
# 12 seeded utterances of 2-15 s beside the 4 of stage 7 (9.58 s each)
ASR_SECONDS = tuple(float(x) for x in
                    np.random.RandomState(17).uniform(2.0, 15.0, 12))
# the card vs the CPU on a small wav2vec2: fp32 through 2 layers
TOL_ASR_AGREEMENT = 1e-4


def random_wav2vec2_state(cfg, seed: int) -> dict:
    """A seeded random state_dict (the port's names, fp32) of a wav2vec2 of
    config ``cfg``: weights normal over sqrt(fan_in), norms' scales near 1,
    biases near 0."""
    from s2st_tpu_torch.models.wav2vec2_ctc import Wav2Vec2ForCTC
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in
                  Wav2Vec2ForCTC(cfg).state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        noise = torch.randn(shape, generator=g)
        if name.endswith("masked_spec_embed"):
            sd[name] = torch.rand(shape, generator=g)
        elif name.endswith("bias"):
            sd[name] = 0.02 * noise
        elif "layer_norm" in name:
            sd[name] = 1.0 + 0.05 * noise
        else:
            sd[name] = noise * math.prod(shape[1:]) ** -0.5
    return sd


def write_wav2vec2_checkpoint(root: Path, config: dict, seed: int) -> None:
    """An HF model directory as the hub holds wav2vec2-large-960h-lv60-self:
    config.json, the processor's and tokenizer's files (lv60-self's
    vocabulary and settings) and pytorch_model.bin (torch.save) with
    pos_conv as weight_g/weight_v, of seeded random weights."""
    from s2st_tpu_torch.models.wav2vec2_ctc import Wav2Vec2CTCConfig, hf_key
    root.mkdir(parents=True)
    files = {
        "config.json": config,
        "preprocessor_config.json": {
            "do_normalize": True,
            "feature_extractor_type": "Wav2Vec2FeatureExtractor",
            "feature_size": 1, "padding_side": "right",
            "padding_value": 0.0, "return_attention_mask": True,
            "sampling_rate": 16000},
        "tokenizer_config.json": {
            "unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
            "pad_token": "<pad>", "do_lower_case": False,
            "word_delimiter_token": "|"},
        "special_tokens_map.json": {
            "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
            "pad_token": "<pad>"},
        "vocab.json": {t: i for i, t in enumerate(W2V2_VOCAB)}}
    for name, obj in files.items():
        (root / name).write_text(json.dumps(obj, indent=2))
    sd = random_wav2vec2_state(Wav2Vec2CTCConfig.from_hf(config), seed)
    pos = "wav2vec2.encoder.pos_conv_embed.conv."
    v = sd.pop(pos + "weight")
    sd[pos + "weight_g"] = v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd[pos + "weight_v"] = v
    torch.save({hf_key(k): t for k, t in sd.items()},
               str(root / "pytorch_model.bin"))


def asr_kernel_case(ka, t: int, card: str) -> dict:
    """The kernel at stage 8's shape: one utterance (B=1) of T' frames,
    H=16, D=64, fp32, no key padding (the transcriber passes no mask),
    against the plain version, timed by graph replay beside SDPA (a
    yardstick only) and the bound."""
    q, k, v, _ = attention_inputs(1, t, t, [t], torch.float32, seed=t,
                                  d=ASR_HEAD_DIM, h=ASR_HEADS)
    out = ka.flash_attention(q, k, v, None)
    ref = ka.flash_attention_reference(q, k, v, None)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    atol, rtol = TOL_FP32
    ok = bool(torch.isfinite(out).all()) and \
        bool((err <= atol + rtol * ref.abs()).all())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rec = {"case": "asr_stage8_D64_fp32", "dtype": "float32", "B": 1,
           "Tq": t, "Tk": t, "H": ASR_HEADS, "D": ASR_HEAD_DIM,
           "causal": False, "max_abs_err": float(err.max()),
           "tolerance": f"atol {atol} + rtol {rtol}",
           "kernel_graph_ms": graph_ms(
               lambda: ka.flash_attention(q, k, v, None)),
           "plain_graph_ms": graph_ms(
               lambda: ka.flash_attention_reference(q, k, v, None)),
           "library_graph_ms": graph_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, scale=1.0))}
    rec["bound_ms"], rec["bound_by"] = attention_bound_ms(q, k, None, False)
    rec["card"] = card
    print("kernel_case " + json.dumps(rec), flush=True)
    print("shape " + json.dumps({
        "name": rec["case"], "design": ka.DESIGNS["float32"], "B": 1,
        "T": t, "H": ASR_HEADS, "D": ASR_HEAD_DIM,
        "ms": rec["kernel_graph_ms"], "plain_ms": rec["plain_graph_ms"],
        "library_ms": rec["library_graph_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "max_abs_err": rec["max_abs_err"],
        "card": card}), flush=True)
    if not ok:
        raise AssertionError(f"asr kernel case T'={t}: disagrees with the "
                             f"plain version, max abs err "
                             f"{rec['max_abs_err']}")
    return rec


def asr_agreement_phase(card: str) -> None:
    """17(b): a small wav2vec2 of head_dim 64 (3 convs of 32 channels, 2
    layers of 128-d with 2 heads), one of each layout, on the card (the
    kernel inside) against the CPU (the plain attention), fp32, on 1.2 s:
    logits within TOL_ASR_AGREEMENT and equal argmax ids."""
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.models.wav2vec2_ctc import (Wav2Vec2CTCConfig,
                                                    Wav2Vec2ForCTC)
    wave = torch.from_numpy(np.random.RandomState(6).randn(
        1, 19200).astype(np.float32))
    for layout in ("group", "layer"):
        cfg = Wav2Vec2CTCConfig(
            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2),
            conv_stride=(5, 2, 2), conv_bias=layout == "layer",
            feat_extract_norm=layout, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256,
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            do_stable_layer_norm=layout == "layer")
        model = Wav2Vec2ForCTC(cfg)
        model.load_state_dict(random_wav2vec2_state(cfg, seed=7),
                              strict=True)
        with torch.inference_mode():
            cpu = model.eval()(wave)
            model.to("cuda")
            ka.flash_attention.launches = 0
            gpu = model(wave.cuda())
            torch.cuda.synchronize()
        launched = ka.flash_attention.launches
        err = float((gpu.cpu() - cpu).abs().max())
        same_ids = torch.equal(gpu.argmax(-1).cpu(), cpu.argmax(-1))
        print(f"asr agreement ({layout}): card vs CPU wav2vec2 logits (fp32, "
              f"head_dim 64, {cpu.shape[1]} frames) max abs err {err:.3e}, "
              f"tolerance {TOL_ASR_AGREEMENT}; argmax ids equal {same_ids}; "
              f"kernel launches {launched} ({card})", flush=True)
        if not (err <= TOL_ASR_AGREEMENT and same_ids and launched == 2):
            raise AssertionError(f"asr agreement ({layout}): err {err}, ids "
                                 f"equal {same_ids}, {launched} launches")


def counted_module(out: Path, args: list) -> int:
    """``python -m MODULE ARGS`` in this process, with every kernel count
    set to 0 just before and read just after, and each distinct attention
    kernel call held against the plain version; appends one JSON record to
    ``out`` and returns the module's exit code. Phase 17's recipe run
    reaches it through a ``python`` on its PATH."""
    import runpy
    sys.path.insert(0, str(REPO))
    from s2st_tpu_torch.kernels import attention as ka
    if args[:1] != ["-m"] or len(args) < 2:
        raise SystemExit(f"--counted takes -m MODULE [ARGS], got {args}")
    module, rest = args[1], args[2:]
    ka.flash_attention.launches = ka.flash_attention.bwd_launches = 0
    code = 0
    with RecordAttention() as rec:
        sys.argv = [module, *rest]
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else int(
                e.code is not None)
        torch.cuda.synchronize()
        launches = ka.flash_attention.launches
        bwd = ka.flash_attention.bwd_launches
    err = hold_path_attention(rec.calls, module, gpu_identity()) \
        if rec.calls else None
    with open(out, "a") as f:
        f.write(json.dumps({
            "module": module, "rc": code, "launches": launches,
            "bwd_launches": bwd, "distinct_calls": len(rec.calls),
            "path_max_abs_err": err}) + "\n")
    return code


def write_asr_inputs(root: Path, stage7_wavs: list, seed: int) -> dict:
    """The recipe's stage-8/9 inputs: ``<root>/save/dump_wav_tst/wav`` with
    stage 7's WAVs and 12 seeded ones of ASR_SECONDS (PCM16, 16 kHz, noise),
    ``<root>/manifests/tst.audio_phone.tsv`` (id, tgt_text) in an order
    that is not the files', and 4 seeded reference files under
    ``<root>/refs``. Returns the paths and the manifest's ids."""
    from s2st_tpu_torch.data.audio_utils import write_wav
    r = np.random.RandomState(seed)
    wav_dir = root / "save" / "dump_wav_tst" / "wav"
    wav_dir.mkdir(parents=True)
    ids = []
    for path in stage7_wavs:
        shutil.copy(path, wav_dir / path.name)
        ids.append(path.name[:-len("_pred.wav")])
    for j, sec in enumerate(ASR_SECONDS):
        n = int(round(sec * 16000))
        write_wav(str(wav_dir / f"asr{j}_pred.wav"),
                  np.clip(r.randn(n) * 0.1, -1.0, 1.0), 16000)
        ids.insert(2 * j % (len(ids) + 1), f"asr{j}")
    words = ["the", "a", "house", "is", "green", "we", "go", "to", "it's",
             "there", "Hello", "world", "yes", "no", "maybe", "today"]

    def sentence():
        return " ".join(r.choice(words, size=r.randint(3, 12)))

    (root / "manifests").mkdir()
    (root / "manifests" / "tst.audio_phone.tsv").write_text(
        "id\ttgt_text\n" + "".join(f"{u}\t{sentence()}\n" for u in ids))
    (root / "refs").mkdir()
    for k in range(4):
        (root / "refs" / f"en.{k}.norm.lc.rm").write_text(
            "".join(sentence().lower() + "\n" for _ in ids))
    return {"ids": ids, "wav_dir": wav_dir, "refs": root / "refs",
            "dump": root / "save" / "dump_wav_tst"}


def run_asr_recipe(work: Path, model_dir: Path, inputs: dict) -> tuple:
    """recipes/run_baseline_torch.sh --stage 8 --stop-stage 9 on
    ``write_asr_inputs``' files, each ``python`` of it through
    ``counted_module`` (a ``python`` on its PATH). Checks that stages 8 and
    9 print one finite BLEU line each and that decode.txt has a line a
    manifest row in the manifest's order. Returns (the two score lines,
    stage 8's and stage 9's count records)."""
    shim = work / "bin"
    shim.mkdir()
    counts = work / "counts.jsonl"
    (shim / "python").write_text(
        f'#!/bin/sh\nexec "{sys.executable}" "{REPO / "chip_smoke.py"}" '
        f'--counted "{counts}" "$@"\n')
    (shim / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{shim}:{os.environ['PATH']}",
               PYTHONPATH=str(REPO),
               AUDIO_MANIFEST_ROOT=str(work / "manifests"),
               FEATURE_MANIFEST_ROOT=str(work / "features"),
               SAVE_DIR=str(work / "save"))
    res = subprocess.run(
        ["bash", str(REPO / "recipes" / "run_baseline_torch.sh"),
         "--stage", "8", "--stop-stage", "9",
         "--asr-model-path", str(model_dir),
         "--multi-ref-dir", str(inputs["refs"])],
        env=env, capture_output=True, text=True, timeout=900)
    for line in res.stdout.splitlines():
        if line.startswith(("BLEU", "path_case", "s2st_tpu_torch.cli")) \
                or "scored" in line:
            print(f"asr recipe: {line}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"run_baseline_torch.sh stages 8-9 returned "
                             f"{res.returncode}:\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    scores = [line for line in res.stdout.splitlines()
              if line.startswith("BLEU = ")]
    if len(scores) != 2 or not all(
            math.isfinite(float(s.split()[2])) for s in scores):
        raise AssertionError(f"stages 8-9: score lines {scores}")
    decoded = (inputs["dump"] / "decode.txt").read_text().splitlines()
    if [line.split("\t")[2] for line in decoded] != inputs["ids"]:
        raise AssertionError("stage 8: decode.txt is not one line a "
                             "manifest row in the manifest's order")
    stage8, stage9 = [json.loads(line) for line in
                      counts.read_text().splitlines()]
    return scores, stage8, stage9


def asr_phase(card: str, stage7_wavs: list) -> dict:
    """17: stages 8-9 through recipes/run_baseline_torch.sh on the card at
    the recipe ASR's full width (a seeded wav2vec2-large-lv60 checkpoint
    in the hub's layout), over the 4 WAVs stage 7 dumped in phase 2 and 12
    seeded ones; the kernel launches 24 times an utterance, each distinct
    call held against the plain version; then the kernel at the longest
    utterance's shape, the card against the CPU on small models, and the
    transcriber's ms an utterance, audio seconds a second, idle share and
    peak memory."""
    from s2st_tpu_torch.data.audio_utils import read_wav
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.models.wav2vec2_ctc import Transcriber
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_asr_"))
    try:
        t0 = time.perf_counter()
        model_dir = work / "wav2vec2-large-960h-lv60-self"
        write_wav2vec2_checkpoint(model_dir, W2V2_LARGE_CONFIG, seed=21)
        size = (model_dir / "pytorch_model.bin").stat().st_size
        print(f"asr: wrote a seeded wav2vec2-large-lv60 checkpoint, "
              f"{size / 1e9:.2f} GB, in {time.perf_counter() - t0:.1f} s",
              flush=True)
        inputs = write_asr_inputs(work, stage7_wavs, seed=22)
        ids = inputs["ids"]
        t0 = time.perf_counter()
        scores, stage8, stage9 = run_asr_recipe(work, model_dir, inputs)
        recipe_s = time.perf_counter() - t0
        want = ASR_LAYERS * len(ids)
        if stage8["rc"] or stage8["launches"] != want or \
                stage8["bwd_launches"] or stage9["launches"]:
            raise AssertionError(f"stage 8 launched the kernel "
                                 f"{stage8['launches']} times for {len(ids)} "
                                 f"utterances (want {want}); stage 9 "
                                 f"{stage9['launches']}")
        print(f"asr recipe: stages 8-9 in {recipe_s:.1f} s; stage 8 "
              f"{scores[0]}; stage 9 ({len(list(inputs['refs'].iterdir()))} "
              f"references) {scores[1]}; kernel launches {stage8['launches']}"
              f" for {len(ids)} utterances, {stage8['distinct_calls']} "
              f"distinct calls held, max abs err "
              f"{stage8['path_max_abs_err']:.3e} ({card})", flush=True)

        # the transcriber in this process: ms an utterance, device ms by
        # graph replay, idle share, peak memory
        waves = [read_wav(str(inputs["wav_dir"] / f"{u}_pred.wav"))
                 for u in ids]
        audio_s = sum(len(w) / sr for w, sr in waves)
        # the transcriber's own peak, above what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tr = Transcriber(str(model_dir), torch.device("cuda"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        texts = [tr(w, sr) for w, sr in waves]          # warm-up
        walls = []
        ka.flash_attention.launches = 0
        for (w, sr), text in zip(waves, texts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if tr(w, sr) != text:
                raise AssertionError("asr: a second transcription differs")
            walls.append((time.perf_counter() - t0) * 1e3)
        if ka.flash_attention.launches != want:
            raise AssertionError(f"asr: {ka.flash_attention.launches} "
                                 f"launches in process, want {want}")
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        # the device ms of each utterance's forward by graph replay (no
        # host gap enters it; torch.profiler's sums can double events);
        # the profiler names the top kernels only
        device = []
        with torch.inference_mode():
            for w, sr in waves:
                x = torch.from_numpy(tr.processor.features(w, sr))[None]
                x = x.cuda()
                device.append(graph_ms(lambda: tr.model(x), iters=1,
                                       replays=3))
        _, _, _, _, top = _profiled(lambda: [tr(w, sr) for w, sr in waves])
        longest = max(range(len(waves)), key=lambda i: len(waves[i][0]))
        w, sr = waves[longest]
        t_long = tr.model.cfg.output_length(len(w))
        timing = {
            "utterances": len(waves), "audio_s": audio_s,
            "load_s": load_s, "wall_ms_per_utt": sum(walls) / len(walls),
            "device_ms_per_utt": sum(device) / len(device),
            "wall_ms_longest": walls[longest],
            "device_ms_longest": device[longest],
            "audio_s_per_s": audio_s / (sum(walls) / 1e3),
            "idle_share": 1 - sum(device) / sum(walls), "peak_gib": peak,
            "longest_frames": t_long}
        print("asr_timing " + json.dumps({**timing, "card": card}),
              flush=True)
        print(f"asr: {len(waves)} utterances ({audio_s:.1f} s of audio), "
              f"{timing['wall_ms_per_utt']:.2f} wall ms and "
              f"{timing['device_ms_per_utt']:.2f} device ms (graph replay) "
              f"an utterance, {timing['audio_s_per_s']:.1f} s of audio a "
              f"second, idle share {timing['idle_share']:.3f}; longest "
              f"({len(w) / sr:.2f} s, T'={t_long}) wall "
              f"{walls[longest]:.2f} ms, device {device[longest]:.2f} ms; "
              f"peak {peak:.2f} GiB; load {load_s:.1f} s ({card})",
              flush=True)
        for key, ms, count in top[:6]:
            print(f"profile asr:   {ms:9.3f} ms  {count:6d}x  {key[:60]}",
                  flush=True)
        if any(d > wl for d, wl in zip(device, walls)):
            raise AssertionError(f"asr: a forward's device ms inside a "
                                 f"shorter wall: {device} vs {walls}")
        del tr
        kernel = asr_kernel_case(ka, t_long, card)
        asr_agreement_phase(card)
        return {"launches": stage8["launches"],
                "path_max_abs_err": stage8["path_max_abs_err"],
                "kernel": kernel, "timing": timing}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def gate_phase(card: str) -> dict:
    """18: the end-to-end gate's --fast mode under --fp16 on the card
    (s2st_tpu_torch.tools.convergence_gate): it must pass, and each
    distinct attention kernel call of its training and validation is held
    against the plain version."""
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.tools import convergence_gate as cg
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        ka.flash_attention.launches = ka.flash_attention.bwd_launches = 0
        t0 = time.perf_counter()
        with RecordAttention() as rec:
            rc = cg.main(["--fast", "--fp16", "--device", "cuda", "--json",
                          str(Path(tmp) / "convergence.json"), "--outdir",
                          tmp])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = ka.flash_attention.launches, ka.flash_attention.bwd_launches
    if rc != 0 or fwd == 0:
        raise AssertionError(f"gate --fast --fp16: rc {rc} (the gates are on "
                             f"the convergence line above), {fwd} kernel "
                             f"launches")
    path_err = hold_path_attention(rec.calls, "gate_fast_bf16", card)
    print(f"gate --fast --fp16: passed in {wall:.1f} s; attention kernel "
          f"launches {fwd} forward, {bwd} backward ({card})", flush=True)
    return {"launches": fwd, "bwd_launches": bwd, "wall_s": wall,
            "path_max_abs_err": path_err}


# stage 1's inputs at recipe scale: sources of 2-12 s and targets of 1.5-10
# s at 16 kHz, two speakers; the recipe's stage 2 keeps a target row only
# without Latin letters (its g2p phonemizes the target side as Chinese),
# so the target texts are Chinese characters and digits
PREP_SPLITS = (("train", 24), ("dev", 4), ("tst", 4))
PREP_SRC_WORDS = ("hola", "como", "estas", "bien", "gracias", "mundo", "agua",
                  "casa", "verde", "vamos", "hoy", "si", "no", "tal", "vez")
PREP_TGT_CHARS = "我们你好世界今天天气很好花了元百分之的人电话是见面年月日"
PREP_MAX_ITER = 100
TOL_PREP_AGREEMENT = 1e-5    # the card's float64 DSP against the CPU's
HIFIGAN_V1 = {               # jik876/hifi-gan config_v1.json
    "resblock": "1", "num_gpus": 0, "batch_size": 16,
    "learning_rate": 0.0002, "adam_b1": 0.8, "adam_b2": 0.99,
    "lr_decay": 0.999, "seed": 1234, "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4], "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "segment_size": 8192, "num_mels": 80, "num_freq": 1025, "n_fft": 1024,
    "hop_size": 256, "win_size": 1024, "sampling_rate": 16000, "fmin": 0,
    "fmax": 8000, "fmax_for_loss": None}


def write_prep_inputs(root: Path, seed: int) -> dict:
    """32 seeded WAV pairs (PCM16, 16 kHz: noise over a few tones, a silent
    stretch in every fourth) and stage 1's metadata TSV a split. Returns
    the metadata specs, the WAV directory and the seconds of audio."""
    from s2st_tpu_torch.data.audio_utils import write_wav
    r = np.random.RandomState(seed)
    wavs = root / "wavs"
    wavs.mkdir(parents=True)
    specs, seconds, k = [], 0.0, 0
    for split, n in PREP_SPLITS:
        lines = ["id\tsrc_wav\ttgt_wav\tsrc_text\ttgt_text\tspeaker"]
        for i in range(n):
            uid = f"{split}{i:02d}"
            for side, lo, hi in (("src", 2.0, 12.0), ("tgt", 1.5, 10.0)):
                t = np.arange(int(r.uniform(lo, hi) * 16000)) / 16000
                x = 0.05 * r.randn(len(t))
                for f in r.uniform(100, 3000, 3):
                    x += 0.1 * np.sin(2 * np.pi * f * t)
                if k % 4 == 0:
                    x[len(x) // 3:len(x) // 2] = 0.0
                write_wav(str(wavs / f"{uid}_{side}.wav"),
                          np.clip(x, -1, 1), 16000)
                seconds += len(t) / 16000
            src = " ".join(r.choice(PREP_SRC_WORDS, r.randint(4, 15)))
            tgt = "".join(r.choice(list(PREP_TGT_CHARS), r.randint(4, 20)))
            lines.append(f"{uid}\t{uid}_src.wav\t{uid}_tgt.wav\t{src}\t"
                         f"{tgt}{r.randint(1, 100)}\tspk{k % 2}")
            k += 1
        (root / f"meta_{split}.tsv").write_text("\n".join(lines) + "\n")
        specs.append(f"{split}:{root / f'meta_{split}.tsv'}")
    return {"specs": specs, "wavs": wavs, "audio_s": seconds}


def run_prep_recipe(work: Path, inputs: dict) -> dict:
    """recipes/run_baseline_torch.sh --stage 1 --stop-stage 3 (stage 3 on
    the card: its lines name no device); returns the wall seconds and
    stage 3's in-process extraction seconds from its log."""
    env = dict(os.environ, PYTHONPATH=str(REPO),
               AUDIO_MANIFEST_ROOT=str(work / "manifests"),
               FEATURE_MANIFEST_ROOT=str(work / "features"),
               SAVE_DIR=str(work / "save"),
               METADATA_TSVS=" ".join(inputs["specs"]),
               AUDIO_DATA_ROOT=str(inputs["wavs"]),
               PATH=f"{Path(sys.executable).parent}:{os.environ['PATH']}")
    walls = {}
    for first, last in (("1", "2"), ("3", "3")):
        t0 = time.perf_counter()
        res = subprocess.run(
            ["bash", str(REPO / "recipes" / "run_baseline_torch.sh"),
             "--stage", first, "--stop-stage", last], env=env,
            capture_output=True, text=True, timeout=600)
        walls[f"stages_{first}_{last}_s"] = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"run_baseline_torch.sh stages {first}-"
                                 f"{last} returned {res.returncode}:\n"
                                 f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    found = re.findall(r"extracted (\d+) samples in ([0-9.]+) s", res.stdout)
    if not found:
        raise AssertionError(f"stage 3 printed no extraction time:\n"
                             f"{res.stdout[-2000:]}")
    walls["extracted"], walls["extract_s"] = int(found[-1][0]), \
        float(found[-1][1])
    return walls


def check_prep_outputs(work: Path, card: str) -> list:
    """Stage 3's outputs: the files, 64 rows of finite 80-d features whose
    frame counts the TSVs state, and two speakers; returns the rows."""
    from s2st_tpu_torch.data.audio_utils import get_features
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    feats = work / "features"
    for name in ("src_logmelspec80.zip", "tgt_logmelspec80.zip",
                 "src_gcmvn_stats.npz", "tgt_gcmvn_stats.npz", "train.tsv",
                 "dev.tsv", "tst.tsv", "src_vocab.txt", "tgt_vocab.txt",
                 "speakers.txt", "config.yaml"):
        if not (feats / name).is_file():
            raise AssertionError(f"stage 3 wrote no {name}")
    cfg = S2STDataConfig(feats / "config.yaml")
    if cfg.config.get("speaker_set_filename") != "speakers.txt" or \
            (feats / "speakers.txt").read_text().split() != ["spk0", "spk1"]:
        raise AssertionError("stage 3: not two speakers in config.yaml")
    rows = []
    for split, n in PREP_SPLITS:
        lines = (feats / f"{split}.tsv").read_text().splitlines()
        head = lines[0].split("\t")
        got = [dict(zip(head, line.split("\t"))) for line in lines[1:]]
        if len(got) != n:
            raise AssertionError(f"stage 3: {split}.tsv has {len(got)} rows")
        rows += got
    for row in rows:
        for side in ("src", "tgt"):
            x = get_features(row[f"{side}_audio"])
            if x.shape != (int(row[f"{side}_n_frames"]), 80) or \
                    not np.isfinite(x).all():
                raise AssertionError(f"{row['id']} {side}: features "
                                     f"{x.shape} not finite (T, 80)")
    print(f"data_prep: stages 1-3 wrote {len(rows)} rows of finite 80-d "
          f"fbank and log-mel features, GCMVN stats, vocabularies of "
          f"{len((feats / 'src_vocab.txt').read_text().splitlines())} and "
          f"{len((feats / 'tgt_vocab.txt').read_text().splitlines())} "
          f"symbols, two speakers ({card})", flush=True)
    return rows


def prep_features_on_card(inputs: dict, rows: list, card: str) -> dict:
    """In this process: each utterance's fbank and log-mel on the card
    under torch.profiler (device ms an utterance, idle share), and the
    first four held against the same functions on the CPU."""
    from s2st_tpu_torch.data import audio_utils as au
    waves = []
    for row in rows:
        src, sr = au.read_wav(str(inputs["wavs"] / f"{row['id']}_src.wav"))
        tgt, _ = au.read_wav(str(inputs["wavs"] / f"{row['id']}_tgt.wav"))
        waves.append((src * 2 ** 15, tgt))

    def fbank():
        return [au.kaldi_fbank(s, device="cuda") for s, _ in waves]

    def logmel():
        return [au.extract_logmel_spectrogram(t, 16000, f_min=20.0,
                                              device="cuda")
                for _, t in waves]
    fbank()
    logmel()                                     # warm cuFFT's plans
    out = {}
    for name, fn in (("fbank", fbank), ("logmel", logmel)):
        feats, wall, busy, launches, top = _profiled(fn)
        out[name] = {"wall_ms_per_utt": wall / len(waves),
                     "device_ms_per_utt": busy / len(waves),
                     "launches_per_utt": launches / len(waves),
                     "idle_share": 1 - busy / wall}
        err = 0.0
        for i in range(4):
            cpu = (au.kaldi_fbank(waves[i][0], device="cpu")
                   if name == "fbank" else au.extract_logmel_spectrogram(
                       waves[i][1], 16000, f_min=20.0, device="cpu"))
            err = max(err, float(np.abs(feats[i] - cpu).max()))
            side = "src" if name == "fbank" else "tgt"
            stored = au.get_features(rows[i][f"{side}_audio"])
            err = max(err, float(np.abs(stored - cpu).max()))
        out[name]["card_vs_cpu_max_abs_err"] = err
        print(f"data_prep {name}: {out[name]['device_ms_per_utt']:.3f} "
              f"device ms and {out[name]['wall_ms_per_utt']:.3f} wall ms an "
              f"utterance ({out[name]['launches_per_utt']:.0f} launches), "
              f"idle share {out[name]['idle_share']:.3f}; card (this "
              f"process's and stage 3's stored) vs CPU on 4 "
              f"utterances max abs err {err:.3e} (tolerance "
              f"{TOL_PREP_AGREEMENT}) ({card})", flush=True)
        for key, ms, count in top[:3]:
            print(f"profile data_prep {name}:   {ms:9.3f} ms  {count:6d}x  "
                  f"{key[:60]}", flush=True)
        if not err <= TOL_PREP_AGREEMENT:
            raise AssertionError(f"{name}: card and CPU disagree: {err}")
    return out


def prep_8k(work: Path, card: str) -> None:
    """Stage 3 with --src-sample-rate 8000 (the _8k variant) on 4 pairs,
    in this process."""
    from s2st_tpu_torch.cli import get_feature_manifest
    from s2st_tpu_torch.data.audio_utils import get_features
    man = work / "manifests_8k"
    man.mkdir()
    lines = (work / "manifests" / "train.audio_phone.tsv").read_text() \
        .splitlines()
    (man / "train.audio_phone.tsv").write_text("\n".join(lines[:5]) + "\n")
    out = work / "features_8k"
    if get_feature_manifest.main(["--audio-manifest-root", str(man),
                                  "--output-root", str(out), "--splits",
                                  "train", "--src-sample-rate", "8000",
                                  "--device", "cuda"]) != 0:
        raise AssertionError("stage 3 --src-sample-rate 8000 failed")
    rows = (out / "train.tsv").read_text().splitlines()[1:]
    for line in rows:
        path, n = line.split("\t")[1], int(line.split("\t")[3])
        x = get_features(path)
        if "src_logmelspec80_8k.zip" not in path or x.shape != (n, 80) or \
                not np.isfinite(x).all():
            raise AssertionError(f"_8k features {path} {x.shape}")
    if not (out / "src_gcmvn_stats_8k.npz").is_file():
        raise AssertionError("stage 3 --src-sample-rate 8000 wrote no "
                             "src_gcmvn_stats_8k.npz")
    print(f"data_prep: --src-sample-rate 8000 on {len(rows)} pairs wrote "
          f"src_logmelspec80_8k.zip and src_gcmvn_stats_8k.npz ({card})",
          flush=True)


def write_hifigan_v1(root: Path, seed: int) -> Path:
    """Writes a seeded HiFi-GAN generator at config_v1.json's width in
    fairseq's layout (weight_g / weight_v on every conv) and its config;
    returns the config.yaml ``vocoder:`` block that names them."""
    from s2st_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, v in HiFiGANGenerator(
            HiFiGANConfig.from_json(HIFIGAN_V1)).state_dict().items():
        if name.endswith(".weight"):
            sd[name[:-6] + "weight_v"] = torch.randn(v.shape, generator=gen)
            # row norms of 0.6-1.2 keep the output off both silence and
            # tanh's saturation at this width
            sd[name[:-6] + "weight_g"] = 0.6 + 0.6 * torch.rand(
                (v.shape[0],) + (1,) * (v.dim() - 1), generator=gen)
        else:
            sd[name] = torch.zeros(v.shape)
    torch.save({"generator": sd}, root / "g_hifigan_v1.pt")
    (root / "config_v1.json").write_text(json.dumps(HIFIGAN_V1))
    return (f"vocoder:\n  type: hifigan\n"
            f"  checkpoint: {(root / 'g_hifigan_v1.pt').as_posix()}\n"
            f"  config: {(root / 'config_v1.json').as_posix()}\n")


def prep_serve(work: Path, data: Path, ckpt: Path, card: str) -> dict:
    """Stage 7's line (--max-iter PREP_MAX_ITER --eos-prob-threshold 1.5,
    so every batch decodes that many steps) on the trained checkpoint:
    bf16 caches, int8 caches, then --vocoder hifigan; each with the kernel
    counts set to 0 before and read after, every distinct kernel call held
    against the plain version. Then both vocoders' device ms on one
    served batch's features."""
    from s2st_tpu_torch.cli import generate_waveform
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.generate.vocoder import get_vocoder
    from s2st_tpu_torch.kernels import attention as ka
    base = [str(data), "--config-yaml", "config.yaml", "--gen-subset", "tst",
            "--task", "s2s_translation", "--path", str(ckpt),
            "--max-tokens", "100000", "--spec-bwd-max-iter", "64",
            "--n-frames-per-step", "4", "--fp16", "--max-iter",
            str(PREP_MAX_ITER), "--eos-prob-threshold", "1.5",
            "--dump-waveforms", "--dump-features", "--device", "cuda"]
    if generate_waveform.main(base + ["--results-path",
                                      str(work / "warmup")]) != 0:
        raise AssertionError("generate_waveform (warm-up) failed")
    runs, worst = {}, 0.0
    for name, extra in (("bf16", []), ("int8", ["--kv-cache-dtype", "int8"]),
                        ("hifigan", ["--vocoder", "hifigan"])):
        out = work / f"served_{name}"
        ka.flash_attention.launches = 0
        with RecordAttention() as rec:
            rc = generate_waveform.main(base + ["--results-path", str(out)]
                                        + extra)
            torch.cuda.synchronize()
            launches = ka.flash_attention.launches
        if rc != 0:
            raise AssertionError(f"generate_waveform ({name}) returned {rc}")
        timing = json.loads((out / "timing.json").read_text())
        if launches != 12 * len(timing):
            raise AssertionError(f"serve {name}: {launches} kernel launches "
                                 f"for {len(timing)} batches; want 12 each")
        worst = max(worst, hold_path_attention(rec.calls,
                                               f"data_prep_serve_{name}",
                                               card))
        hop = 256
        for wav in sorted((out / "wav").glob("*_pred.wav")):
            feat = np.load(out / "feat" / wav.name.replace(".wav", ".npy"))
            with wave.open(str(wav), "rb") as w:
                n = w.getnframes()
                pcm = np.frombuffer(w.readframes(n), "<i2")
            want = hop * len(feat) if name == "hifigan" \
                else hop * (len(feat) - 1)
            if feat.shape != (PREP_MAX_ITER * 4, 80) or \
                    not np.isfinite(feat).all() or n != want or \
                    not np.any(pcm):
                raise AssertionError(f"serve {name}: {wav.name} features "
                                     f"{feat.shape}, {n} samples (want "
                                     f"{want})")
        steps = sum(r["decode_steps"] for r in timing)
        runs[name] = {"launches": launches, "batches": len(timing),
                      "decode_ms_per_step": sum(r["decode_ms"]
                                                for r in timing) / steps,
                      "vocoder_ms_per_batch": sum(r["vocoder_ms"]
                                                  for r in timing)
                      / len(timing),
                      "rows": sum(r["rows"] for r in timing)}
        print(f"data_prep serve {name}: {runs[name]['rows']} utterances in "
              f"{len(timing)} batch(es), decode "
              f"{runs[name]['decode_ms_per_step']:.3f} ms/step over "
              f"{steps} steps, vocoder "
              f"{runs[name]['vocoder_ms_per_batch']:.3f} wall ms a batch, "
              f"kernel launches {launches} ({card})",
              flush=True)
    feats = torch.from_numpy(np.stack([
        np.load(p) for p in sorted((work / "served_bf16" / "feat").glob(
            "*_pred.npy"))])).cuda()
    cfg = S2STDataConfig(data / "config.yaml")
    device = {}
    with torch.inference_mode():
        for name in ("griffin_lim", "hifigan"):
            voc = get_vocoder(name, cfg, 64, torch.device("cuda"))
            device[name] = device_ms(lambda: voc(feats), iters=3)
    print(f"data_prep vocoders on one batch of {tuple(feats.shape)}: "
          f"hifigan (v1 width, fp32) {device['hifigan']:.3f} device ms, "
          f"griffin_lim (64 iterations) {device['griffin_lim']:.3f} device "
          f"ms ({card})", flush=True)
    return {"runs": runs, "vocoder_device_ms": device,
            "path_max_abs_err": worst}


def data_prep_phase(card: str) -> dict:
    """19: stages 1-7 from raw audio at recipe width (the module's
    docstring)."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_prep_"))
    try:
        t_phase = time.perf_counter()
        inputs = write_prep_inputs(work / "raw", seed=31)
        walls = run_prep_recipe(work, inputs)
        n = sum(n for _, n in PREP_SPLITS)
        rate = {"utterances_per_s": n / walls["extract_s"],
                "audio_s_per_s": inputs["audio_s"] / walls["extract_s"]}
        print(f"data_prep: stages 1-2 {walls['stages_1_2_s']:.2f} s, stage 3 "
              f"{walls['stages_3_3_s']:.2f} s of which extraction "
              f"{walls['extract_s']:.3f} s for {walls['extracted']} pairs "
              f"({inputs['audio_s']:.1f} s of audio): "
              f"{rate['utterances_per_s']:.2f} utterance pairs/s, "
              f"{rate['audio_s_per_s']:.1f} s of audio/s ({card})",
              flush=True)
        rows = check_prep_outputs(work, card)
        dsp = prep_features_on_card(inputs, rows, card)
        prep_8k(work, card)
        data = work / "features"
        with open(data / "config.yaml", "a") as f:
            f.write(write_hifigan_v1(work, seed=32))
        with RecordAttention() as rec:
            train = run_train_cli(recipe_train_argv(data, work / "save", 2),
                                  work / "save", card, "data_prep: the "
                                  "recipe's flags on stage 3's features")
        if train["updates"] != 2 or train["fwd_launches"] or \
                train["bwd_launches"] or rec.calls:
            raise AssertionError(f"data_prep train: {train['updates']} "
                                 f"updates, kernel launches "
                                 f"{train['fwd_launches']}; want 2 and 0")
        served = prep_serve(work, data, work / "save" / "checkpoint_last.npz",
                            card)
        out = {"walls": walls, "rate": rate, "dsp": dsp, "train": {
            k: train[k] for k in ("updates", "fwd_launches", "step_ms",
                                  "first_step_ms", "losses", "peak_gib")},
               **served,
               "phase_s": time.perf_counter() - t_phase}
        print("data_prep " + json.dumps({**out, "card": card}), flush=True)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 20: search strategies, constraints, prefixes, ensembles; fairseq
# .pt serving; asynchronous saves and --stop-min-lr
# --------------------------------------------------------------------------

# phase 20's stages 10-11 corpus: the first 16 of phase 14's utterances,
# one batch under --max-tokens 50000
SEARCH_FRAMES = S2T_FRAMES[:16]
# each run: (flags after phase 14's sacrebleu line, checkpoints, scoring)
SEARCH_RUNS = {
    "beam": ([], "a", "sacrebleu"),
    "sampling_topk": (["--sampling", "--sampling-topk", "10"], "a",
                      "sacrebleu"),
    "diverse_beam": (["--diverse-beam-groups", "5"], "a", "sacrebleu"),
    "diverse_siblings": (["--diversity-rate", "0.5"], "a", "sacrebleu"),
    "prefix": (["--prefix-size", "1"], "a", "wer"),
    "constraints_ordered": (["--constraints", "ordered"], "a", "sacrebleu"),
    "constraints_unordered": (["--constraints", "unordered"], "a",
                              "sacrebleu"),
    "ensemble": ([], "a:b", "sacrebleu"),
    "pt": ([], "pt", "sacrebleu"),
}
TEXT_SEARCH_RUNS = {
    "sampling": (["--sampling", "--sampling-topk", "10"], "lightweight", 1),
    "diverse_beam": (["--diverse-beam-groups", "5"], "lightweight", 1),
    "ensemble": ([], "lightweight", 2),
    "dynamic_sampling": (["--sampling", "--sampling-topp", "0.9"],
                         "dynamic", 1),
}


def recipe_flags() -> list:
    """RECIPE_ARGS as command-line flags: a fairseq .pt's model comes from
    the command line, as in JAX's CLIs."""
    out = []
    for key, value in RECIPE_ARGS.items():
        flag = "--" + key.replace("_", "-")
        if value is True:
            out.append(flag)
        elif value is not False:
            out += [flag, str(value)]
    return out


class RecordConv:
    """Keeps, for each distinct call of the conv kernels on a main path
    (kind, shapes, padding, heads, dtypes), the first call's inputs and the
    output the path got; ``hold_path_conv`` then holds each against the
    plain version."""

    def __enter__(self):
        from s2st_tpu_torch.kernels import conv as kc
        self.kc, self.table, self.calls = kc, dict(kc._FORWARD), {}

        def recorder(kind):
            kernel, plain = self.table[kind]

            def record(x, weight, padding_l, heads):
                out = kernel(x, weight, padding_l, heads)
                key = (kind, tuple(x.shape), tuple(weight.shape), padding_l,
                       heads, str(x.dtype).split(".")[-1],
                       str(weight.dtype).split(".")[-1])
                if key not in self.calls:
                    self.calls[key] = (x.detach().clone(),
                                       weight.detach().clone(),
                                       out.detach().clone())
                return out
            return record, plain
        for kind in self.table:
            kc._FORWARD[kind] = recorder(kind)
        return self

    def __exit__(self, *exc):
        self.kc._FORWARD.update(self.table)


def hold_path_conv(calls: dict, label: str, card: str) -> float:
    """Each recorded conv call's kernel output against the plain version
    on the same inputs: fp32 within TOL_FP32, bf16 within TOL_BF16 x
    max(1, max |x| / 4) (the output is a convex combination of x's rows,
    rounded to bf16; phase 9's bound for unit-normal x). Returns the
    largest error."""
    from s2st_tpu_torch.kernels import conv as kc
    worst = 0.0
    with torch.inference_mode():
        for (kind, xs, ws, pad, heads, xt, wt), (x, w, out) in calls.items():
            ref = getattr(kc, f"{kind}_reference")(x, w, pad, heads)
            err = (out.float() - ref.float()).abs()
            max_err = float(err.max()) if err.numel() else 0.0
            if xt == "float32":
                atol, rtol = TOL_FP32
                ok = bool((err <= atol + rtol * ref.float().abs()).all())
                tol = f"atol {atol} + rtol {rtol}"
            else:
                bound = TOL_BF16 * max(1.0, float(x.float().abs().max()) / 4)
                ok = max_err <= bound
                tol = f"atol {bound:.4g}"
            ok = ok and bool(torch.isfinite(out.float()).all())
            print("path_conv " + json.dumps({
                "path": label, "kernel": kind, "x": xs, "weight": ws,
                "padding_l": pad, "heads": heads, "dtype": xt,
                "weight_dtype": wt, "max_abs_err": max_err,
                "tolerance": tol, "card": card}), flush=True)
            if not ok:
                raise AssertionError(f"{label}: {kind} at x {xs} weight {ws} "
                                     f"{xt} disagrees with the plain version:"
                                     f" max abs err {max_err} ({tol})")
            worst = max(worst, max_err)
    print(f"{label}: {len(calls)} distinct conv kernel calls held against "
          f"the plain version, max abs err {worst:.3e} ({card})", flush=True)
    return worst


def search_s2t(work: Path, card: str) -> dict:
    """Phase 20(a)-(b): stages 10-11 under every search option, and the
    fairseq .pt of the same weights through both serving CLIs."""
    from s2st_tpu_torch.cli import generate_waveform
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from s2st_tpu_torch.preprocessing import constraints_tools
    from s2st_tpu_torch.tasks.s2s_translation import load_dictionaries
    data = work / "data"
    write_train_corpus(data, seed=7, frames=SEARCH_FRAMES)
    shutil.copy(data / "train.tsv", data / "test.tsv")
    dicts = load_dictionaries(str(data), S2STDataConfig(data / "config.yaml"))
    cfg = recipe_config().replace(src_vocab_size=len(dicts[0]),
                                  tgt_vocab_size=len(dicts[1]))
    ckpts = {}
    for name, seed in (("a", 4), ("b", 6)):
        model = S2STTransformer(cfg).init_weights(seed)
        ckpts[name] = work / f"checkpoint_{name}.npz"
        write_jax_checkpoint(str(ckpts[name]), model,
                             meta={"args": RECIPE_ARGS})
        if name == "a":    # the same weights in fairseq's layout
            ckpts["pt"] = work / "checkpoint_a.pt"
            torch.save({"model": model.state_dict(),
                        "cfg": {"model": {"_name": "s2st_transformer"}}},
                       str(ckpts["pt"]))
    ckpts["a:b"] = f"{ckpts['a']}:{ckpts['b']}"
    cons = work / "constraints.tsv"
    if constraints_tools.main(["extract", "--audio-manifest",
                               str(data / "test.tsv"), "--field", "tgt_text",
                               "-n", "2", "--max-len", "2", "--seed", "1",
                               "-o", str(cons)]) != 0:
        raise AssertionError("constraints_tools extract failed")
    runs = {}
    with RecordAttention() as rec_attn:
        for label, (extra, which, scoring) in SEARCH_RUNS.items():
            argv = s2t_argv(data, ckpts[which], work / label, scoring)
            if which == "pt":
                argv += recipe_flags()
            if label.startswith("constraints"):
                extra = extra + ["--constraints-file", str(cons)]
            rec = run_s2t_cli(argv + extra, card, label,
                              n_rows=len(SEARCH_FRAMES))
            n_models = len(str(ckpts[which]).split(":"))
            batches = rec["timing"]["batches"]
            if rec["launches"] != 12 * n_models * len(batches):
                raise AssertionError(
                    f"search ({label}): flash_attention launched "
                    f"{rec['launches']} times over {len(batches)} batches; "
                    f"want {12 * n_models} a batch")
            if label.startswith("constraints") and not any(
                    ln.startswith("C-") for ln in rec["lines"]):
                raise AssertionError(f"search ({label}): no C- line")
            steps = sum(b["decode_steps"] for b in batches)
            beam_ms = sum(b["beam_ms"] for b in batches)
            print(f"search ({label}): {rec['timing']['sentences']} "
                  f"sentences, {rec['timing']['sentences_per_s']:.2f} "
                  f"sentences/s, beam {beam_ms / steps:.3f} ms a step over "
                  f"{steps}, encode_ms {batches[0]['encode_ms']:.3f}; "
                  f"flash_attention launches {rec['launches']} "
                  f"({12 * n_models} a batch); {rec['result']} ({card})",
                  flush=True)
            runs[label] = rec
    if runs["pt"]["lines"] != runs["beam"]["lines"]:
        raise AssertionError("generate_for_s2st: the .pt's lines differ "
                             "from the .npz's of the same weights")
    if runs["sampling_topk"]["lines"] == runs["beam"]["lines"]:
        raise AssertionError("search: sampling printed beam search's lines")
    runs["path_max_abs_err"] = hold_path_attention(rec_attn.calls, "search",
                                                   card)
    # stage 7 from the .pt and from the .npz of the same weights
    feats = {}
    for which in ("a", "pt"):
        out = work / f"stage7_{which}"
        argv = [str(data), "--config-yaml", "config.yaml", "--gen-subset",
                "tst", "--task", "s2s_translation", "--path",
                str(ckpts[which]), "--results-path", str(out), "--max-iter",
                "30", "--eos-prob-threshold", "1.5", "--spec-bwd-max-iter",
                "8", "--dump-features", "--device", "cuda", *recipe_flags()]
        from s2st_tpu_torch.kernels import attention as ka
        ka.flash_attention.launches = 0
        if generate_waveform.main(argv) != 0:
            raise AssertionError(f"generate_waveform ({which}) failed")
        runs[f"stage7_{which}_launches"] = ka.flash_attention.launches
        feats[which] = np.load(out / "feat" / "utt3_pred.npy")
    if feats["a"].shape != (120, 80) or not np.isfinite(feats["a"]).all() \
            or not np.array_equal(feats["pt"], feats["a"]):
        raise AssertionError(
            f"generate_waveform: the .pt's features {feats['pt'].shape} "
            f"differ from the .npz's {feats['a'].shape}: max abs diff "
            f"{float(np.abs(feats['pt'] - feats['a']).max())}")
    if runs["stage7_pt_launches"] != 12:
        raise AssertionError(f"generate_waveform (.pt): "
                             f"{runs['stage7_pt_launches']} kernel launches "
                             f"for its batch; want 12")
    print(f"search: the fairseq .pt serves generate_for_s2st's lines and "
          f"generate_waveform's features (120, 80) of the .npz of the same "
          f"weights, equal; 12 launches a batch ({card})", flush=True)
    return runs


def search_text(work: Path, card: str) -> dict:
    """Phase 20(c): LightConv / DynamicConv text generate with sampling,
    diverse beam and a 2-checkpoint ensemble."""
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    data = work / "text"
    write_text_corpus(data, seed=11)
    ckpts = {}
    for conv_type in ("lightweight", "dynamic"):
        paths = []
        for seed in (12, 13):
            model, echo = text_model(conv_type, seed=seed)
            paths.append(work / f"lightconv_{conv_type}_{seed}.npz")
            write_jax_checkpoint(str(paths[-1]), model, meta={"args": echo})
        ckpts[conv_type] = paths
    runs = {}
    with RecordConv() as rec_conv:
        for label, (extra, conv_type, n) in TEXT_SEARCH_RUNS.items():
            path = ":".join(str(p) for p in ckpts[conv_type][:n])
            rec = run_text_cli(data, path, work / f"text_{label}", False,
                               card, f"search {label}", tuple(extra))
            used = "lightconv" if conv_type == "lightweight" else \
                "dynamicconv"
            other = "dynamicconv" if used == "lightconv" else "lightconv"
            want = 7 * n * rec["batches"]
            if rec["counts"][used] != want or rec["counts"][other] != 0:
                raise AssertionError(
                    f"text search ({label}): launches {rec['counts']} over "
                    f"{rec['batches']} batches; want {used} {want} and "
                    f"{other} 0")
            runs[label] = rec
    runs["path_max_abs_err"] = hold_path_conv(rec_conv.calls, "text_search",
                                              card)
    return runs


def save_async_runs(work: Path, card: str) -> dict:
    """Phase 20(d)-(e): phase 13's training run (deterministic algorithms,
    batches of 2, --update-freq 2, EMA, --keep-last-epochs 2) with
    --warmup-updates 1 --stop-min-lr 8e-4, once with synchronous saves and
    once with --save-async: both stop after epoch 2 (update 4; the next
    update's rate 6.7e-4), their files equal bit for bit; each save's
    stall and write, and peak memory, side by side."""
    from s2st_tpu_torch.train.checkpoint import load_checkpoint_file
    data = work / "train"
    write_train_corpus(data, seed=3)
    out = {}
    with RecordAttention() as rec_attn, Deterministic():
        for mode in ("sync", "async"):
            extra = ["--warmup-updates", "1", "--stop-min-lr", "8e-4",
                     "--max-epoch", "10"]
            if mode == "async":
                extra.append("--save-async")
            with TimedSaves() as saves:
                rec = run_train_cli(runtime_argv(data, work / mode, *extra),
                                    work / mode, card, f"save {mode}")
            rec["saves"] = saves.records
            out[mode] = rec
    for mode, rec in out.items():
        micro = 2 * 4
        if rec["fwd_launches"] < 27 * micro or \
                rec["bwd_launches"] < 27 * micro:
            raise AssertionError(f"save {mode}: {rec['fwd_launches']} forward"
                                 f" and {rec['bwd_launches']} backward "
                                 f"launches over {micro} microbatches; want "
                                 f">= 27 each")
        if rec["updates"] != 4:
            raise AssertionError(f"save {mode}: {rec['updates']} updates; "
                                 f"--stop-min-lr should stop at 4")
    names = sorted(p.name for p in (work / "sync").glob("*.npz"))
    if names != sorted(p.name for p in (work / "async").glob("*.npz")) or \
            "checkpoint_last_ema.npz" not in names:
        raise AssertionError(f"save: the runs kept different files: {names}")
    arrays = 0
    # checkpoint2 is checkpoint_last under another name in both runs
    for name in ("checkpoint1.npz", "checkpoint_last.npz",
                 "checkpoint_last_ema.npz"):
        a, ma = load_checkpoint_file(str(work / "async" / name))
        b, mb = load_checkpoint_file(str(work / "sync" / name))
        for m in (ma, mb):
            for key in ("save_dir", "write_checkpoints_asynchronously",
                        "log_file", "tensorboard_logdir"):
                m.get("args", {}).pop(key, None)
        diff = sorted(k for k in a if k not in b
                      or not np.array_equal(a[k], b[k]))
        if diff or set(a) != set(b) or ma != mb:
            raise AssertionError(f"save: the asynchronous run's {name} "
                                 f"differs from the synchronous run's in "
                                 f"{diff[:5]} (meta equal: {ma == mb})")
        arrays += len(a)
    last = load_checkpoint_file(str(work / "async" /
                                    "checkpoint_last.npz"))[1]
    if (last["step"], last["epoch"]) != (4, 2):
        raise AssertionError(f"--stop-min-lr: checkpoint_last at step "
                             f"{last['step']}, epoch {last['epoch']}; want "
                             f"4, 2")
    out["path_max_abs_err"] = hold_path_attention(rec_attn.calls,
                                                  "save_async", card)
    for mode in ("sync", "async"):
        rec = out[mode]
        print(f"save ({mode}): "
              + ", ".join(f"stall {r['stall_ms']:.1f} ms, write "
                          f"{r['write_ms']:.1f} ms for {r['mb']:.1f} MB "
                          f"{'+'.join(r['names'])}" for r in rec["saves"])
              + f"; {rec['step_ms']:.3f} ms/update, peak memory "
              f"{rec['peak_gib']:.2f} GiB, wall {rec['wall_s']:.1f} s "
              f"({card})", flush=True)
    print(f"save: the asynchronous run's {len(names)} files equal the "
          f"synchronous run's bit for bit in {arrays} arrays and their meta;"
          f" --stop-min-lr 8e-4 stopped both after epoch 2 at update 4 "
          f"({card})", flush=True)
    return out


def search_phase(card: str) -> dict:
    """Phase 20: the search options of stages 10-11 and text generate,
    fairseq .pt serving, asynchronous saves and --stop-min-lr."""
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_search_"))
    t0 = time.perf_counter()
    try:
        out = {"s2t": search_s2t(work, card),
               "text": search_text(work, card),
               "save": save_async_runs(work, card)}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 20: {out['seconds']:.1f} s ({card})", flush=True)
    return out


def convergence_runs() -> int:
    """``--convergence``: the full gate in fp32 and under --fp16 on the
    card; each prints its ``convergence`` JSON line, with the card's name
    and power limit, and is merged into
    chiprun_out/CONVERGENCE_TORCH.card.json."""
    sys.path.insert(0, str(REPO))
    from s2st_tpu_torch.tools import convergence_gate as cg
    out = REPO / "chiprun_out" / "CONVERGENCE_TORCH.card.json"
    out.parent.mkdir(exist_ok=True)
    ok = True
    for extra in ([], ["--fp16"]):
        with tempfile.TemporaryDirectory(prefix="convergence_") as tmp:
            ok = cg.main(["--device", "cuda", "--json", str(out),
                          "--outdir", tmp, *extra]) == 0 and ok
    return 0 if ok else 1


# Phase 21: the paper's training recipes (recipes/run_pretraining_torch.sh,
# recipes/run_mix_tuning_torch.sh): each line's flags, 3 updates at the
# recipe's widths under --fp16 with the kernel configuration
PAPER_UPDATES = 3
# the archs whose targets are text tokens (s2t_loss)
TEXT_FAMILIES = ("s2t", "xm", "convtransformer", "berard")
PAPER_FLAGS = ("--use-flash-attention", "--attention-dropout", "0",
               "--device", "cuda", "--log-interval", "1",
               "--no-epoch-checkpoints", "--save-interval", "100")
PAPER_ALPHA = 0.5
# mix-tuning stage 2's two corpora: the first 10 and the last 6 of phase
# 16's 16 utterances
PAPER_CORPORA = (("train_fisher", slice(0, 10)), ("train_mls", slice(10, 16)))


def recipe_train_lines(script: str, env: dict, work: Path) -> list:
    """The flags of each ``python -m s2st_tpu_torch.cli.train`` line of a
    port recipe script, as bash expands them with ``env``: recorded by a
    ``python`` on its PATH that writes its arguments and exits."""
    shim = work / "record_bin"
    shim.mkdir(exist_ok=True)
    log = work / f"{script}.jsonl"
    (shim / "python").write_text(
        f"#!{sys.executable}\nimport json, sys\n"
        f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n")
    (shim / "python").chmod(0o755)
    res = subprocess.run(
        ["bash", str(REPO / "recipes" / f"{script}.sh")],
        env={**os.environ, "PATH": f"{shim}:{os.environ['PATH']}", **env},
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise AssertionError(f"{script}.sh: {res.stderr[-2000:]}")
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    if not lines or any(line[:2] != ["-m", "s2st_tpu_torch.cli.train"]
                        for line in lines):
        raise AssertionError(f"{script}.sh ran {lines}")
    return [line[2:] for line in lines]


def paper_launches(args) -> tuple:
    """(forward, backward) attention kernel launches of one update of the
    train CLI's model of ``args`` with every attention on the kernel: the
    frontend's layers (forward only: it is frozen), the encoder's (the T2S
    text encoder's ``--encoder-transformer-layers``; none in
    xm_transformer, whose trunk is its encoder), each decoder layer's self
    and cross attention, less the last spectrogram decoder layer's cross
    attention, whose weights the loss reads."""
    from s2st_tpu_torch.models.config_from_args import arch_family
    family = arch_family(args)
    if family in ("berard", "tacotron2"):   # MLP and location attention
        return 0, 0
    if family == "fastspeech2":             # self-attention only
        return (args.encoder_layers + args.decoder_layers,) * 2
    hub = args.hubert_layers if args.use_hubert else 0
    enc = {"t2s": args.encoder_transformer_layers,
           "xm": 0}.get(family, args.encoder_layers)
    fwd = enc + 2 * args.decoder_layers
    if family in ("s2st", "t2s"):
        fwd -= 1
    if family == "s2st":
        fwd += 2 * args.asr_decoder_layers * (args.asr_ce_weight > 0)
        fwd += 2 * args.st_decoder_layers * (args.st_ce_weight > 0)
    return fwd + hub, fwd


class RecordAttentionBwd:
    """Keeps, for each distinct call of the attention backward kernel on a
    main path, the first call's inputs and the gradients the path got;
    ``hold_path_attention_bwd`` then holds each against the plain
    version."""

    def __enter__(self):
        from s2st_tpu_torch.kernels import attention as ka
        self.ka, self.fn, self.calls = ka, ka.flash_attention_backward, {}

        def record(q, k, v, out, row_max, row_logsum, grad_out, kpm=None,
                   causal=False):
            grads = self.fn(q, k, v, out, row_max, row_logsum, grad_out, kpm,
                            causal)
            key = (tuple(q.shape), k.shape[1], str(q.dtype).split(".")[-1],
                   bool(causal), kpm is not None)
            if key not in self.calls:
                self.calls[key] = tuple(
                    None if x is None else x.detach().clone()
                    for x in (q, k, v, kpm, grad_out, out) + tuple(grads))
            return grads
        ka.flash_attention_backward = record
        return self

    def __exit__(self, *exc):
        self.ka.flash_attention_backward = self.fn


def bwd_error_bound(q, k, v, kpm, causal, g, out) -> tuple:
    """Elementwise bounds on a bf16 backward's error against the plain
    version's fp32 autograd (all inputs fp32 copies): the kernel rounds P
    and dS = P (dP - D) to bf16 before its products (each a relative 2^-8
    of its terms, and the result's own rounding), and takes D = rowsum(dO *
    o) from the bf16 output o (an error of 2^-8 rowsum|dO||o| a row, which
    dS carries as P times it). So |ddQ| <= 4u |dS||K| + 2u r P|K|, |ddK| <=
    4u |dS|^T|Q| + 2u P^T (r|Q|), |ddV| <= 4u P^T|dO|, u = 2^-8, r the
    rows' rowsum|dO||o|, products over the keys or queries a row sees."""
    u = 2.0 ** -8
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    tq, tk = logits.shape[-2:]
    if causal:
        logits = logits + torch.triu(torch.full(
            (tq, tk), -1e9, device=q.device), diagonal=1)
    if kpm is not None:
        logits = logits.masked_fill(kpm[:, None, None, :], -1e9)
    p = torch.softmax(logits, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    r = (g.abs() * out.abs()).sum(-1).transpose(1, 2)[..., None]  # (B,H,Tq,1)
    dq = 4 * u * torch.einsum("bhqk,bkhd->bqhd", ds.abs(), k.abs()) \
        + 2 * u * torch.einsum("bhqk,bkhd->bqhd", p * r, k.abs())
    dk = 4 * u * torch.einsum("bhqk,bqhd->bkhd", ds.abs(), q.abs()) \
        + 2 * u * torch.einsum("bhqk,bqhd->bkhd", p * r, q.abs())
    dv = 4 * u * torch.einsum("bhqk,bqhd->bkhd", p, g.abs())
    return dq, dk, dv


# fp32: besides its own inputs, each call is also run, kernel and plain
# version alike, at its shapes, padding mask and causality on seeded
# normal q, k, v (each at the RMS of the path's) and a unit-normal dO;
# dq, dk, dv are each held there by relative error ||got - exact|| /
# ||exact|| against the float64 plain version. A path's own inputs can
# leave a gradient unresolved in fp32: phase 25's CTC run's dq is at
# most 6.3e-08, under TOL_BWD_FP32's atol, and even at a unit dO on its
# q, k, v the fp32 plain version's dq is 4.6e3 times the float64 one's
# norm away from it, so no check there can refuse dq = 0. The kernel
# sums in fp32 FMAs over up to 512 keys or queries: n 2^-24 = 3e-5
REL_BWD_FP32 = 1e-4


def attention_fp64(q, k, v, kpm, causal):
    """The plain version in float64 (an oracle for fp32 gradients)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        tq, tk = logits.shape[-2:]
        logits = logits.masked_fill(torch.ones(
            tq, tk, dtype=torch.bool, device=q.device).triu(1), -1e9)
    if kpm is not None:
        logits = logits.masked_fill(kpm[:, None, None, :], -1e9)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)


def unit_case_grads(shape, tk, kpm, causal, path) -> dict:
    """dq, dk, dv at a recorded fp32 call's shapes, padding mask and
    causality, on seeded normal q, k, v at the RMS of the path's
    (``path``) and a unit-normal dO: the kernels' (its forward for the
    output and row statistics; neither launch counted), and the fp32
    and float64 plain versions' autograd."""
    from s2st_tpu_torch.kernels import attention as ka
    b, tq, h, d = shape
    dev = path[0].device
    gen = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(size, device=dev, generator=gen)
               * float(x.detach().float().square().mean().sqrt())
               for size, x in zip(((b, tq, h, d), (b, tk, h, d),
                                   (b, tk, h, d)), path))
    g = torch.randn(shape, device=dev, generator=gen)
    launches = ka.flash_attention.launches, ka.flash_attention.bwd_launches
    out, row_max, row_logsum = ka.flash_attention_forward(
        q, k, v, kpm, causal, stats=True)
    kernel = ka.flash_attention_backward(q, k, v, out, row_max, row_logsum,
                                         g, kpm, causal)
    ka.flash_attention.launches, ka.flash_attention.bwd_launches = launches
    grads = {"kernel": kernel}
    for name, plain, dt in (("fp32", ka.flash_attention_reference,
                             torch.float32),
                            ("exact", attention_fp64, torch.float64)):
        leaves = [x.to(dt).requires_grad_() for x in (q, k, v)]
        grads[name] = torch.autograd.grad(plain(*leaves, kpm, causal),
                                          leaves, g.to(dt))
    return grads


def _rel_errs(got, exact) -> list:
    return [float((x.double() - e).norm() / e.norm()) for x, e in
            zip(got, exact)]


def _bwd_within(got, want, bounds, unit=None) -> tuple:
    """(every gradient finite and within its bound elementwise and, with
    ``unit`` ((dq, dk, dv) of unit_case_grads' case, and its float64
    ones), each there within REL_BWD_FP32 of its float64 one, max abs err,
    largest err / bound)."""
    ok, max_err, share = True, 0.0, 0.0
    for x, y, bound in zip(got, want, bounds):
        err = (x.float() - y).abs()
        if err.numel():
            max_err = max(max_err, float(err.max()))
            share = max(share, float((err / bound).max()))
        ok = ok and bool(torch.isfinite(x.float()).all()) and \
            bool((err <= bound).all())
    if unit is not None:
        ok = ok and all(e <= REL_BWD_FP32 for e in _rel_errs(*unit))
    return ok, max_err, share


def hold_path_attention_bwd(calls: dict, label: str, card: str) -> float:
    """Each recorded backward call's dq, dk, dv against the plain
    version's fp32 autograd on the same inputs and dO: fp32 within phase
    5's TOL_BWD_FP32, and at the same shapes and mask on seeded inputs
    each within REL_BWD_FP32 of the float64 plain version's
    (unit_case_grads); bf16 within
    ``bwd_error_bound`` elementwise plus 1e-3 of the gradient's largest
    magnitude (phase 5's bound, 3e-2 of it alone, fails on the path's
    gradients, whose dS cancels to near 0 in most rows). Each call's check
    must also refuse two wrong answers, dq set to 0 and dk and dv swapped
    (in fp32 on both inputs; in bf16 dq or dk set to 1 where dO, and so
    every gradient, is 0), or it checks nothing there. Returns the largest
    error."""
    from s2st_tpu_torch.kernels import attention as ka
    worst = 0.0
    for (shape, tk, dtype, causal, masked), \
            (q, k, v, kpm, g, out, *got) in calls.items():
        leaves = [x.float().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(ka.flash_attention_reference(
            *leaves, kpm, causal), leaves, g.float())
        unit = None
        if dtype == "float32":
            atol, rtol = TOL_BWD_FP32
            bounds = [atol + rtol * y.abs() for y in want]
            unit = unit_case_grads(shape, tk, kpm, causal, (q, k, v))
        else:
            with torch.no_grad():
                bounds = [b + 1e-3 * y.abs().max() for b, y in zip(
                    bwd_error_bound(*(x.float() for x in (q, k, v)), kpm,
                                    causal, g.float(), out.float()), want)]
        ok, max_err, worst_share = _bwd_within(
            got, want, bounds,
            None if unit is None else (unit["kernel"], unit["exact"]))
        # where dO is 0 (a loss term weighted 0 upstream) every gradient
        # and every bound is 0: in bf16 ones stand in for the wrong answers
        zero = not any(bool(y.any()) for y in want)

        def planted(dq, dk, dv):
            if zero and unit is None:
                return (torch.ones_like(dq), dk, dv), \
                    (dq, torch.ones_like(dk), dv)
            return (torch.zeros_like(dq), dk, dv), (dq, dv, dk)
        if unit is None:
            caught = [not _bwd_within(w, want, bounds)[0]
                      for w in planted(*got)]
        else:
            caught = [not _bwd_within(w, want, bounds, (w_unit,
                                                         unit["exact"]))[0]
                      for w, w_unit in zip(planted(*got),
                                           planted(*unit["kernel"]))]
        b, tq, h, d = shape
        print("path_case_bwd " + json.dumps({
            "path": label, "B": b, "Tq": tq, "Tk": tk, "H": h, "D": d,
            "dtype": dtype, "causal": causal, "key_padding": masked,
            "max_abs_err": max_err, "err_over_bound": worst_share,
            "max_abs_grad": [float(y.abs().max()) for y in want],
            "seeded_rel_err": None if unit is None else {
                "kernel": _rel_errs(unit["kernel"], unit["exact"]),
                "plain_fp32": _rel_errs(unit["fp32"], unit["exact"]),
                "limit": REL_BWD_FP32},
            "dO_zero": zero, "refuses_wrong_answers": caught,
            "card": card}),
            flush=True)
        rel = "" if unit is None else (
            f", on seeded inputs relative errors "
            f"{_rel_errs(unit['kernel'], unit['exact'])} (limit "
            f"{REL_BWD_FP32})")
        if not ok:
            raise AssertionError(f"{label}: the backward kernel at B={b} "
                                 f"Tq={tq} Tk={tk} D={d} {dtype} disagrees "
                                 f"with the plain version: {max_err} "
                                 f"({worst_share:.3f} of the bound){rel}")
        if not all(caught):
            raise AssertionError(f"{label}: the backward check at B={b} "
                                 f"Tq={tq} Tk={tk} D={d} {dtype} passes a "
                                 f"wrong answer (refused {caught})")
        worst = max(worst, max_err)
    print(f"{label}: {len(calls)} distinct backward kernel calls held "
          f"against the plain version, each refusing two wrong answers, "
          f"max abs err {worst:.3e} ({card})", flush=True)
    return worst


def run_paper_line(argv: list, card: str, label: str, extra=(),
                   want=None, validate=False) -> dict:
    """One recipe line through the port's train CLI in this process, with
    PAPER_FLAGS, ``--disable-validation`` unless ``validate``, and
    ``extra``: each update's attention launches (forward, backward) must
    be ``want``'s, a list of one pair an update (by default
    paper_launches' for the line's model each update);
    the second update's ms, the third's device ms and wall under
    torch.profiler (device events only) and the idle share of that one
    update, peak memory; every distinct kernel call, forward and backward,
    held against the plain version, and the dtypes the kernels took."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.models.config_from_args import apply_arch, arch_family
    from s2st_tpu_torch.train.trainer import Trainer
    argv = [*argv, "--max-update", str(PAPER_UPDATES), *PAPER_FLAGS,
            *(() if validate else ("--disable-validation",)), *extra]
    save = Path(argv[argv.index("--save-dir") + 1])
    argv += ["--log-file", str(save / "log.jsonl")]
    args = apply_arch(train.get_parser().parse_args(argv), argv)
    want = want or [paper_launches(args)] * PAPER_UPDATES
    orig, per_update, prof = Trainer.train_step, [], {}

    def step(self, *a, **k):
        f0, b0 = ka.flash_attention.launches, ka.flash_attention.bwd_launches
        if self.step == PAPER_UPDATES - 1:
            out, wall, busy, n, top = _profiled(lambda: orig(self, *a, **k),
                                                host_events=False)
            if busy <= 0:
                raise AssertionError(f"{label}: the profiler saw no device "
                                     f"time")
            prof.update(wall_ms=wall, device_ms=busy, activities=n,
                        top=top[:5])
        else:
            out = orig(self, *a, **k)
        torch.cuda.synchronize()
        per_update.append((ka.flash_attention.launches - f0,
                           ka.flash_attention.bwd_launches - b0))
        return out

    Trainer.train_step = step
    text = args.task == "audio_finetuning" or (
        args.task not in train.AUDIO_TASKS
        and arch_family(args) in TEXT_FAMILIES)
    try:
        with RecordAttention() as rf, RecordAttentionBwd() as rb:
            run = run_train_cli(argv, save, card, label, s2t=text,
                                frames_per_step=args.n_frames_per_step)
    finally:
        Trainer.train_step = orig
    if run["updates"] != PAPER_UPDATES or per_update != list(want):
        raise AssertionError(f"{label}: {run['updates']} updates, launches "
                             f"(fwd, bwd) an update {per_update}; want "
                             f"{PAPER_UPDATES} of {want}")
    run["launches_per_update"] = want
    run["update_ms"] = json.loads([line for line in (
        save / "log.jsonl").read_text().splitlines()
        if '"valid"' not in line][1])["step_ms"]
    prof["idle"] = 1 - prof["device_ms"] / prof["wall_ms"]
    run["profile"] = {k: prof[k] for k in ("wall_ms", "device_ms", "idle",
                                           "activities")}
    run["fwd_err"] = hold_path_attention(rf.calls, label, card)
    run["bwd_err"] = hold_path_attention_bwd(rb.calls, label, card)
    run["kernel_dtypes"] = sorted({key[2] for key in (*rf.calls, *rb.calls)})
    print(f"paper {label}: launches (forward, backward) an update {want}, "
          f"the kernels in {run['kernel_dtypes']}; "
          f"{run['update_ms']:.3f} ms an update (the "
          f"second); the third under torch.profiler: device "
          f"{prof['device_ms']:.3f} ms in {prof['activities']} activities "
          f"of {prof['wall_ms']:.3f} ms wall with the profiler, idle share "
          f"{prof['idle']:.3f}; peak memory "
          f"{run['peak_gib']:.2f} GiB ({card})", flush=True)
    for key, ms, count in prof["top"]:
        print(f"paper {label}:   {ms:9.3f} ms  {count:6d}x  {key[:60]}",
              flush=True)
    return run


class CheckWarmStart:
    """Wraps the train CLI's warm start: right after it, before the first
    update, each warmed parameter must equal the file's array bit for
    bit."""

    def __enter__(self):
        from s2st_tpu_torch.cli import train
        from s2st_tpu_torch.models.jax_bridge import _to_jax, jax_layout
        from s2st_tpu_torch.train.checkpoint import load_checkpoint_file
        self.train, self.fn, self.leaves = train, \
            train.load_pretrained_component, 0

        def check(model, path, component):
            names = self.fn(model, path, component)
            flat = load_checkpoint_file(path)[0]
            layout = {n: (key, kind) for n, key, kind in jax_layout(model)}
            sd = model.state_dict()
            for name in names:
                key, kind = layout[name]
                if not np.array_equal(_to_jax(sd[name], kind), flat[key]):
                    raise AssertionError(f"warm start: {key} differs from "
                                         f"{path}")
            self.leaves += len(names)
            return names
        train.load_pretrained_component = check
        return self

    def __exit__(self, *exc):
        self.train.load_pretrained_component = self.fn


class RecordDraws:
    """The ids of the rows each collate of a resampled train split took,
    in order (one batch an epoch here)."""

    def __enter__(self):
        from s2st_tpu_torch.data.s2st_dataset import TrainSplit
        self.cls, self.fn, self.batches = TrainSplit, TrainSplit.collate, []
        rec = self

        def collate(split, items, **pads):
            if split.resampled:
                rec.batches.append([split.ids[it["index"]] for it in items])
            return rec.fn(split, items, **pads)
        TrainSplit.collate = collate
        return self

    def __exit__(self, *exc):
        self.cls.collate = self.fn


def numpy_draws(data: Path, epochs: int, seed: int = 1) -> list:
    """Each epoch's ids of mix-tuning stage 2's corpora under
    PAPER_ALPHA, drawn here with numpy alone: each TSV's source frames, its
    ratio (p_i^alpha / sum p^alpha) / p_i, then ceil(n_i * ratio) rows of
    each by RandomState([42, seed, epoch]).choice, with replacement where
    the ratio is at least 1."""
    rows = []
    for name, _ in PAPER_CORPORA:
        header, *lines = (data / f"{name}.tsv").read_text().splitlines()
        cols = header.split("\t")
        rows.append([dict(zip(cols, line.split("\t"))) for line in lines])
    sizes = np.array([sum(int(r["src_n_frames"]) for r in c) for c in rows],
                     np.float64)
    p = sizes / sizes.sum()
    ratios = p ** PAPER_ALPHA / (p ** PAPER_ALPHA).sum() / p
    out = []
    for epoch in range(1, epochs + 1):
        ids = []
        for corpus, ratio in zip(rows, ratios):
            rng = np.random.RandomState([42, seed, epoch])
            ids += [corpus[i]["id"] for i in rng.choice(
                len(corpus), int(np.ceil(len(corpus) * ratio)),
                replace=ratio >= 1.0)]
        out.append(ids)
    return out


def paper_recipes_phase(card: str) -> dict:
    """21: the paper's recipes at their widths, --fp16, with
    --use-flash-attention --attention-dropout 0, 3 updates each, every
    line's flags recorded from the port's recipe scripts:
    (a) pretraining stage 1 (text losses only); (b) stage 2, warm-started
    from (a)'s checkpoint_last.npz, the warmed leaves equal to the file's
    before the first update; (c) mix-tuning stage 1 (s2t_transformer_hubert,
    s2t_loss, st) from a seeded hubert-base .pt, the frontend bit-unchanged;
    (d) mix-tuning stage 2 over train_fisher,train_mls resampled with
    sampling_alpha 0.5, warm-started from (c), without --speaker-to-id and
    the aux decoders (JAX's line raises there, ROADMAP §3): each epoch's
    rows the numpy draw."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.models.config_from_args import apply_arch
    from s2st_tpu_torch.models.jax_bridge import (load_jax_variables,
                                                  read_jax_checkpoint)
    from s2st_tpu_torch.tasks.s2s_translation import build_model_and_loss
    from s2st_tpu_torch.train import checkpoint as pckpt
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_paper_"))
    runs = {}
    try:
        data = work / "fbank"
        write_train_corpus(data, seed=21)
        stage1, stage2 = recipe_train_lines(
            "run_pretraining_torch", {"FEATURE_MANIFEST_ROOT": str(data),
                                      "SAVE_DIR": str(work / "pretrain")},
            work)
        runs["pretrain_stage1"] = run_paper_line(stage1, card,
                                                 "pretrain_stage1")
        with CheckWarmStart() as warm:
            runs["pretrain_stage2"] = run_paper_line(stage2, card,
                                                     "pretrain_stage2")
        print(f"paper pretrain_stage2: {warm.leaves} encoder parameter "
              f"arrays equal stage 1's checkpoint_last.npz bit for bit "
              f"before the first update ({card})", flush=True)
        shutil.rmtree(work / "pretrain")

        wave = work / "wave"
        write_hubert_corpus(wave, seed=22)
        header, *rows = (wave / "train.tsv").read_text().splitlines()
        for name, part in PAPER_CORPORA:
            (wave / f"{name}.tsv").write_text(
                "\n".join([header] + rows[part]) + "\n")
        with open(wave / "config.yaml", "a") as f:
            f.write(f"sampling_alpha: {PAPER_ALPHA}\n")
        pt = work / "hubert_base.pt"
        trunk = write_hubert_pt(pt, seed=23)
        st, finetune = recipe_train_lines(
            "run_mix_tuning_torch", {"FEATURE_MANIFEST_ROOT": str(wave),
                                     "SAVE_DIR": str(work / "mix"),
                                     "hubert_path": str(pt)}, work)
        runs["mix_st_pretrain"] = run_paper_line(st, card, "mix_st_pretrain")
        ckpt = work / "mix" / "st_pretrain" / "checkpoint_last.npz"
        args = apply_arch(train.get_parser().parse_args(st), st)
        dicts = [Dictionary.load(str(wave / f)) for f in ("src_vocab.txt",
                                                          "tgt_vocab.txt")]
        _, model, _ = build_model_and_loss(args, len(dicts[0]),
                                           len(dicts[1]), 80)
        model.encoder.hubert.carry_pretraining(
            {k: tuple(v.shape) for k, v in trunk.items()})
        load_jax_variables(model, read_jax_checkpoint(str(ckpt))[0])
        frontend = model.encoder.hubert.state_dict()
        flat = pckpt.load_checkpoint_file(str(ckpt))[0]
        hub = [k for k in flat if k.startswith("params::hubert::")]
        if set(frontend) != set(trunk) or not all(
                torch.equal(frontend[k], trunk[k]) for k in trunk) or any(
                flat[pckpt.opt_key(m, k)].any() for k in hub
                for m in ("mu", "nu")):
            raise AssertionError("mix_st_pretrain: the frontend moved or its "
                                 "Adam moments are not 0")
        print(f"paper mix_st_pretrain: the frontend's {len(hub)} parameter "
              f"arrays bit-unchanged over {PAPER_UPDATES} updates, their "
              f"Adam moments 0 ({card})", flush=True)
        del model, flat

        # JAX's line raises (ROADMAP §3): the S2T encoder has no aux norms
        # and no speaker table, and one --speaker-embed-dim cannot size
        # both speaker tables at these widths
        i = finetune.index("--speaker-to-id")
        finetune = finetune[:i] + finetune[i + 2:]
        with CheckWarmStart() as warm, RecordDraws() as draws:
            runs["mix_finetune"] = run_paper_line(
                finetune, card, "mix_finetune",
                ("--asr-ce-weight", "0", "--st-ce-weight", "0"))
        want = numpy_draws(wave, PAPER_UPDATES)
        if [sorted(b) for b in draws.batches] != [sorted(w) for w in want]:
            raise AssertionError(f"mix_finetune: the epochs' rows "
                                 f"{draws.batches} are not numpy's draws "
                                 f"{want}")
        print(f"paper mix_finetune: {warm.leaves} encoder arrays warm-"
              f"started from mix_st_pretrain bit for bit; epochs 1-"
              f"{PAPER_UPDATES} took numpy's draws of train_fisher,train_mls "
              f"(alpha {PAPER_ALPHA}): {[len(b) for b in draws.batches]} "
              f"rows ({card})", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"paper recipes phase: {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    return runs


# --------------------------------------------------------------------------
# phase 22: the train CLI's left-outs (host overlap, every optimizer and
# schedule, logging and diagnostics), streaming HiFi-GAN and
# recipes/valide_during_train_torch.sh
# --------------------------------------------------------------------------

# 22(a)'s corpus: 128 utterances of phase 13's timing lengths, which
# --max-tokens 60000 cuts into 2 recipe-size batches an epoch
OVERLAP_FRAMES = RECIPE_BATCH_FRAMES[:128]
OVERLAP_UPDATES = 8
LR0 = 1.5e-3                      # the recipe's --lr
# 22(b): each optimizer under one of the schedules the JAX CLI can build
# (each schedule at least once), 3 updates, and the rate each update must
# take, from the schedule's formula with the flags given
# (s2st_tpu/train/optim.py:39-224, called at the 1-based update n)
OPTIMIZER_RUNS = (
    ("adam", "reduce_lr_on_plateau", ("--warmup-updates", "4")),
    ("adafactor", "fixed", ("--warmup-updates", "4")),
    ("sgd", "step", ("--warmup-updates", "2")),
    ("adagrad", "triangular", ()),
    ("adadelta", "pass_through", ()),
    ("adamax", "manual", ("--update2lr", "{'2': 5e-4}")),
    ("nag", "fixed", ("--warmup-updates", "4")),
    ("lamb", "step", ("--warmup-updates", "2")),
    ("rmsprop", "triangular", ()),
)
SCHEDULE_LR = {
    "fixed": lambda n: LR0 * min((n + 1) / 4, 1.0),
    "reduce_lr_on_plateau": lambda n: LR0 * min((n + 1) / 4, 1.0),
    "step": lambda n: LR0 * min(n / 2, 1.0) * 0.5 ** math.floor(n / 50000),
    "triangular": lambda n: LR0 + 9 * LR0 * (1 - abs((n / 5000) % 2 - 1)),
    "pass_through": lambda n: LR0,
    # update2lr {2: 5e-4}: from the update that follows 2 done
    "manual": lambda n: 5e-4 if n - 1 >= 2 else LR0,
}
# 22(b): card vs CPU, one fp32 update of phase 7's model; see
# optimizer_agreement
TOL_OPT_AGREEMENT = (1e-6, 1e-5)
# 22(e): streaming against whole-sequence synthesis away from the ends
TOL_STREAM = 1e-5


def leftout_argv(data: Path, save: Path, max_update: int, *extra) -> list:
    """The recipe's stage-5 line (phase 6's flags, --fp16) with the
    kernels' configuration (--use-flash-attention --attention-dropout 0)."""
    return recipe_train_argv(data, save, max_update) + [
        "--use-flash-attention", "--attention-dropout", "0", *extra]


class TimedCollate:
    """Each collate's host ms (in whichever thread collates it)."""

    def __enter__(self):
        from s2st_tpu_torch.data.iterators import EpochBatchIterator
        self.cls, self.fn, self.ms = EpochBatchIterator, \
            EpochBatchIterator.collate, []
        rec = self

        def collate(itr, indices):
            t0 = time.perf_counter()
            out = rec.fn(itr, indices)
            rec.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        EpochBatchIterator.collate = collate
        return self

    def __exit__(self, *exc):
        self.cls.collate = self.fn


def overlap_run(data: Path, save: Path, workers: int, card: str,
                label: str, *extra, max_update=OVERLAP_UPDATES) -> dict:
    """One run of 22(a): the log's losses and grad norms, ms an update
    (the loop's wait for its batches plus the synchronised step), the wait
    and each collate's host ms, and the device ms and idle share of the
    sixth update under torch.profiler."""
    from s2st_tpu_torch.train.trainer import Trainer
    orig, prof = Trainer.train_step, {}

    def step(self, *a, **k):
        if self.step != 5:
            return orig(self, *a, **k)
        out, wall, busy, n, _ = _profiled(lambda: orig(self, *a, **k),
                                          host_events=False)
        prof.update(wall_ms=wall, device_ms=busy, activities=n)
        return out

    argv = leftout_argv(data, save, max_update, "--num-workers",
                        str(workers), *extra)
    Trainer.train_step = step
    try:
        with TimedCollate() as col:
            run = run_train_cli(argv, save, card, label)
    finally:
        Trainer.train_step = orig
    log = [json.loads(line) for line in
           (save / "log.jsonl").read_text().splitlines()]
    # past the first update, and not the profiled one
    steady = [r for r in log if r["num_updates"] not in (1, 6)]
    run.update(
        log=[(r["num_updates"], r["loss"], r["gnorm"]) for r in log],
        update_ms=sum(r["data_ms"] + r["step_ms"] for r in steady)
        / len(steady),
        wait_ms=sum(r["data_ms"] for r in steady) / len(steady),
        collate_ms=sum(col.ms) / len(col.ms), collates=len(col.ms))
    if prof:
        if prof["device_ms"] <= 0:
            raise AssertionError(f"{label}: the profiler saw no device time")
        run["profile"] = dict(prof, idle=1 - prof["device_ms"]
                              / prof["wall_ms"])
    return run


def host_overlap(work: Path, card: str) -> dict:
    """22(a): --num-workers 1 and 4 on the recipe's batches, losses and
    grad norms equal bit for bit (deterministic algorithms on); then a run
    stopped at update 3, in the middle of epoch 2, saved and resumed under
    --num-workers 4, whose updates must be the uninterrupted run's."""
    from s2st_tpu_torch.data.iterators import batch_by_size, ordered_indices
    data = work / "overlap"
    write_train_corpus(data, seed=24, frames=OVERLAP_FRAMES)
    lengths = np.asarray(OVERLAP_FRAMES)
    sizes = [len(b) for b in batch_by_size(
        ordered_indices(lengths, True, 1, 1), lengths, 60000, None, 8)]
    if len(sizes) != 2:
        raise AssertionError(f"22(a): batches {sizes}; want 2 an epoch")
    runs = {}
    with Deterministic():
        for w in (1, 4):
            runs[w] = overlap_run(data, work / f"w{w}", w, card,
                                  f"overlap_workers{w}", "--no-save")
        save = work / "resume"
        first = overlap_run(data, save, 4, card, "overlap_resume_first",
                            "--save-interval-updates", "3",
                            "--no-epoch-checkpoints", max_update=3)
        meta = json.loads(bytes(np.load(save / "checkpoint_2_3.npz")[
            "__meta__"]).decode())
        (save / "log.jsonl").rename(save / "log_first.jsonl")
        # to the end of epoch 4 (update 8), which a run stopped by
        # --max-update would save as the middle of an epoch
        second = overlap_run(data, save, 4, card, "overlap_resume_second",
                             "--save-interval", "2", "--keep-last-epochs",
                             "2", "--max-epoch", "4", max_update=100)
    if runs[1]["log"] != runs[4]["log"] or \
            len(runs[1]["log"]) != OVERLAP_UPDATES:
        raise AssertionError(f"22(a): --num-workers 1 and 4 differ: "
                             f"{runs[1]['log']} vs {runs[4]['log']}")
    if meta["iterator"]["iterations_in_epoch"] != 1:
        raise AssertionError(f"22(a): the mid-epoch save counts "
                             f"{meta['iterator']} consumed batches; want "
                             f"1 of epoch 2")
    if first["log"] + second["log"] != runs[4]["log"]:
        raise AssertionError(f"22(a): the resumed run's updates "
                             f"{first['log'] + second['log']} are not the "
                             f"uninterrupted run's {runs[4]['log']}")
    for w in (1, 4):
        r = runs[w]
        print(f"overlap --num-workers {w}: {r['update_ms']:.3f} ms an "
              f"update (updates 2-{OVERLAP_UPDATES}; the loop waited "
              f"{r['wait_ms']:.3f} ms of it for its batches), collate "
              f"{r['collate_ms']:.3f} host ms a batch ({r['collates']} "
              f"batches of {sizes}), update 6 under torch.profiler: device "
              f"{r['profile']['device_ms']:.3f} ms of "
              f"{r['profile']['wall_ms']:.3f} ms wall, idle share "
              f"{r['profile']['idle']:.3f} (deterministic algorithms on) "
              f"({card})", flush=True)
    parts = collate_breakdown(data)
    print(f"overlap: one batch of {parts['rows']} utterances on the host, "
          f"best of 3: the items (features read, CMVN, SpecAugment) "
          f"{parts['items_ms']:.3f} ms, the whole collate "
          f"{parts['collate_ms']:.3f} ms, with pinning "
          f"{parts['pinned_ms']:.3f} ms ({card})", flush=True)
    print(f"overlap: --num-workers 1 and 4 gave the same {OVERLAP_UPDATES} "
          f"losses and grad norms bit for bit; stopped at update 3 (1 "
          f"batch into epoch 2) and resumed under --num-workers 4, the run "
          f"took the uninterrupted run's updates bit for bit ({card})",
          flush=True)
    return {"runs": runs, "resume": [first, second], "batches": sizes,
            "save_dir": save, "data": data, "collate": parts}


def collate_breakdown(data: Path) -> dict:
    """Host ms of 22(a)'s first batch in this thread, best of 3: its items
    alone, the whole collate, and the collate into pinned memory."""
    from s2st_tpu_torch.data.data_cfg import S2STDataConfig
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.data.iterators import EpochBatchIterator
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit
    dicts = [Dictionary.load(str(data / f)) for f in ("src_vocab.txt",
                                                      "tgt_vocab.txt")]
    split = TrainSplit(str(data), S2STDataConfig(data / "config.yaml"),
                       "train", *dicts, n_frames_per_step=4)
    out = {}
    for name, pin in (("collate_ms", False), ("pinned_ms", True)):
        itr = EpochBatchIterator(split, 60000, required_batch_size_multiple=8,
                                 pin_memory=pin)
        idx = itr.batches_for_epoch(1)[0]
        times = {"items_ms": [], name: []}
        for _ in range(3):
            t0 = time.perf_counter()
            [itr.fetch_item(int(i)) for i in idx]
            t1 = time.perf_counter()
            itr.collate(idx)
            t2 = time.perf_counter()
            times["items_ms"].append((t1 - t0) * 1e3)
            times[name].append((t2 - t1) * 1e3)
        out.update({k: min(v) for k, v in times.items()}, rows=len(idx))
    return out


def optimizer_agreement(name: str, card: str) -> dict:
    """22(b): one fp32 update with dropout off of phase 7's model (2 + 2
    layers at the recipe's widths) under ``name``, on the card (kernels)
    and on the CPU (plain versions), from one init, no clipping.

    Tolerance (TOL_OPT_AGREEMENT, 1e-6 + 1e-5 |p|), in three parts:
    - where the CPU's gradient is steady (above 1e-4 of its leaf's largest
      magnitude and, divided by the sample size, above 100 eps, in a leaf
      whose largest gradient is above 1e-3 of the largest of all), each
      parameter after the update, card vs CPU;
    - everywhere, the card's update vs the CPU's optimizer taking the
      card's own gradients from the same init: the optimizer alone;
    - where the gradient is not steady, the card's gradient within that
      element's steadiness threshold of the CPU's: both are noise there.
    The parameters themselves are not compared where the gradient is
    noise: a leaf whose gradient is 0 in exact arithmetic (a conv bias
    before a batch norm; an attention key bias, which shifts each softmax
    row by a constant) gets fp32 rounding noise on each device, and the
    first step is g / (|g| + eps) there (Adam's inside lamb; adafactor's
    unfactored v = g^2 + 1e-30), anywhere in [-lr, lr] on each side
    depending on how the noise compares with eps."""
    from s2st_tpu_torch.data.s2st_dataset import collate, to_device
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from s2st_tpu_torch.train.losses import LossConfig
    from s2st_tpu_torch.train.optim import fixed_schedule
    from s2st_tpu_torch.train.trainer import Trainer
    cfg = recipe_config().replace(
        encoder_layers=2, decoder_layers=2, middle_layers=(0, 1), ctc=True,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
        prenet_dropout=0.0, postnet_dropout=0.0)
    lcfg = LossConfig(label_smoothing=0.1, ctc_weight=0.3, asr_ce_weight=0.3,
                      st_ce_weight=0.3)
    r = np.random.RandomState(5)
    items = [{"index": i,
              "src_speech": r.randn(n, 80).astype(np.float32),
              "tgt_speech": r.randn(n // 5, 320).astype(np.float32),
              "src_text": np.append(r.randint(4, 100, n // 10), 2),
              "tgt_text": np.append(r.randint(4, 100, n // 20), 2)}
             for i, n in enumerate((240, 200, 150))]
    batch = collate(items)
    cpu = S2STTransformer(cfg).init_weights(9)
    dev = copy.deepcopy(cpu).to("cuda")
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    results = []
    lrs = []
    for model, b in ((cpu, batch), (dev, to_device(batch, "cuda"))):
        tr = Trainer(model, lcfg, fixed_schedule(LR0), optimizer=name,
                     optimizer_kw={})
        grads, step = {}, tr.optimizer.step

        def spy(gs, lr, step=step, model=model, grads=grads):
            # the gradients the optimizer sees (over the sample size)
            for (n, _), g in zip(model.named_parameters(), gs):
                grads[n] = g.detach().cpu().clone()
            lrs.append(lr)
            return step(gs, lr)
        tr.optimizer.step = spy
        met = tr.train_step(b)
        results.append((met, grads, {n: p.detach().cpu().clone()
                                     for n, p in model.named_parameters()}))
    (m_c, g_c, p_c), (m_d, g_d, p_d) = results
    # the CPU's optimizer on the card's gradients, from the same init
    ref = copy.deepcopy(cpu)
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(before[n])
    opt = Trainer(ref, lcfg, fixed_schedule(LR0), optimizer=name,
                  optimizer_kw={}).optimizer
    opt.step([g_d[n] for n, _ in ref.named_parameters()], lrs[1])
    p_r = {n: p.detach().clone() for n, p in ref.named_parameters()}
    atol, rtol = TOL_OPT_AGREEMENT
    worst = worst_opt = worst_noise = 0.0
    noisy = 0
    g_top = max(float(g.abs().max()) for g in g_c.values())
    for n in p_c:
        g = g_c[n].abs()
        leaf_steady = bool(g.max() > 1e-3 * g_top)
        steady = (g > 1e-4 * g.max()) & (g > 100 * 1e-8) & leaf_steady
        tol = atol + rtol * p_c[n].abs()
        dp = (p_d[n] - p_c[n]).abs()
        if bool((dp > tol)[steady].any()):
            raise AssertionError(f"22(b) {name}: {n} differs by "
                                 f"{float(dp[steady].max()):.3e} after one "
                                 f"update where its gradient is steady")
        if steady.any():
            worst = max(worst, float(dp[steady].max()))
        do = (p_d[n] - p_r[n]).abs()
        if bool((do > atol + rtol * p_r[n].abs()).any()):
            raise AssertionError(f"22(b) {name}: {n}'s update on the card "
                                 f"differs by {float(do.max()):.3e} from "
                                 f"the CPU optimizer's on the same "
                                 f"gradients")
        worst_opt = max(worst_opt, float(do.max()))
        # below steady, the gradient is within its threshold on both sides
        thr = torch.full_like(g, 1e-3 * g_top) if not leaf_steady else \
            torch.clamp(1e-4 * g.max(), min=100 * 1e-8).expand_as(g)
        dg = (g_d[n] - g_c[n]).abs()
        if bool((dg > thr)[~steady].any()):
            raise AssertionError(f"22(b) {name}: {n}'s gradient on the card "
                                 f"is {float(dg[~steady].max()):.3e} from "
                                 f"the CPU's where the CPU's is noise")
        if (~steady).any():
            worst_noise = max(worst_noise, float(dg[~steady].max()))
        noisy += int((~steady).sum())
    rel = abs(m_d["loss"] - m_c["loss"]) / abs(m_c["loss"])
    if rel > 1e-4:
        raise AssertionError(f"22(b) {name}: loss {m_d['loss']} vs "
                             f"{m_c['loss']}")
    print(f"optimizer agreement {name}: card vs CPU (fp32, one update of "
          f"phase 7's model): loss rel {rel:.2e}, worst param error "
          f"{worst:.2e} where the gradient is steady (tolerance {atol} + "
          f"{rtol} |p|); the card's update vs the CPU optimizer's on the "
          f"card's gradients {worst_opt:.2e} over every element (same "
          f"tolerance); {noisy} elements of noise gradient, the card's "
          f"within {worst_noise:.2e} of the CPU's there ({card})", flush=True)
    return {"param_max_abs_err": worst, "loss_rel": rel,
            "optimizer_max_abs_err": worst_opt, "noise_elements": noisy,
            "noise_grad_max_abs_err": worst_noise}


def optimizer_runs(work: Path, card: str) -> dict:
    """22(b): each of the 9 optimizers for 3 updates through the train CLI
    under a schedule the JAX CLI builds; each update's loss finite and its
    rate the schedule's; adafactor and lamb held card vs CPU."""
    data = work / "small"
    write_train_corpus(data, seed=25)
    out = {}
    for opt, sched, flags in OPTIMIZER_RUNS:
        save = work / f"opt_{opt}"
        run = run_train_cli(leftout_argv(
            data, save, 3, "--no-save", "--optimizer", opt,
            "--lr-scheduler", sched, *flags), save, card, f"optimizer_{opt}")
        log = [json.loads(line) for line in
               (save / "log.jsonl").read_text().splitlines()]
        want = [SCHEDULE_LR[sched](n) for n in (1, 2, 3)]
        got = [r["lr"] for r in log]
        if len(got) != 3 or any(abs(a - b) > 1e-12 * b
                                for a, b in zip(got, want)):
            raise AssertionError(f"22(b) {opt} under {sched}: rates {got}; "
                                 f"want {want}")
        out[opt] = dict(run, schedule=sched, lrs=got)
    print("optimizers: " + "; ".join(
        f"{o} ({r['schedule']}) losses "
        f"{[round(x, 4) for x in r['losses']]} rates {r['lrs']}"
        for o, r in out.items()) + f" ({card})", flush=True)
    for name in ("adafactor", "lamb"):
        out[name]["agreement"] = optimizer_agreement(name, card)
    return out


class CollectLogs(logging.Handler):
    """The port's log records (its package logger), while a run lasts."""

    def __enter__(self):
        super().__init__(logging.INFO)
        self.records = []
        self.pkg = logging.getLogger("s2st_tpu_torch")
        self.pkg.addHandler(self)
        return self

    def emit(self, record):
        self.records.append(record)

    def __exit__(self, *exc):
        self.pkg.removeHandler(self)


def diagnostics_run(work: Path, card: str) -> dict:
    """22(c): --log-format json, --tensorboard-logdir, --profile and
    --heartbeat-timeout 600 on 3 updates within the first epoch (batches
    of 2): the json lines parse with JAX's keys; TensorBoard writes events
    or, where it is absent, JAX's warning is logged; the profiler's trace
    holds the attention kernels by their symbols, as many launches as the
    port's counters report (a forward flash_fwd_* a forward call, an
    attn_bwd_dq_* and an attn_bwd_dkdv_* a backward call)."""
    import importlib.util
    from s2st_tpu_torch.utils import diagnostics
    data = work / "small"
    save = work / "diag"
    trace = Path(diagnostics.PROFILE_DIR) / "trace.json"
    if trace.exists():
        trace.unlink()
    with CollectLogs() as logs:
        run = run_train_cli(leftout_argv(
            data, save, 3, "--batch-size", "2", "--no-save", "--profile",
            "--heartbeat-timeout", "600"), save, card, "diagnostics")
    msgs = [r.getMessage() for r in logs.records
            if r.name == "s2st_tpu_torch.logging_utils"]
    inner = [json.loads(m) for m in msgs if m.startswith(
        '{"train_inner_')]
    if len(inner) != 3 or any("train_inner_gnorm" not in x for x in inner):
        raise AssertionError(f"22(c): json lines {msgs[:4]}")
    has_tb = importlib.util.find_spec("tensorboard") is not None
    events = list((save / "tb").glob("events.*"))
    warned = "tensorboard unavailable; skipping event logs" in msgs
    if (has_tb and not events) or (not has_tb and not warned):
        raise AssertionError(f"22(c): tensorboard installed {has_tb}, "
                             f"events {events}, warning {warned}")
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if str(e.get("cat", "")).lower() == "kernel"]
    counts = {sym: sum(sym in n for n in names)
              for sym in ("flash_fwd", "attn_bwd_dq", "attn_bwd_dkdv")}
    want = {"flash_fwd": run["fwd_launches"],
            "attn_bwd_dq": run["bwd_launches"],
            "attn_bwd_dkdv": run["bwd_launches"]}
    if counts != want or not run["fwd_launches"]:
        raise AssertionError(f"22(c): the trace holds {counts} kernel "
                             f"launches; the counters say {want}")
    mb = trace.stat().st_size / 1e6
    shutil.rmtree(diagnostics.PROFILE_DIR, ignore_errors=True)
    print(f"diagnostics: 3 json train_inner lines; tensorboard "
          f"{'events written' if has_tb else 'absent: JAX warning logged'};"
          f" the --profile trace ({mb:.1f} MB, {len(names)} kernel "
          f"launches) holds {counts} attention launches, the counters' "
          f"(heartbeat 600 s) ({card})", flush=True)
    return dict(run, trace_counts=counts, tensorboard=has_tb)


def streaming_hifigan(work: Path, card: str) -> dict:
    """22(e): synthesize_streaming (64-frame chunks, the receptive field's
    margin) on phase 19's seeded HiFi-GAN at config_v1's width against the
    whole-sequence synthesis, on a batch of 4 log-mel sequences of 400
    frames: within TOL_STREAM from the receptive field in from each end
    (cuDNN may pick another algorithm for a chunk's shape); the ends
    differ by design, since the chunks' zero mel frames are not the whole
    sequence's zero activations."""
    from s2st_tpu_torch.models.hifigan import (HiFiGANConfig,
                                               HiFiGANGenerator,
                                               load_torch_generator,
                                               receptive_field_frames,
                                               synthesize_streaming)
    write_hifigan_v1(work, seed=26)
    cfg = HiFiGANConfig.from_json(HIFIGAN_V1)
    gen = HiFiGANGenerator(cfg)
    gen.load_state_dict(load_torch_generator(str(work / "g_hifigan_v1.pt"),
                                             cfg))
    gen = gen.cuda().eval()
    x = torch.from_numpy(np.random.RandomState(26).randn(4, 400, 80)
                         .astype(np.float32) * 2.0 - 5.0).cuda()
    rf, up = receptive_field_frames(cfg), int(np.prod(cfg.upsample_rates))
    with torch.inference_mode():
        whole = gen(x)
        chunked = synthesize_streaming(gen, x, chunk_frames=64)
        err = (whole - chunked).abs()
        inner = float(err[:, rf * up:-rf * up].max())
        edge = float(err.max())
        ms = {"whole": device_ms(lambda: gen(x), iters=3),
              "streaming": device_ms(
                  lambda: synthesize_streaming(gen, x, chunk_frames=64),
                  iters=3)}
    if chunked.shape != whole.shape or not bool(
            torch.isfinite(chunked).all()) or inner > TOL_STREAM:
        raise AssertionError(f"22(e): streaming {tuple(chunked.shape)} vs "
                             f"{tuple(whole.shape)}, max abs err {inner} "
                             f"away from the ends")
    print(f"streaming hifigan: {tuple(x.shape)} mel in 64-frame chunks "
          f"with {rf} frames of margin: max abs err {inner:.3e} from "
          f"{rf} frames in (tolerance {TOL_STREAM}), {edge:.3e} at the "
          f"ends; device {ms['streaming']:.3f} ms streaming vs "
          f"{ms['whole']:.3f} ms whole ({card})", flush=True)
    return {"max_abs_err": inner, "edge_max_abs_err": edge, "ms": ms}


def valide_during_train(work: Path, overlap: dict, card: str) -> dict:
    """22(f): recipes/valide_during_train_torch.sh on 22(a)'s resumed run
    (its epoch checkpoints 2 and 4): the average of the two files (their
    numpy mean), then generate_waveform on the card on the corpus's tst
    split through ``counted_module`` (a ``python`` on its PATH): PCM16
    WAVs of hop x frames samples, 12 kernel launches a batch, each
    distinct call held."""
    from s2st_tpu_torch.train.checkpoint import load_checkpoint_file
    save, data = overlap["save_dir"], overlap["data"]
    shim = work / "valide_bin"
    shim.mkdir()
    counts = work / "valide_counts.jsonl"
    # the average is numpy alone: only generate_waveform is counted
    (shim / "python").write_text(
        f'#!/bin/sh\nif [ "$2" = s2st_tpu_torch.cli.average_checkpoints ]; '
        f'then exec "{sys.executable}" "$@"; fi\n'
        f'exec "{sys.executable}" "{REPO / "chip_smoke.py"}" '
        f'--counted "{counts}" "$@"\n')
    (shim / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{shim}:{os.environ['PATH']}",
               PYTHONPATH=str(REPO), SAVE_DIR=str(save),
               FEATURE_MANIFEST_ROOT=str(data), SPLIT="tst",
               num_epoch_checkpoints="2", middle_layers="4,9")
    env.pop("AUDIO_MANIFEST_ROOT", None)
    t0 = time.perf_counter()
    res = subprocess.run(
        ["bash", str(REPO / "recipes" / "valide_during_train_torch.sh")],
        env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"valide_during_train_torch.sh returned "
                             f"{res.returncode}:\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    gen_rec, = [json.loads(line) for line in
                counts.read_text().splitlines()]
    avg, _ = load_checkpoint_file(str(save / "checkpoint_last_avg2.npz"))
    pair = [load_checkpoint_file(str(save / f"checkpoint{e}.npz"))[0]
            for e in (2, 4)]
    for k, v in avg.items():
        if k.startswith("params::") and not np.array_equal(
                v, np.mean([pair[0][k].astype(np.float64),
                            pair[1][k].astype(np.float64)],
                           axis=0).astype(v.dtype)):
            raise AssertionError(f"22(f): {k} is not the mean of "
                                 f"checkpoint2 and checkpoint4")
    del pair, avg
    dump = save / "dump_wav_tst_valid"
    timing = json.loads((dump / "timing.json").read_text())
    wavs = sorted((dump / "wav").glob("*_pred.wav"))
    if not wavs or gen_rec["launches"] != 12 * len(timing):
        raise AssertionError(f"22(f): {len(wavs)} WAVs, "
                             f"{gen_rec['launches']} launches for "
                             f"{len(timing)} batches")
    for wav in wavs:
        with wave.open(str(wav), "rb") as w:
            n, width = w.getnframes(), w.getsampwidth()
            pcm = np.frombuffer(w.readframes(n), "<i2")
        if width != 2 or n == 0 or n % 256 or not np.any(pcm):
            raise AssertionError(f"22(f): {wav.name}: {n} samples of "
                                 f"{width} bytes")
    print(f"valide_during_train_torch.sh: averaged checkpoint2 and "
          f"checkpoint4 (their numpy mean), then generate_waveform on the "
          f"card: {len(wavs)} PCM16 WAVs, {gen_rec['launches']} kernel "
          f"launches in {len(timing)} batch(es), each distinct call held "
          f"(max abs err {gen_rec['path_max_abs_err']}); {wall:.1f} s "
          f"({card})", flush=True)
    return {"launches": gen_rec["launches"],
            "path_max_abs_err": gen_rec["path_max_abs_err"]}


def train_leftouts_phase(card: str) -> dict:
    """22: the train CLI's left-outs at the recipe's width (12 + 6 layers,
    512-d, 4 heads, --fp16, seeded weights, --attention-dropout 0 so that
    the kernels are reached): (a) host overlap, (b) the optimizers and
    schedules, (c) logging and diagnostics, (d) every distinct attention
    call of (a)-(c), forward and backward, held against the plain version
    (the backward also refusing two wrong answers), (e) streaming
    HiFi-GAN, (f) recipes/valide_during_train_torch.sh."""
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_leftouts_"))
    try:
        with RecordAttention() as rf, RecordAttentionBwd() as rb:
            overlap = host_overlap(work, card)
            optimizers = optimizer_runs(work, card)
            diag = diagnostics_run(work, card)
        out = {"overlap": overlap["runs"], "optimizers": optimizers,
               "diagnostics": diag,
               "fwd_err": hold_path_attention(rf.calls, "train_leftouts",
                                              card),
               "bwd_err": hold_path_attention_bwd(rb.calls, "train_leftouts",
                                                  card)}
        rf.calls.clear()
        rb.calls.clear()
        out["streaming"] = streaming_hifigan(work, card)
        out["valide"] = valide_during_train(work, overlap, card)
        runs = [*overlap["runs"].values(), *overlap["resume"],
                *optimizers.values(), diag]
        out["fwd_launches"] = sum(r["fwd_launches"] for r in runs)
        out["bwd_launches"] = sum(r["bwd_launches"] for r in runs)
        if not out["fwd_launches"] or not out["bwd_launches"]:
            raise AssertionError("22: no attention kernel launched")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"train left-outs phase: {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)
    return out


# --------------------------------------------------------------------------
# phase 23: the other archs of the s2s_translation task: T2S (the paper's
# pseudo-label TTS) with its text-input serving, the MTL variant,
# xm_transformer and ConvTransformer
# --------------------------------------------------------------------------

ARCH_FLAGS = ("--config-yaml", "config.yaml", "--train-subset", "train",
              "--max-tokens", "60000", "--fp16", "--optimizer", "adam",
              "--lr", "1e-3", "--lr-scheduler", "inverse_sqrt",
              "--warmup-updates", "4000", "--clip-norm", "1.0", "--seed",
              "1", "--label-smoothing", "0.1")
ARCH_SERVE_STEPS = 30


def served_counted(label: str, card: str, serve) -> dict:
    """``serve()`` (a generate_waveform run in this process) with the
    attention kernel's count set to 0 just before and read just after,
    each distinct kernel call held against the plain version."""
    from s2st_tpu_torch.kernels import attention as ka
    ka.flash_attention.launches = 0
    with RecordAttention() as rec:
        serve()
        torch.cuda.synchronize()
        launches = ka.flash_attention.launches
    return {"launches": launches,
            "path_max_abs_err": hold_path_attention(rec.calls, label, card)}


def serve_t2s_text(data: Path, ckpt: Path, out: Path) -> None:
    """generate_waveform from a T2S checkpoint on the tst split's text:
    30 steps that never stop (threshold 1.5), a 64-iteration Griffin-Lim,
    bf16; finite (30, 80) features and 16 kHz PCM16 WAVs of 256 x 29
    samples."""
    from s2st_tpu_torch.cli import generate_waveform
    argv = [str(data), "--config-yaml", "config.yaml", "--gen-subset", "tst",
            "--path", str(ckpt), "--results-path", str(out), "--max-iter",
            str(ARCH_SERVE_STEPS), "--eos-prob-threshold", "1.5",
            "--spec-bwd-max-iter", "64", "--fp16", "--dump-waveforms",
            "--dump-features", "--device", "cuda"]
    if generate_waveform.main(argv) != 0:
        raise AssertionError("generate_waveform from the T2S checkpoint "
                             "failed")
    ids = [line.split("\t")[0] for line in
           (data / "tst.tsv").read_text().splitlines()[1:]]
    for uid in ids:
        feat = np.load(out / "feat" / f"{uid}_pred.npy")
        if feat.shape != (ARCH_SERVE_STEPS, 80) or \
                not np.isfinite(feat).all():
            raise AssertionError(f"T2S served {uid}: features {feat.shape} "
                                 f"not finite ({ARCH_SERVE_STEPS}, 80)")
        with wave.open(str(out / "wav" / f"{uid}_pred.wav"), "rb") as w:
            if (w.getsampwidth(), w.getnchannels(), w.getframerate(),
                    w.getnframes()) != (2, 1, 16000,
                                        256 * (ARCH_SERVE_STEPS - 1)):
                raise AssertionError(f"T2S served {uid}: not 16 kHz mono "
                                     f"PCM16 of {256 * (ARCH_SERVE_STEPS - 1)}"
                                     f" samples")


def check_frozen_trunk(ckpt: Path, trunk: dict, label: str,
                       card: str) -> None:
    """The xm_transformer's trunk (JAX's params::w2v) in its
    checkpoint_last.npz equals the .pt it was loaded from, bit for bit,
    and its Adam moments are 0."""
    from s2st_tpu_torch.models import hubert as hub
    from s2st_tpu_torch.models.jax_bridge import _to_jax, jax_layout
    from s2st_tpu_torch.train import checkpoint as pckpt
    holder = torch.nn.Module()
    holder.encoder = torch.nn.Module()
    with torch.device("meta"):
        holder.encoder.w2v_model = hub.HubertModel(hub.HubertConfig())
        holder.encoder.w2v_model.carry_pretraining(
            {k: tuple(v.shape) for k, v in trunk.items()})
    flat = pckpt.load_checkpoint_file(str(ckpt))[0]
    pre = "encoder.w2v_model."
    layout = jax_layout(holder)
    if {name[len(pre):] for name, _, _ in layout} != set(trunk):
        raise AssertionError(f"{label}: the trunk's entries are not the "
                             f".pt's")
    for name, key, kind in layout:
        if not np.array_equal(flat[key], _to_jax(trunk[name[len(pre):]],
                                                 kind)) or any(
                flat[pckpt.opt_key(m, key)].any() for m in ("mu", "nu")):
            raise AssertionError(f"{label}: {key} moved or its Adam "
                                 f"moments are not 0")
    print(f"arch {label}: the trunk's {len(layout)} arrays equal the "
          f"seeded hubert-base .pt bit for bit after {PAPER_UPDATES} "
          f"updates, their Adam moments 0 ({card})", flush=True)


def archs_phase(card: str) -> dict:
    """23: the s2s_translation task's other archs at full width, --fp16,
    seeded weights, --use-flash-attention --attention-dropout 0, 3 updates
    each through the train CLI in this process (``run_paper_line``: the
    kernels' counts set to 0 before the run and read after each update,
    which must launch exactly the attention calls its model holds; each
    distinct forward and backward call held against the plain version):
    (a) t2s_transformer at JAX's defaults (512-d, 3 conv layers of kernel
    5, 6 + 6 layers, 4 heads, FFN 2048, prenet 2 x 256, postnet 5 x 512,
    80-d frames, 1 a step) over phase 6's corpus's phone lines, then
    generate_waveform from its checkpoint on the tst split's text (6
    launches a batch, the text encoder's, each call held); (b)
    s2st_transformer_mtl under --task s2s_translation_mtl with the
    recipe's stage-5 flags and --ctc-weight 0.3 --ctc-weight-tgt 0.3
    (decoder tap 3): the target CTC term finite and above 0 each update,
    then stage 7's line on its checkpoint (12 launches a batch); (c)
    xm_transformer (hubert-base trunk from a seeded fairseq .pt, fp32 past
    its GroupNorm, 3 adaptor convs, 12 x 1024 decoder of 16 heads)
    --test-type st on phase 16's 16 WAVs, the trunk bit-unchanged with
    zero Adam moments; (d) convtransformer (6 + 6 layers, 512-d, 8 heads)
    and convtransformer_espnet (12 encoder layers, 4 heads) --test-type
    st. Prints each run's losses, ms an update, device ms and idle share
    of the third, peak memory and the launches."""
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_archs_"))
    train_runs, serve_runs = {}, {}
    try:
        data = work / "fbank"
        write_train_corpus(data, seed=231)
        argv = [str(data), "--save-dir", str(work / "t2s"), *ARCH_FLAGS,
                "--task", "s2s_translation", "--criterion", "t2s_loss",
                "--arch", "t2s_transformer"]
        train_runs["t2s"] = run_paper_line(argv, card, "t2s")
        serve_runs["t2s"] = served_counted("t2s_serve", card, lambda: (
            serve_t2s_text(data, work / "t2s" / "checkpoint_last.npz",
                           work / "t2s_served")))
        if serve_runs["t2s"]["launches"] != 6:
            raise AssertionError(f"T2S serving launched the kernel "
                                 f"{serve_runs['t2s']['launches']} times; "
                                 f"want 6 (one batch, 6 encoder layers)")
        print(f"arch t2s: served the tst split from text, "
              f"{ARCH_SERVE_STEPS} steps, features and WAVs checked, "
              f"{serve_runs['t2s']['launches']} kernel launches ({card})",
              flush=True)

        argv = recipe_train_argv(data, work / "mtl", PAPER_UPDATES)
        for flag, value in (("--task", "s2s_translation_mtl"),
                            ("--arch", "s2st_transformer_mtl"),
                            ("--criterion", "s2st_loss_mtl")):
            argv[argv.index(flag) + 1] = value
        argv += ["--ctc-weight", "0.3", "--ctc-weight-tgt", "0.3"]
        train_runs["mtl"] = run_paper_line(argv, card, "mtl")
        ctc_tgt = [json.loads(line)["ctc_loss_tgt"] for line in
                   (work / "mtl" / "log.jsonl").read_text().splitlines()]
        if not all(np.isfinite(x) and x > 0 for x in ctc_tgt):
            raise AssertionError(f"mtl: target CTC terms {ctc_tgt}")
        print(f"arch mtl: target CTC terms {ctc_tgt} ({card})", flush=True)
        serve_runs["mtl"] = served_counted("mtl_serve", card, lambda: (
            serve_from_checkpoint(work, data,
                                  work / "mtl" / "checkpoint_last.npz")))
        if serve_runs["mtl"]["launches"] != 12:
            raise AssertionError(f"MTL serving launched the kernel "
                                 f"{serve_runs['mtl']['launches']} times; "
                                 f"want 12")
        shutil.rmtree(work / "t2s")
        shutil.rmtree(work / "mtl")

        wav = work / "wave"
        write_hubert_corpus(wav, seed=232)
        pt = work / "hubert_base.pt"
        trunk = write_hubert_pt(pt, seed=233)
        argv = [str(wav), "--save-dir", str(work / "xm"), *ARCH_FLAGS,
                "--task", "s2s_translation", "--criterion", "s2t_loss",
                "--arch", "xm_transformer", "--test-type", "st",
                "--load-pretrained-hubert-from", str(pt)]
        train_runs["xm"] = run_paper_line(argv, card, "xm")
        check_frozen_trunk(work / "xm" / "checkpoint_last.npz", trunk, "xm",
                           card)
        shutil.rmtree(work / "xm")

        for arch in ("convtransformer", "convtransformer_espnet"):
            argv = [str(data), "--save-dir", str(work / arch), *ARCH_FLAGS,
                    "--task", "s2s_translation", "--criterion", "s2t_loss",
                    "--arch", arch, "--test-type", "st"]
            train_runs[arch] = run_paper_line(argv, card, arch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"archs phase: {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    return {"train": train_runs, "serve": serve_runs}


# --------------------------------------------------------------------------
# phase 24: the task's last arch families: Berard, Tacotron2, FastSpeech2
# --------------------------------------------------------------------------

TC2_GEN_STEPS = 40
TOL_LSTM_BF16 = 5e-2     # tanh-bounded outputs, bf16 state over 250 steps


def add_variance_columns(data: Path, seed: int) -> None:
    """FastSpeech2's columns in phase 6's TSVs: each phone's duration (the
    row's target frames cut at seeded points, so that they sum to them;
    the EOS token gets none), a seeded pitch in [0, 400) and energy in
    [0, 4) a phone."""
    r = np.random.RandomState(seed)
    for name in ("train.tsv", "tst.tsv"):
        lines = (data / name).read_text().splitlines()
        head = lines[0].split("\t")
        out = ["\t".join(head + ["duration", "pitch", "energy"])]
        for line in lines[1:]:
            row = dict(zip(head, line.split("\t")))
            n = len(row["src_text"].split())
            frames = int(row["tgt_n_frames"])
            cuts = np.sort(r.randint(0, frames + 1, n - 1))
            dur = np.diff(np.concatenate([[0], cuts, [frames]]))
            out.append("\t".join([line, " ".join(str(int(d)) for d in dur),
                                  " ".join(f"{x:.2f}" for x in
                                           r.uniform(0, 400, n)),
                                  " ".join(f"{x:.3f}" for x in
                                           r.uniform(0, 4, n))]))
        (data / name).write_text("\n".join(out) + "\n")


def lstm_card_check(card: str) -> dict:
    """The port's packed biLSTM layer at Berard's first layer on phase 6's
    batch (B=8, the conv pyramid's 250 down to 100 steps, 512 inputs, 256
    a direction) on the card in fp32 (cuDNN, TF32 off; atol 1e-4 over 250
    recurrent steps) and bf16 (its output in bf16; atol TOL_LSTM_BF16)
    against the CPU's fp32; each one's device ms (CUDA events)."""
    from s2st_tpu_torch.models.berard import BerardConfig, conv_lengths
    from s2st_tpu_torch.models.lstm import lstm_layer
    g = torch.Generator().manual_seed(243)
    lens = conv_lengths(BerardConfig(), torch.tensor(TRAIN_FRAMES))
    x = torch.randn(len(TRAIN_FRAMES), int(lens.max()), 512, generator=g)

    def weights():
        return [torch.rand(shape, generator=g) * 0.2 - 0.1
                for shape in ((1024, 512), (1024, 256), (1024,), (1024,))]
    fwd, rev = weights(), weights()
    with torch.no_grad():
        ref, _ = lstm_layer(x, lens, fwd, rev)
        out = {"T": int(lens.max()), "card": card}
        for dtype, tol in ((torch.float32, 1e-4),
                           (torch.bfloat16, TOL_LSTM_BF16)):
            xd, ld = x.cuda().to(dtype), lens.cuda()
            fd, rd = [w.cuda() for w in fwd], [w.cuda() for w in rev]
            got, _ = lstm_layer(xd, ld, fd, rd)
            name = str(dtype).split(".")[-1]
            err = float((got.float().cpu() - ref).abs().max())
            if got.dtype != dtype or not err <= tol:
                raise AssertionError(f"lstm_layer {name} on the card: "
                                     f"dtype {got.dtype}, max abs err "
                                     f"{err} (atol {tol})")
            out[name] = {"max_abs_err": err, "ms": time_ms(
                lambda: lstm_layer(xd, ld, fd, rd), iters=10, warmup=2)}
    print("lstm_check " + json.dumps(out), flush=True)
    return out


def tacotron2_generate_check(data: Path, ckpt: Path, card: str) -> dict:
    """generate_features of the trained Tacotron2 (fp32, TF32 off) on
    phase 6's 8 phone lines for TC2_GEN_STEPS steps against its own
    teacher-forced first step (both see a zero frame, zero states and the
    initial context; eval, no prenet dropout): EOS probability and
    attention within 1e-5; finite features of (8, steps, 80); ms a
    step."""
    from s2st_tpu_torch.data.s2st_dataset import TrainSplit, to_device
    from s2st_tpu_torch.models import tacotron2 as tc2
    from s2st_tpu_torch.models.config_from_args import build_model_config
    from s2st_tpu_torch.models.jax_bridge import read_jax_checkpoint
    from s2st_tpu_torch.tasks.s2s_translation import (data_config,
                                                      load_dictionaries)
    variables, meta = read_jax_checkpoint(str(ckpt))
    args = argparse.Namespace(**{**meta["args"], "fp16": False,
                                 "bf16": False})
    data_cfg = data_config(args)
    cfg = build_model_config(args, variables, 80)
    model = tc2.from_jax_variables(cfg, variables).cuda().eval()
    split = TrainSplit(str(data), data_cfg, "train",
                       *load_dictionaries(str(data), data_cfg))
    batch = to_device(split.collate([split.item(i) for i in
                                     range(len(split))]), "cuda")
    with torch.no_grad():
        tf = model(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = model.generate_features(batch["src_text"],
                                      batch["src_text_len"],
                                      max_iter=TC2_GEN_STEPS)
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TC2_GEN_STEPS
    errs = {"eos_prob": float((gen["eos_prob"][:, 0] - torch.sigmoid(
                tf["eos_out"][:, 0, 0].float())).abs().max()),
            "attn": float((gen["attn"][:, :, 0] - tf["attn"][:, :, 0])
                          .abs().max())}
    shape = tuple(gen["feature"].shape)
    if shape != (len(split), TC2_GEN_STEPS, 80) or \
            not torch.isfinite(gen["feature"]).all() or \
            not all(e <= 1e-5 for e in errs.values()):
        raise AssertionError(f"tacotron2 generate_features: {shape}, "
                             f"first step against teacher forcing {errs}")
    out = {"max_abs_err": errs, "ms_per_step": ms,
           "out_lens": gen["out_lens"].tolist()}
    print(f"tacotron2 generate_features: {TC2_GEN_STEPS} steps of 8 rows, "
          f"{ms:.3f} ms a step (host clock), first step against teacher "
          f"forcing {errs}, out_lens {out['out_lens']} ({card})",
          flush=True)
    return out


def serve_fs2_text(data: Path, ckpt: Path, out: Path) -> None:
    """generate_waveform from a FastSpeech2 checkpoint on the tst split's
    text, --duration-factor 1.0 --min-duration 1, bf16, a 32-iteration
    Griffin-Lim: finite 80-d features of at least a frame a token and 16
    kHz PCM16 WAVs of 256 x (frames - 1) samples."""
    from s2st_tpu_torch.cli import generate_waveform
    argv = [str(data), "--config-yaml", "config.yaml", "--gen-subset", "tst",
            "--path", str(ckpt), "--results-path", str(out),
            "--duration-factor", "1.0", "--min-duration", "1",
            "--spec-bwd-max-iter", "32", "--fp16", "--dump-waveforms",
            "--dump-features", "--device", "cuda"]
    if generate_waveform.main(argv) != 0:
        raise AssertionError("generate_waveform from the FastSpeech2 "
                             "checkpoint failed")
    lines = (data / "tst.tsv").read_text().splitlines()
    head = lines[0].split("\t")
    for line in lines[1:]:
        row = dict(zip(head, line.split("\t")))
        tokens = len(row["src_text"].split()) + 1
        feat = np.load(out / "feat" / f"{row['id']}_pred.npy")
        n = feat.shape[0]
        if feat.ndim != 2 or feat.shape[1] != 80 or n < tokens or \
                not np.isfinite(feat).all():
            raise AssertionError(f"FS2 served {row['id']}: features "
                                 f"{feat.shape} for {tokens} tokens")
        with wave.open(str(out / "wav" / f"{row['id']}_pred.wav"), "rb") as w:
            if (w.getsampwidth(), w.getnchannels(), w.getframerate(),
                    w.getnframes()) != (2, 1, 16000, 256 * (n - 1)):
                raise AssertionError(f"FS2 served {row['id']}: not 16 kHz "
                                     f"mono PCM16 of {256 * (n - 1)} "
                                     f"samples")
        timing = json.loads((out / "timing.json").read_text())
        print(f"fastspeech2 served {row['id']}: {tokens} tokens, {n} frames;"
              f" batches {timing}", flush=True)


def tts_archs_phase(card: str) -> dict:
    """24: the task's last arch families at full width, --fp16, seeded
    weights, 3 updates each through the train CLI in this process
    (``run_paper_line``; --use-flash-attention --attention-dropout 0):
    first the packed LSTM layer on the card (``lstm_card_check``); (a)
    s2t_berard at JAX's defaults (input MLP 256, 128; two (16, 3, 2)
    convs; 3 biLSTM layers of 256; 2 x 512 decoder; attention 128, the
    parser's value) --test-type st on phase 6's corpus: no attention
    kernel; (b) tacotron_2 at its defaults (512-d, 3 convs of kernel 5, a
    biLSTM, 2 x 1024 zoneout LSTMs, attention 128 with 32 location filters
    of 15, 80-d frames, 1 a step) with guided attention over phase 6's
    phone lines and target mels: no attention kernel; then
    ``tacotron2_generate_check``; (c) fastspeech2 at its defaults (4 + 4
    FFT layers, 256-d, 2 heads, FFN 1024, kernel 9) on the same lines with
    seeded duration, pitch and energy columns: 8 forward and 8 backward
    attention launches an update at D=128, each distinct call held; then
    generate_waveform from its checkpoint on the tst split's text (8
    launches a batch, each call held). Prints each run's losses, the
    second update's ms, the third's device ms and idle share, peak memory
    and the launches."""
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tts_"))
    train_runs, serve_runs = {}, {}
    try:
        lstm = lstm_card_check(card)
        data = work / "fbank"
        write_train_corpus(data, seed=241)
        add_variance_columns(data, seed=242)
        base = [str(data), *ARCH_FLAGS, "--task", "s2s_translation"]
        train_runs["berard"] = run_paper_line(
            base + ["--save-dir", str(work / "berard"), "--criterion",
                    "s2t_loss", "--arch", "s2t_berard", "--test-type", "st"],
            card, "berard")
        shutil.rmtree(work / "berard")
        train_runs["tacotron2"] = run_paper_line(
            base + ["--save-dir", str(work / "tacotron2"), "--criterion",
                    "tacotron2", "--arch", "tacotron_2",
                    "--use-guided-attention-loss"], card, "tacotron2")
        generate = tacotron2_generate_check(
            data, work / "tacotron2" / "checkpoint_last.npz", card)
        shutil.rmtree(work / "tacotron2")
        train_runs["fastspeech2"] = run_paper_line(
            base + ["--save-dir", str(work / "fs2"), "--criterion",
                    "fastspeech2", "--arch", "fastspeech2"],
            card, "fastspeech2")
        serve_runs["fastspeech2"] = served_counted(
            "fastspeech2_serve", card, lambda: serve_fs2_text(
                data, work / "fs2" / "checkpoint_last.npz",
                work / "fs2_served"))
        if serve_runs["fastspeech2"]["launches"] != 8:
            raise AssertionError(f"FastSpeech2 serving launched the kernel "
                                 f"{serve_runs['fastspeech2']['launches']} "
                                 f"times; want 8 (one batch, 4 + 4 layers)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"tts archs phase: {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    return {"train": train_runs, "serve": serve_runs, "lstm": lstm,
            "generate": generate}


# --------------------------------------------------------------------------
# phase 25: self-supervised speech training: HuBERT, CTC fine-tuning,
# wav2vec 2.0
# --------------------------------------------------------------------------

SSL_FLAGS = ("--train-subset", "train", "--fp16", "--max-tokens", "1300000",
             "--max-sample-size", "250000", "--min-sample-size", "32000",
             "--optimizer", "adam", "--lr", "5e-4", "--lr-scheduler",
             "inverse_sqrt", "--warmup-updates", "4000", "--clip-norm",
             "10.0", "--seed", "1")
SSL_UNITS = 500          # the base recipe's second-iteration k-means units
SSL_LETTERS = "abcdefghijklmnopqrstuvwxyz'"
SSL_DEV = 4              # the first 4 utterances, validated in one batch


def write_ssl_corpus(root: Path, seed: int) -> None:
    """Phase 16's 16 utterances (10 s down to 4 s, 16 kHz PCM16 noise) as
    a wav2vec manifest (``train.tsv``; ``dev.tsv`` the first 4), seeded
    k-means labels at 50 Hz from a 500-unit ``dict.km.txt`` and seeded
    letter transcripts (26 letters, ', | between words; ``dict.ltr.txt``),
    about 12 letters a second."""
    from s2st_tpu_torch.data.audio_utils import write_wav
    r = np.random.RandomState(seed)
    (root / "wavs").mkdir(parents=True)
    rows, km, ltr = [], [], []
    for i, n in enumerate(hubert_samples()):
        write_wav(str(root / "wavs" / f"utt{i}.wav"),
                  np.clip(r.randn(n) * 0.1, -1.0, 1.0), 16000)
        rows.append(f"utt{i}.wav\t{n}")
        km.append(" ".join(str(u) for u in r.randint(0, SSL_UNITS, n // 320)))
        words = [r.choice(list(SSL_LETTERS), r.randint(2, 9))
                 for _ in range(n * 12 // 16000 // 6)]
        ltr.append(" | ".join(" ".join(w) for w in words) + " |")
    for split, keep in (("train", slice(None)), ("dev", slice(0, SSL_DEV))):
        (root / f"{split}.tsv").write_text(
            "\n".join([str(root / "wavs"), *rows[keep]]) + "\n")
        (root / f"{split}.km").write_text("\n".join(km[keep]) + "\n")
        (root / f"{split}.ltr").write_text("\n".join(ltr[keep]) + "\n")
    (root / "dict.km.txt").write_text(
        "".join(f"{u} 1\n" for u in range(SSL_UNITS)))
    (root / "dict.ltr.txt").write_text(
        "".join(f"{c} 1\n" for c in SSL_LETTERS + "|"))


def ssl_phase(card: str) -> dict:
    """25: the three self-supervised speech tasks through the port's train
    CLI in this process (``run_paper_line``), at hubert-base /
    wav2vec2-base width (7 convs of 512, 12 post-LN layers of 768-d, 12
    heads, FFN 3072, pos_conv 128/16), --fp16 (the trunk computes in fp32
    past its GroupNorm, so the kernels take fp32), seeded weights, on
    ``write_ssl_corpus``'s 16 WAVs in batches of 8, 3 updates each, every
    distinct forward and backward kernel call held against the plain
    version: (a) hubert_pretraining --arch hubert (mask 0.8 x 10,
    final_dim 256, 500-unit labels at 50 Hz): 12 forward and 12 backward
    launches an update; (b) audio_finetuning --arch hubert_ctc --criterion
    ctc --labels ltr from (a)'s checkpoint_last.npz (--w2v-path) with
    --freeze-finetune-updates 1, --apply-mask and a channel mask,
    validated once after the third update on 4 utterances: 12 forward
    launches an update, 0 backward in the first and 12 in the second and
    third; the trunk equal to (a)'s bit for bit after the first update,
    the extractor (feature_grad_mult 0) after all three; the validation's
    c_errors, c_total, w_errors and w_total finite; (c) audio_pretraining
    --arch wav2vec2 --criterion wav2vec --quantize-targets
    --attention-dropout 0 (320 x 2 codebook, 100 negatives, final_dim
    256): 12 and 12 launches an update, the logged temp max(2 * 0.999995^n,
    0.5) for n = 0, 1, 2, checkpoint_last.npz's stats::num_updates 3.
    Prints each run's losses, the second update's ms, the third's device ms
    and idle share (for (b) also its device activities: the CTC loop's),
    peak memory, the launches and the kernels' dtype."""
    from s2st_tpu_torch.models.jax_bridge import _to_jax, jax_layout
    from s2st_tpu_torch.train import checkpoint as pckpt
    from s2st_tpu_torch.train.trainer import Trainer
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ssl_"))
    runs = {}
    try:
        data = work / "data"
        write_ssl_corpus(data, seed=251)
        base = [str(data), *SSL_FLAGS]
        runs["hubert"] = run_paper_line(
            base + ["--save-dir", str(work / "hubert"), "--task",
                    "hubert_pretraining", "--arch", "hubert", "--criterion",
                    "hubert", "--labels", "km", "--label-rate", "50"],
            card, "ssl_hubert", want=[(12, 12)] * PAPER_UPDATES)
        pre = work / "hubert" / "checkpoint_last.npz"
        pre_flat = pckpt.load_checkpoint_file(str(pre))[0]

        snaps, orig = {}, Trainer.train_step

        def snapshot(self, *a, **k):
            out = orig(self, *a, **k)
            if self.step == 1:
                sd = self.model.state_dict()
                snaps.update({key: _to_jax(sd[name], kind)
                              for name, key, kind in jax_layout(self.model)
                              if key.startswith("params::w2v::")})
            return out
        Trainer.train_step = snapshot
        try:
            runs["ctc"] = run_paper_line(
                base + ["--save-dir", str(work / "ctc"), "--task",
                        "audio_finetuning", "--arch", "hubert_ctc",
                        "--criterion", "ctc", "--labels", "ltr",
                        "--w2v-path", str(pre), "--freeze-finetune-updates",
                        "1", "--apply-mask", "--mask-channel-prob", "0.5",
                        "--mask-channel-length", "64", "--lr", "5e-5",
                        "--valid-subset", "dev", "--validate-interval",
                        "1000", "--validate-interval-updates",
                        str(PAPER_UPDATES)],
                card, "ssl_ctc", want=[(12, 0)] + [(12, 12)] * (
                    PAPER_UPDATES - 1),
                validate=True)
        finally:
            Trainer.train_step = orig
        run = runs["ctc"]
        if (run["fwd_launches"], run["bwd_launches"]) != (
                12 * (PAPER_UPDATES + 1), 12 * (PAPER_UPDATES - 1)):
            raise AssertionError(f"ssl_ctc: launches {run['fwd_launches']}, "
                                 f"{run['bwd_launches']}; want 12 an update "
                                 f"and 12 for the validation's one batch, "
                                 f"12 backward in updates 2 and 3")
        trunk = {key: key.replace("params::w2v::", "params::", 1)
                 for key in snaps}
        moved = [k for k, p in trunk.items() if not np.array_equal(
            snaps[k], pre_flat[p])]
        final = pckpt.load_checkpoint_file(
            str(work / "ctc" / "checkpoint_last.npz"))[0]
        extractor = [k for k in trunk if "::extractor::" in k]
        if len(trunk) < 200 or moved or not extractor or any(
                not np.array_equal(final[k], pre_flat[trunk[k]])
                for k in extractor) or int(final["stats::num_updates"]) != 3:
            raise AssertionError(f"ssl_ctc: the trunk moved in the frozen "
                                 f"update ({moved[:4]}) or the extractor "
                                 f"since, or the count is not 3")
        valid = run["valid"]
        keys = ("c_errors", "c_total", "w_errors", "w_total")
        if len(valid) != 1 or not all(np.isfinite(valid[0]["valid"][k])
                                      for k in keys):
            raise AssertionError(f"ssl_ctc: validations {valid}")
        print(f"ssl ctc: the trunk's {len(trunk)} arrays equal (a)'s "
              f"checkpoint bit for bit after the frozen update, the "
              f"extractor's after {PAPER_UPDATES}; validation "
              f"{ {k: valid[0]['valid'][k] for k in keys} } ({card})",
              flush=True)
        shutil.rmtree(work / "hubert")
        shutil.rmtree(work / "ctc")

        runs["wav2vec2"] = run_paper_line(
            base + ["--save-dir", str(work / "w2v"), "--task",
                    "audio_pretraining", "--arch", "wav2vec2", "--criterion",
                    "wav2vec", "--quantize-targets"],
            card, "ssl_wav2vec2", want=[(12, 12)] * PAPER_UPDATES)
        temps = [json.loads(line)["temp"] for line in
                 (work / "w2v" / "log.jsonl").read_text().splitlines()]
        want = [max(2.0 * 0.999995 ** n, 0.5) for n in range(PAPER_UPDATES)]
        count = int(pckpt.load_checkpoint_file(str(
            work / "w2v" / "checkpoint_last.npz"))[0]["stats::num_updates"])
        if any(abs(a - b) > 1e-6 * b for a, b in zip(temps, want)) or \
                count != PAPER_UPDATES:
            raise AssertionError(f"ssl_wav2vec2: temps {temps} (want "
                                 f"{want}), stats::num_updates {count}")
        print(f"ssl wav2vec2: temps {temps}, stats::num_updates {count} "
              f"({card})", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"ssl phase: {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    return runs


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
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--counted"]:         # phase 17's python, on its PATH
        return counted_module(Path(argv[1]), argv[2:])
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
    parser.add_argument("--convergence", action="store_true",
                        help="only run the full end-to-end gate on the card, "
                             "in fp32 and under --fp16")
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
    if args.convergence:
        return convergence_runs()
    sys.path.insert(0, str(REPO))
    import s2st_tpu_torch  # noqa: F401  (fails outside the repository)
    from s2st_tpu_torch.kernels import attention as ka
    from s2st_tpu_torch.models.s2st_transformer import subsampled_length
    # fp32 means fp32 here: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    lap_at = [t_start]

    def lap(phases: str) -> None:
        # each phase's wall, for the next cut of the script's depth
        now = time.perf_counter()
        print(f"wall of {phases}: {now - lap_at[0]:.1f} s", flush=True)
        lap_at[0] = now
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
    lap("start-up and the build")
    fwd = kernel_phase(card, main_lengths, train_lengths)
    serving = fwd["serving_encoder_self"]
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    # stage 7's WAVs, which stage 8 transcribes in phase 17
    stage7 = Path(tempfile.mkdtemp(prefix="chip_smoke_stage7_"))
    try:
        served = serve_phase(work, card)
        stage7_wavs = [Path(shutil.copy(p, stage7)) for p in
                       sorted((work / "out" / "wav").glob("*_pred.wav"))]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    agreement_phase(card)
    profile_phase(card)
    lap("kernel_phase to profile_phase")
    bwds = backward_phase(card, train_lengths)
    bwd = bwds["train_encoder_self"]
    trained = train_phase(card)
    try:
        train_agreement_phase(card)
        train_profile_phase(card, trained["data"])
        runtime = runtime_phase(card, trained["data"])
    finally:
        shutil.rmtree(trained["work"], ignore_errors=True)
    lap("backward_phase to runtime_phase")
    conv = conv_kernel_phase(card)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_text_"))
    try:
        text = text_serve_phase(work, card)
        text_agreement_phase(card)
        text_profile_phase(card, text)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    lap("conv_kernel_phase to text_profile_phase")
    s2t = s2t_phase(card)
    lap("s2t_phase")
    validation = validate_phase(card)
    lap("validate_phase")
    hubert_kernel = hubert_kernel_phase(card)
    hubert_agreement_phase(card)
    hubert = hubert_phase(card)
    try:
        asr = asr_phase(card, stage7_wavs)
    finally:
        shutil.rmtree(stage7, ignore_errors=True)
    lap("hubert_kernel_phase to asr_phase")
    gate = gate_phase(card)
    lap("gate_phase")
    prep = data_prep_phase(card)
    lap("data_prep_phase")
    search = search_phase(card)
    lap("search_phase")
    paper = paper_recipes_phase(card)
    lap("paper_recipes_phase")
    leftouts = train_leftouts_phase(card)
    lap("train_leftouts_phase")
    archs = archs_phase(card)
    lap("archs_phase")
    tts = tts_archs_phase(card)
    lap("tts_archs_phase")
    ssl = ssl_phase(card)
    lap("ssl_phase")
    for group in ("train", "serve"):
        archs[group].update(tts[group])

    a = trained["a"]
    shapes = attention_shapes({**fwd, **hubert_kernel,
                               "asr_stage8_D64_fp32": asr["kernel"]}, bwds)
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
            "generate_for_s2st_hubert": hubert["s2t_launches"],
            "stage8_asr": asr["launches"],
            "gate_fast_bf16": gate["launches"],
            "data_prep_train": prep["train"]["fwd_launches"],
            **{f"data_prep_serve_{k}": v["launches"]
               for k, v in prep["runs"].items()},
            **{f"search_{k}": search["s2t"][k]["launches"]
               for k in SEARCH_RUNS},
            "search_stage7_pt": search["s2t"]["stage7_pt_launches"],
            "train_save_sync": search["save"]["sync"]["fwd_launches"],
            "train_save_async": search["save"]["async"]["fwd_launches"],
            **{f"paper_{k}": v["fwd_launches"] for k, v in paper.items()},
            "train_leftouts": leftouts["fwd_launches"],
            "valide_during_train_serve": leftouts["valide"]["launches"],
            **{f"arch_{k}": v["fwd_launches"]
               for k, v in archs["train"].items()},
            **{f"arch_{k}_serve": v["launches"]
               for k, v in archs["serve"].items()},
            **{f"ssl_{k}": v["fwd_launches"] for k, v in ssl.items()}},
        "max_abs_err": serving["max_abs_err"],
        "path_max_abs_err": {
            "generate_for_s2st": s2t["path_max_abs_err"],
            "train_with_validation": validation["path_max_abs_err"],
            "hubert": hubert["path_max_abs_err"],
            "stage8_asr": asr["path_max_abs_err"],
            "gate_fast_bf16": gate["path_max_abs_err"],
            "data_prep_serve": prep["path_max_abs_err"],
            "search": search["s2t"]["path_max_abs_err"],
            "train_save_async": search["save"]["path_max_abs_err"],
            **{f"paper_{k}": v["fwd_err"] for k, v in paper.items()},
            "train_leftouts": leftouts["fwd_err"],
            "valide_during_train_serve": leftouts["valide"][
                "path_max_abs_err"],
            **{f"arch_{k}": v["fwd_err"] for k, v in archs["train"].items()},
            **{f"arch_{k}_serve": v["path_max_abs_err"]
               for k, v in archs["serve"].items()},
            **{f"ssl_{k}": v["fwd_err"] for k, v in ssl.items()}},
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
            "train_hubert": hubert["train_bwd_launches"],
            "gate_fast_bf16": gate["bwd_launches"],
            "train_save_sync": search["save"]["sync"]["bwd_launches"],
            "train_save_async": search["save"]["async"]["bwd_launches"],
            **{f"paper_{k}": v["bwd_launches"] for k, v in paper.items()},
            "train_leftouts": leftouts["bwd_launches"],
            **{f"arch_{k}": v["bwd_launches"]
               for k, v in archs["train"].items()},
            **{f"ssl_{k}": v["bwd_launches"] for k, v in ssl.items()}},
        "launches_per_update": a["bwd_launches"] / a["updates"],
        "max_abs_err": bwd["max_abs_err"],
        "path_max_abs_err": {**{f"paper_{k}": v["bwd_err"]
                                for k, v in paper.items()},
                             "train_leftouts": leftouts["bwd_err"],
                             **{f"arch_{k}": v["bwd_err"]
                                for k, v in archs["train"].items()},
                             **{f"ssl_{k}": v["bwd_err"]
                                for k, v in ssl.items()}},
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
                "score_reference": text[score_run]["counts"][kind],
                **{f"search_{k}": v["counts"][kind]
                   for k, v in search["text"].items()
                   if k != "path_max_abs_err"}},
            "max_abs_err": rec["max_abs_err"],
            "path_max_abs_err": {"text_search":
                                 search["text"]["path_max_abs_err"]},
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
