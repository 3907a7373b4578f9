#!/usr/bin/env python3
"""Drive the PyTorch port (s2st_tpu_torch) on one NVIDIA H100.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Build csrc/flash_attention.cu for sm_90a and hold the kernel against its
   plain PyTorch version at the serving path's shapes, in fp32 and bf16,
   with its time beside the plain version's, SDPA's (a yardstick only) and
   the card's bound.
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

Prints the card's name and power limit, one JSON line of kernel
measurements, and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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


def attention_inputs(b, tq, tk, lengths, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape_q, shape_k = (b, tq, HEADS, HEAD_DIM), (b, tk, HEADS, HEAD_DIM)
    q = (torch.randn(shape_q, generator=g, device="cuda")
         * HEAD_DIM ** -0.5).to(dtype)
    k = torch.randn(shape_k, generator=g, device="cuda").to(dtype)
    v = torch.randn(shape_k, generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, device="cuda")
    kpm = torch.arange(tk, device="cuda")[None, :] >= lens[:, None]
    return q, k, v, kpm


def attention_bound_ms(q, k, kpm, causal) -> tuple:
    """Least time for the function on this card: each input read once and
    the output written once, against the products this data needs (a
    causal row that has a valid key needs only the keys up to itself)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    size = q.element_size()
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
    ops = 4.0 * h * d * pairs
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


def check_case(ka, name, b, tq, tk, lengths, causal, dtype, card):
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
        "causal": causal, "max_abs_err": max_err, "tolerance": tol,
        "kernel_ms": time_ms(lambda: ka.flash_attention(q, k, v, kpm,
                                                        causal)),
        "plain_ms": time_ms(lambda: ka.flash_attention_reference(
            q, k, v, kpm, causal)),
        "library_ms": time_ms(sdpa_fn(q, k, v, kpm, causal)),
    }
    rec["bound_ms"], rec["bound_by"] = attention_bound_ms(q, k, kpm, causal)
    rec["card"] = card
    print("kernel_case " + json.dumps(rec), flush=True)
    if not ok:
        raise AssertionError(f"{name} {dtype}: kernel disagrees with the "
                             f"plain version, max abs err {max_err} ({tol})")
    return rec


def kernel_phase(card: str, main_lengths) -> dict:
    from s2st_tpu_torch.kernels import attention as ka
    t0 = time.perf_counter()
    lib = ka.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = lib.with_name(lib.stem + ".ptxas.txt")
    if ptxas.is_file():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas: " + line.strip(), flush=True)
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
    # the serving path's own encoder self-attention shape, in bf16
    t = main_lengths[0]
    return check_case(ka, "serving_encoder_self", len(main_lengths), t, t,
                      main_lengths, False, torch.bfloat16, card)


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
    """(result, wall ms, device kernel ms, device activities, top ones) of
    one call under torch.profiler; the device idles for wall - kernel ms."""
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

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or e.self_cuda_time_total
    busy = sum(dev_us(e) for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    top = sorted(kern, key=dev_us, reverse=True)[:6]
    return out, wall, busy, launches, [(e.key[:60], dev_us(e) / 1e3, e.count)
                                       for e in top]


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
        for key, ms, count in top:
            print(f"profile {name}:   {ms:9.3f} ms  {count:6d}x  {key}",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import s2st_tpu_torch  # noqa: F401  (fails outside the repository)
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
    serving = kernel_phase(card, main_lengths)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        served = serve_phase(work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    agreement_phase(card)
    profile_phase(card)

    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "s2st_tpu_torch/csrc/flash_attention.cu",
        "replaces": "s2st_tpu/nn/attention.py:85",
        "launches": served["launches"],
        "max_abs_err": serving["max_abs_err"],
        "ms": serving["kernel_ms"],
        "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
    }]
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
