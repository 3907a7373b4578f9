"""Features and manifests: stage 3 of the recipe through the port.

Counterpart of ``s2st_tpu/cli/get_feature_manifest.py``, with the same
flags and outputs, and ``--device`` (CUDA unless it names another device;
it raises without a card):

    python -m s2st_tpu_torch.cli.get_feature_manifest \\
        --audio-manifest-root manifests --output-root features \\
        --splits train dev tst --ipa-vocab --use-g2p

From the ``<split><audio-suffix>`` manifests (id, src_audio, tgt_audio,
src_text, tgt_text, speaker) it computes, on the device, the source's
Kaldi fbank (``--src-n-mels``, at 16-bit scale, after resampling to
``--src-sample-rate`` where that is set: the ``_8k`` names) and the
target's log-mel spectrogram, and writes:

- ``src_logmelspec80[_8k].zip`` and ``tgt_logmelspec80.zip``, one stored
  ``<id>.npy`` member an utterance, addressed as ``path:offset:length``;
- ``src_gcmvn_stats[_8k].npz`` and ``tgt_gcmvn_stats.npz``;
- ``<split>.tsv`` with the frame counts;
- ``src_vocab.txt`` and ``tgt_vocab.txt`` (the train split's space-split
  symbols, most common first), ``speakers.txt`` and ``config.yaml``
  (``speaker_set_filename`` with more than one speaker).

``--num-workers`` threads extract utterances at once; ``--num-shards`` and
``--shard-index`` with ``--only-extract-audio-feature`` split extraction
across jobs, and a last run without that flag zips and writes the rest.
"""

from __future__ import annotations

import argparse
import logging
import shutil
import sys
import time
from collections import Counter, defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..data import audio_utils as au
from ..data.data_cfg import dump_yaml
from ..nn.core import disable_tf32, resolve_device
from ..preprocessing.manifest_utils import load_tsv, save_tsv

logger = logging.getLogger("s2st_tpu_torch.get_feature_manifest")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--audio-manifest-root", "-m", required=True)
    p.add_argument("--output-root", "-o", required=True)
    p.add_argument("--splits", "-s", nargs="+",
                   default=["train", "dev", "tst"])
    p.add_argument("--ipa-vocab", action="store_true")
    p.add_argument("--use-g2p", action="store_true",
                   help="the recipe's flag: stage 2 phonemizes, so this "
                        "only says that --audio-suffix names phone "
                        "manifests")
    p.add_argument("--audio-suffix", default=".audio_phone.tsv")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--win-length", type=int, default=1024)
    p.add_argument("--hop-length", type=int, default=256)
    p.add_argument("--n-fft", type=int, default=1024)
    p.add_argument("--n-mels", type=int, default=80)
    p.add_argument("--f-min", type=float, default=20.0)
    p.add_argument("--f-max", type=float, default=8000.0)
    p.add_argument("--src-n-mels", type=int, default=80)
    p.add_argument("--src-sample-rate", type=int, default=0,
                   help="resample the source audio to this rate before the "
                        "fbank (0 keeps it; 8000 names the outputs _8k)")
    p.add_argument("--num-workers", type=int, default=1,
                   help="threads extracting features")
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--only-extract-audio-feature", action="store_true",
                   help="extract this shard's .npy features and exit")
    p.add_argument("--device", default=None,
                   help="torch device of the features; CUDA when not given")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    args = get_parser().parse_args(argv)
    disable_tf32()
    device = resolve_device(args.device)

    out_root = Path(args.output_root).absolute()
    out_root.mkdir(parents=True, exist_ok=True)
    manifest_root = Path(args.audio_manifest_root).absolute()

    samples = []
    for split in args.splits:
        for e in load_tsv(manifest_root / f"{split}{args.audio_suffix}"):
            e["split"] = split
            samples.append(e)
    logger.info(f"{len(samples)} samples across {args.splits}")

    suffix = "_8k" if args.src_sample_rate == 8000 else ""
    src_name, tgt_name = f"src_logmelspec80{suffix}", "tgt_logmelspec80"
    src_zip = out_root / f"{src_name}.zip"
    tgt_zip = out_root / f"{tgt_name}.zip"
    src_gcmvn = out_root / f"src_gcmvn_stats{suffix}.npz"
    tgt_gcmvn = out_root / "tgt_gcmvn_stats.npz"
    src_dir, tgt_dir = out_root / src_name, out_root / tgt_name
    n_frames: dict = {}

    def extract_one(s):
        sid = s["id"]
        src_wave, src_sr = au.read_wav(s["src_audio"])
        if args.src_sample_rate and src_sr != args.src_sample_rate:
            src_wave = au.resample(src_wave, src_sr, args.src_sample_rate)
            src_sr = args.src_sample_rate
        src_feat = au.kaldi_fbank(src_wave * (2 ** 15), sample_rate=src_sr,
                                  num_mel_bins=args.src_n_mels,
                                  device=device)
        np.save(src_dir / f"{sid}.npy", src_feat.astype(np.float32))
        tgt_wave, tgt_sr = au.read_wav(s["tgt_audio"])
        if tgt_sr != args.sample_rate:
            tgt_wave = au.resample(tgt_wave, tgt_sr, args.sample_rate)
        tgt_feat = au.extract_logmel_spectrogram(
            tgt_wave, args.sample_rate, n_fft=args.n_fft,
            win_length=args.win_length, hop_length=args.hop_length,
            n_mels=args.n_mels, f_min=args.f_min, f_max=args.f_max,
            device=device)
        np.save(tgt_dir / f"{sid}.npy", tgt_feat.astype(np.float32))
        return sid, src_feat.shape[0], tgt_feat.shape[0]

    if not (src_zip.exists() and tgt_zip.exists()):
        src_dir.mkdir(exist_ok=True)
        tgt_dir.mkdir(exist_ok=True)
        todo = samples[args.shard_index::args.num_shards] \
            if args.num_shards > 1 else samples
        # skip what earlier sharded jobs extracted
        todo = [s for s in todo
                if not (src_dir / f"{s['id']}.npy").exists()
                or not (tgt_dir / f"{s['id']}.npy").exists()]
        logger.info(f"extracting features for {len(todo)} samples on "
                    f"{device}...")
        t0 = time.perf_counter()
        if args.num_workers > 1 and todo:
            with ThreadPoolExecutor(args.num_workers) as ex:
                for sid, a, b in ex.map(extract_one, todo):
                    n_frames[sid] = (a, b)
        else:
            for s in todo:
                sid, a, b = extract_one(s)
                n_frames[sid] = (a, b)
        logger.info(f"extracted {len(todo)} samples in "
                    f"{time.perf_counter() - t0:.3f} s")
        if args.only_extract_audio_feature:
            logger.info("shard feature extraction done "
                        "(--only-extract-audio-feature)")
            return 0

        logger.info("computing global CMVN...")
        for d, npz in ((src_dir, src_gcmvn), (tgt_dir, tgt_gcmvn)):
            stats = au.compute_global_cmvn(
                np.load(f) for f in sorted(d.glob("*.npy")))
            np.savez(npz, mean=stats["mean"], std=stats["std"])

        logger.info("zipping features...")
        au.create_zip(src_dir, src_zip)
        au.create_zip(tgt_dir, tgt_zip)
        shutil.rmtree(src_dir)
        shutil.rmtree(tgt_dir)

    src_paths = au.get_zip_manifest(src_zip)
    tgt_paths = au.get_zip_manifest(tgt_zip)

    by_split = defaultdict(list)
    for s in samples:
        sid = s["id"]
        if sid not in n_frames:
            # a run over existing zips reads the frame counts from them
            n_frames[sid] = (
                au.get_features_or_waveform(src_paths[sid]).shape[0],
                au.get_features_or_waveform(tgt_paths[sid]).shape[0])
        by_split[s["split"]].append({
            "id": sid,
            "src_audio": src_paths[sid],
            "tgt_audio": tgt_paths[sid],
            "src_n_frames": n_frames[sid][0],
            "tgt_n_frames": n_frames[sid][1],
            "src_text": s["src_text"],
            "tgt_text": s["tgt_text"],
            "speaker": s.get("speaker", "spk0"),
        })
    for split, rows in by_split.items():
        save_tsv(rows, out_root / f"{split}.tsv")

    # vocabularies ("symbol count", most common first)
    train_split = [s for s in args.splits if "train" in s][0]
    for side in ("src", "tgt"):
        vocab: Counter = Counter()
        for row in by_split[train_split]:
            vocab.update(row[f"{side}_text"].split(" "))
        with open(out_root / f"{side}_vocab.txt", "w", encoding="utf-8") as f:
            for sym, c in vocab.most_common():
                if sym:
                    f.write(f"{sym} {c}\n")

    speakers = sorted({s.get("speaker", "spk0") for s in samples})
    (out_root / "speakers.txt").write_text("\n".join(speakers) + "\n")

    config = {
        "audio_root": out_root.as_posix(),
        "src_vocab_filename": "src_vocab.txt",
        "tgt_vocab_filename": "tgt_vocab.txt",
        "input_feat_per_channel": args.src_n_mels,
        "input_channels": 1,
        "features": {
            "type": "spectrogram+melscale+log",
            "eps": 1e-5, "n_mels": args.n_mels, "n_fft": args.n_fft,
            "window_fn": "hann", "win_length": args.win_length,
            "hop_length": args.hop_length, "sample_rate": args.sample_rate,
            "win_len_t": args.win_length / args.sample_rate,
            "hop_len_t": args.hop_length / args.sample_rate,
            "f_min": args.f_min, "f_max": args.f_max,
            "n_stft": args.n_fft // 2 + 1,
        },
        "src_transforms": {"*": ["src_global_cmvn"],
                           "_train": ["src_global_cmvn", "specaugment"]},
        "tgt_transforms": {"*": ["tgt_global_cmvn"]},
        "src_global_cmvn": {"stats_npz_path": src_gcmvn.as_posix()},
        "tgt_global_cmvn": {"stats_npz_path": tgt_gcmvn.as_posix()},
        # fairseq's SpecAugment 'ld' policy
        "specaugment": {"time_wrap_W": 0, "freq_mask_N": 2, "freq_mask_F": 27,
                        "time_mask_N": 2, "time_mask_T": 100,
                        "time_mask_p": 1.0},
    }
    if len(speakers) > 1:
        config["speaker_set_filename"] = "speakers.txt"
    (out_root / "config.yaml").write_text(dump_yaml(config))
    logger.info(f"wrote {out_root}/config.yaml")
    return 0


def cli_main():
    sys.exit(main())


if __name__ == "__main__":
    cli_main()
