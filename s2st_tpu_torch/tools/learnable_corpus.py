"""The learnable synthetic S2ST corpus of the end-to-end gate.

The port's own copy of ``s2st_tpu/benchmark/synthetic.py::
make_learnable_s2st_corpus`` (:42) and its ``_write_dict``: for the same
arguments it writes the same files, byte for byte (``gcmvn_tgt.npz``'s
arrays; numpy stamps the zip's entries with the time). Every vocabulary
token has a fixed spectral prototype on the source side (fbank) and a
fixed mel prototype on the target side; an utterance is a random token
sequence rendered as [prototype + noise] x frames_per_token on both sides,
so the model must learn the token-to-token mapping and the prototypes'
acoustics, and dev utterances are unseen sequences of the same tokens.
The manifest takes the Fisher recipe's TSV columns (id, src_audio,
tgt_audio, src_n_frames, tgt_n_frames, src_text, tgt_text, speaker).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def _write_dict(path: Path, words):
    with open(path, "w", encoding="utf-8") as f:
        for w in words:
            f.write(f"{w} 10\n")


def make_learnable_s2st_corpus(root: Path, n_train: int = 96,
                               n_dev: int = 16, n_test: int = 16,
                               vocab: int = 10, n_feat: int = 16,
                               n_mel: int = 16,
                               src_frames_per_token: int = 4,
                               tgt_frames_per_token: int = 4,
                               min_tokens: int = 3, max_tokens: int = 7,
                               noise: float = 0.05,
                               seed: int = 0) -> Path:
    """<root>/{train,dev,test}.tsv + config.yaml + dicts + features.

    Token prototypes are drawn once from the seed; every split shares them.
    Sequences are sampled without replacement across splits (dev/test
    sequences are unseen in train with high probability given 10^3..10^7
    possible sequences)."""
    root = Path(root)
    feat_dir = root / "features"
    feat_dir.mkdir(parents=True, exist_ok=True)
    r = np.random.RandomState(seed)

    src_words = [f"s{i}" for i in range(vocab)]
    tgt_words = [f"t{i}" for i in range(vocab)]
    _write_dict(root / "src_vocab.txt", src_words)
    _write_dict(root / "tgt_vocab.txt", tgt_words)

    # fixed per-token acoustic prototypes, well separated (unit-norm randn
    # in 16-d is nearly orthogonal; scale keeps SNR ~ 1/noise)
    src_proto = r.randn(vocab, n_feat).astype(np.float32)
    tgt_proto = r.randn(vocab, n_mel).astype(np.float32)

    seen = set()
    splits = {"train": n_train, "dev": n_dev, "test": n_test}
    gcmvn_feats = []
    for split, n in splits.items():
        rows = []
        made = 0
        while made < n:
            L = int(r.randint(min_tokens, max_tokens + 1))
            toks = tuple(int(t) for t in r.randint(0, vocab, size=L))
            if toks in seen:
                continue
            seen.add(toks)
            uid = f"{split}_{made}"
            src = np.repeat(src_proto[list(toks)], src_frames_per_token,
                            axis=0)
            src = src + noise * r.randn(*src.shape).astype(np.float32)
            tgt = np.repeat(tgt_proto[list(toks)], tgt_frames_per_token,
                            axis=0)
            tgt = tgt + noise * r.randn(*tgt.shape).astype(np.float32)
            np.save(feat_dir / f"{uid}_src.npy", src.astype(np.float32))
            np.save(feat_dir / f"{uid}_tgt.npy", tgt.astype(np.float32))
            gcmvn_feats.append(tgt.astype(np.float32))
            rows.append({
                "id": uid,
                "src_audio": f"features/{uid}_src.npy",
                "tgt_audio": f"features/{uid}_tgt.npy",
                "src_n_frames": src.shape[0],
                "tgt_n_frames": tgt.shape[0],
                "src_text": " ".join(src_words[t] for t in toks),
                "tgt_text": " ".join(tgt_words[t] for t in toks),
                "speaker": "spk0",
            })
            made += 1
        with open(root / f"{split}.tsv", "w", newline="",
                  encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()),
                               delimiter="\t", quoting=csv.QUOTE_NONE)
            w.writeheader()
            w.writerows(rows)

    allf = np.concatenate(gcmvn_feats)
    np.savez(root / "gcmvn_tgt.npz",
             mean=allf.mean(0).astype(np.float32),
             std=np.maximum(allf.std(0), 1e-8).astype(np.float32))

    (root / "config.yaml").write_text(f"""audio_root: {root.as_posix()}
src_vocab_filename: src_vocab.txt
tgt_vocab_filename: tgt_vocab.txt
input_feat_per_channel: {n_feat}
input_channels: 1
features:
  sample_rate: 16000
  n_fft: 128
  win_len_t: 0.008
  hop_len_t: 0.004
  n_mels: {n_mel}
  f_min: 20.0
  f_max: 8000
tgt_transforms:
  '*':
  - tgt_global_cmvn
tgt_global_cmvn:
  stats_npz_path: {(root / 'gcmvn_tgt.npz').as_posix()}
""")
    return root
