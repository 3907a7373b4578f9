"""The end-to-end gate: the port's training must learn.

The port's counterpart of the s2st vertical of ``tools/convergence_gate.py``
(``run_s2st``, :74-175). It writes the learnable corpus
(``tools/learnable_corpus.py``, byte for byte JAX's), trains the flagship
``s2st_transformer`` on it through ``s2st_tpu_torch.cli.train`` with JAX's
flags, validating with ``--eval-inference`` every 4 epochs, and holds the
trajectories to JAX's gates, unchanged:

- full (48 epochs): dev MCD-DTW ends at <= 0.5 of its peak and < 4.0; the
  insertion rate ends < 1.0; the aux ASR and ST dev accuracies end >= 0.5
  and >= 2x their first validation; the train loss falls (3-point
  smoothing).
- ``--fast`` (12 epochs): each of those moves the right way.

The peak, not the first point, is the reference for MCD: a barely trained
model emits almost no frames, and its per-target-frame DTW sum is low.

    python -m s2st_tpu_torch.tools.convergence_gate [--fast] [--fp16] \\
        [--device cpu] [--json CONVERGENCE_TORCH.json] [--outdir DIR]

Records come from the port's ``--log-file`` JSON lines: a validation's
``{"valid": stats}`` and each update's metrics. The one flag that differs
from JAX's is ``--log-interval 1`` for JAX's 8: in the port it only chooses
which updates are written, and the train-loss trajectory is then taken as
JAX's epoch-end ``train`` line holds it: the loss of the epoch's last
update at a multiple of 8 updates into the epoch, else of its last update.
Values are rounded to 4 decimals first, as JAX's log rounds them.

The run's summary, in ``CONVERGENCE.json``'s shape plus the device, the
compute type and, on a card, its name and power limit as ``nvidia-smi``
gives them, is printed on a ``convergence`` line and goes into ``--json``
under the key ``"<device> <type>"`` (``"<device> <type> fast"`` with
``--fast``), next to the runs already there. Exits 1 when a gate fails. The mt and lm
verticals of JAX's gate train models the port does not have.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch

from .learnable_corpus import make_learnable_s2st_corpus

REPO = Path(__file__).resolve().parent.parent.parent
# JAX's log interval, which its epoch-end train line depends on
JAX_LOG_INTERVAL = 8


def train_flags(corpus: Path, save_dir: Path, epochs: int,
                log: Path) -> List[str]:
    """JAX's s2st vertical's train flags (tools/convergence_gate.py:78-110)
    with the port's log file."""
    return [
        str(corpus), "--save-dir", str(save_dir),
        "--config-yaml", "config.yaml",
        "--train-subset", "train", "--valid-subset", "dev",
        "--task", "s2s_translation", "--criterion", "s2st_loss",
        "--arch", "s2st_transformer",
        "--encoder-layers", "2", "--encoder-embed-dim", "32",
        "--encoder-ffn-embed-dim", "64", "--encoder-attention-heads", "2",
        "--decoder-layers", "2", "--decoder-embed-dim", "32",
        "--decoder-ffn-embed-dim", "64", "--decoder-attention-heads", "2",
        "--conv-channels", "32", "--middle-layers", "0",
        "--prenet-layers", "1", "--prenet-dim", "16",
        "--postnet-layers", "1", "--postnet-conv-dim", "16",
        "--output-frame-dim", "16", "--n-frames-per-step", "1",
        "--max-tokens", "1500", "--max-epoch", str(epochs),
        "--optimizer", "adam", "--lr", "0.003",
        "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "30",
        "--clip-norm", "1.0", "--bce-pos-weight", "5.0", "--seed", "1",
        "--encoder-normalize-before", "--decoder-normalize-before",
        "--max-source-positions", "128", "--max-target-positions", "128",
        "--required-batch-size-multiple", "1", "--log-interval", "1",
        "--validate-interval", "4",
        "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3",
        "--report-accuracy", "--label-smoothing", "0.1",
        "--asr-decoder-layers", "1", "--st-decoder-layers", "1",
        "--asr-decoder-embed-dim", "32", "--st-decoder-embed-dim", "32",
        "--eval-inference", "--best-checkpoint-metric", "mcd_loss",
        "--spec-bwd-max-iter", "2",
        "--log-format", "json", "--log-file", str(log),
    ]


def read_log(path: Path):
    """(the validations' stats, the updates' metrics) of a port log file,
    each value rounded to 4 decimals."""
    valids, updates = [], []
    for line in Path(path).read_text().splitlines():
        rec = json.loads(line)
        if "valid" in rec:
            valids.append({k: round(float(v), 4)
                           for k, v in rec["valid"].items()})
        else:
            updates.append(rec)
    return valids, updates


def epoch_losses(updates: List[dict],
                 log_interval: int = JAX_LOG_INTERVAL) -> List[float]:
    """The loss JAX's epoch-end train line holds for each epoch: that of
    the last update logged inside the epoch (every ``log_interval``-th of
    its batches), else of its last update."""
    by_epoch: Dict[int, List[dict]] = {}
    for rec in updates:
        by_epoch.setdefault(int(rec["epoch"]), []).append(rec)
    out = []
    for epoch in sorted(by_epoch):
        recs = by_epoch[epoch]
        logged = [r for i, r in enumerate(recs)
                  if (i + 1) % log_interval == 0]
        out.append(round(float((logged or recs)[-1]["loss"]), 4))
    return out


def smoothed(xs, k=3):
    return [sum(xs[max(0, i - k + 1):i + 1]) / len(xs[max(0, i - k + 1):i + 1])
            for i in range(len(xs))]


def gate(valids: List[dict], tloss: List[float], fast: bool,
         epochs: int) -> dict:
    """JAX's gates and margins (tools/convergence_gate.py:113-175) on the
    trajectories."""
    mcd = [d["mcd_loss"] for d in valids if "mcd_loss" in d]
    ins = [d.get("ins_rate") for d in valids if "mcd_loss" in d]
    asr_acc = [d["asr_n_correct"] / max(d["asr_total"], 1.0)
               for d in valids if d.get("asr_total")]
    st_acc = [d["st_n_correct"] / max(d["st_total"], 1.0)
              for d in valids if d.get("st_total")]
    sm = smoothed(tloss)
    if fast:
        gates = {
            "dev_mcd_improves_from_peak": len(mcd) >= 2
            and mcd[-1] < max(mcd),
            "aux_asr_accuracy_rises": len(asr_acc) >= 2
            and asr_acc[-1] > asr_acc[0],
            "aux_st_accuracy_rises": len(st_acc) >= 2
            and st_acc[-1] > st_acc[0],
            "train_loss_falls": len(sm) >= 2 and sm[-1] < sm[0],
        }
    else:
        gates = {
            "dev_mcd_improves_50pct_from_peak": len(mcd) >= 2
            and mcd[-1] <= 0.5 * max(mcd),
            "dev_mcd_below_4": bool(mcd) and mcd[-1] < 4.0,
            "insertion_rate_below_1": bool(ins) and ins[-1] is not None
            and ins[-1] < 1.0,
            "aux_asr_dev_accuracy_strength": len(asr_acc) >= 2
            and asr_acc[-1] >= 0.5 and asr_acc[-1] >= 2.0 * asr_acc[0],
            "aux_st_dev_accuracy_strength": len(st_acc) >= 2
            and st_acc[-1] >= 0.5 and st_acc[-1] >= 2.0 * st_acc[0],
            "train_loss_falls": len(sm) >= 2 and sm[-1] < sm[0],
        }
    margins = {}
    if mcd:
        margins["mcd_final_over_peak"] = round(mcd[-1] / max(mcd), 4)
        margins["mcd_final"] = round(mcd[-1], 4)
    if ins and ins[-1] is not None:
        margins["ins_rate_final"] = round(ins[-1], 4)
    if asr_acc:
        margins["aux_asr_dev_accuracy"] = round(asr_acc[-1], 4)
    if st_acc:
        margins["aux_st_dev_accuracy"] = round(st_acc[-1], 4)
    return {"vertical": "s2st", "epochs": epochs,
            "dev_mcd_trajectory": [round(x, 4) for x in mcd],
            "dev_ins_rate_trajectory": [round(x, 4) for x in ins
                                        if x is not None],
            "dev_aux_asr_accuracy_trajectory": [round(x, 4)
                                                for x in asr_acc],
            "dev_aux_st_accuracy_trajectory": [round(x, 4) for x in st_acc],
            "train_loss_trajectory": tloss,
            "gates": gates, "margins": margins,
            "passed": all(gates.values())}


def run_s2st(work: Path, fast: bool, device: str, fp16: bool) -> dict:
    from ..cli.train import main as train_main
    corpus = make_learnable_s2st_corpus(work / "corpus", n_train=96)
    log = work / "s2st.log"
    epochs = 12 if fast else 48
    argv = train_flags(corpus, work / "ckpt", epochs, log) + [
        "--device", device] + (["--fp16"] if fp16 else [])
    if train_main(argv) != 0:
        raise RuntimeError("s2st training failed")
    valids, updates = read_log(log)
    return gate(valids, epoch_losses(updates), fast, epochs)


def device_name(device: str) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else \
        dev.type


def card_identity(device: str) -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = subprocess.run(["nvidia-smi", f"--id={index}",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


def record(path: Path, summary: dict) -> None:
    """Put ``summary`` into the file's runs under its device and type."""
    runs = {}
    if path.is_file():
        runs = json.loads(path.read_text()).get("runs", {})
    mode = " fast" if summary["fast"] else ""
    runs[f"{summary['platform']} {summary['dtype']}{mode}"] = summary
    path.write_text(json.dumps({"runs": runs}, indent=1) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--outdir", default=None,
                    help="work dir (default: a fresh tempdir)")
    ap.add_argument("--fast", action="store_true",
                    help="shorter runs with direction-only gates")
    ap.add_argument("--fp16", action="store_true",
                    help="train in bf16 over fp32 parameters")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=str(REPO / "CONVERGENCE_TORCH.json"))
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="convergence_torch_") as tmp:
        work = Path(args.outdir or tmp) / "s2st"
        work.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        print("== convergence gate (port): s2st ==", flush=True)
        res = run_s2st(work, args.fast, args.device, args.fp16)
        res["wall_s"] = round(time.time() - t0, 1)
    summary = {"fast": args.fast, "platform": device_name(args.device),
               "dtype": "bf16" if args.fp16 else "fp32",
               "all_passed": res["passed"], "verticals": [res]}
    if torch.device(args.device).type == "cuda":
        summary["card"] = card_identity(args.device)
    print("convergence " + json.dumps(summary), flush=True)
    record(Path(args.json), summary)
    print(f"wrote {args.json}; all_passed={summary['all_passed']}",
          flush=True)
    return 0 if summary["all_passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
