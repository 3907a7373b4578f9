"""The port's end-to-end gate (``s2st_tpu_torch.tools.convergence_gate``)
against JAX's (``tools/convergence_gate.py``), on the CPU.

- The corpus: the port's ``make_learnable_s2st_corpus`` writes JAX's files
  byte for byte for the same arguments (``gcmvn_tgt.npz``: each array's
  bytes, since numpy stamps the zip with the time; ``config.yaml`` names
  its own root).
- The gate logic: JAX's ``run_s2st`` with its train CLI replaced by one that
  writes a canned JAX log, and the port's gate on the same records in the
  port's log format, give the same trajectories, gates, margins and verdict,
  in the full and the ``--fast`` mode, on passing and on failing records.
  JAX's epoch-end train loss is the last logged update of the epoch (every
  8th of its batches), else its last update; the port's reading of its
  per-update records takes the same one.
- The ``--fast`` gate itself through the port's train CLI on the CPU
  (about 5 s alone): it passes, and its summary lands in ``--json`` beside
  the runs already there.
"""

import importlib.util
import json
import zipfile
from pathlib import Path

import numpy as np
import pytest

from s2st_tpu_torch.tools import convergence_gate as gate
from s2st_tpu_torch.tools.learnable_corpus import make_learnable_s2st_corpus
from tests._torch_port import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent


def _jax_gate():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_gate", REPO / "tools" / "convergence_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kwargs", [{}, {"n_train": 20, "n_dev": 5,
                                         "n_test": 3, "vocab": 6,
                                         "n_feat": 8, "seed": 3}])
def test_corpus_is_jax_byte_for_byte(tmp_path, kwargs):
    from s2st_tpu.benchmark.synthetic import make_learnable_s2st_corpus as j
    a = j(tmp_path / "jax", **kwargs)
    b = make_learnable_s2st_corpus(tmp_path / "port", **kwargs)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    assert len(files) > 10
    for rel in files:
        x, y = (a / rel).read_bytes(), (b / rel).read_bytes()
        if rel.name == "config.yaml":
            y = y.replace(str(b).encode(), str(a).encode())
        if rel.suffix == ".npz":
            with zipfile.ZipFile(a / rel) as za, zipfile.ZipFile(b / rel) as zb:
                assert za.namelist() == zb.namelist()
                for name in za.namelist():
                    assert za.read(name) == zb.read(name), (rel, name)
            continue
        assert x == y, rel


# a validation every 4 epochs; (mcd, ins, asr correct, st correct) of 97
FULL_PASS = [(12.93, 5.85, 22, 17), (13.06, 5.9, 28, 23), (11.8, 5.69, 26, 22),
             (10.17, 4.8, 29, 30), (6.2, 2.1, 35, 33), (4.1, 1.2, 40, 38),
             (3.0, 0.6, 45, 41), (2.7, 0.4, 51, 45), (2.69, 0.37, 60, 55),
             (2.64, 0.35, 51, 45), (2.69, 0.37, 60, 55), (2.4, 0.32, 62, 60)]


def _variants():
    full_loss = [8.65 - 0.1 * i for i in range(48)]
    fast = FULL_PASS[:3]
    fast_loss = full_loss[:12]
    return {
        "full_pass": (False, FULL_PASS, full_loss),
        "full_mcd_high": (False, FULL_PASS[:-1] + [(4.2, 0.3, 62, 60)],
                          full_loss),
        "full_ins_high": (False, FULL_PASS[:-1] + [(2.4, 1.0, 62, 60)],
                          full_loss),
        "full_asr_weak": (False, FULL_PASS[:-1] + [(2.4, 0.3, 44, 60)],
                          full_loss),
        "full_loss_rises": (False, FULL_PASS, full_loss[::-1]),
        "fast_pass": (True, fast, fast_loss),
        "fast_st_flat": (True, fast[:-1] + [(11.8, 5.69, 26, 17)],
                         fast_loss),
        "fast_mcd_peak_last": (True, fast[:-1] + [(13.5, 5.69, 26, 22)],
                               fast_loss),
    }


@pytest.mark.parametrize("name", sorted(_variants()))
def test_gate_logic_equals_jax_on_canned_records(tmp_path, monkeypatch,
                                                 name):
    fast, valids, epoch_loss = _variants()[name]
    jg = _jax_gate()
    import s2st_tpu.cli.train as jax_train

    def fake_train(argv):
        with open(argv[argv.index("--log-file") + 1], "w") as f:
            for e, loss in enumerate(epoch_loss, start=1):
                f.write("t | INFO | train | " + json.dumps(
                    {"train_loss": loss, "train_epoch": e}) + "\n")
                if e % 4 == 0:
                    m, ins, a, s = valids[e // 4 - 1]
                    f.write("t | INFO | valid | " + json.dumps(
                        {"valid_loss": 5.0, "valid_mcd_loss": m,
                         "valid_ins_rate": ins, "valid_asr_n_correct": a,
                         "valid_asr_total": 97, "valid_st_n_correct": s,
                         "valid_st_total": 97}) + "\n")
        return 0

    monkeypatch.setattr(jax_train, "main", fake_train)
    want = jg.run_s2st(tmp_path / "jax", fast)

    # the same records in the port's log: 2 updates an epoch, the second
    # carrying the epoch's loss
    log = tmp_path / "port.log"
    with open(log, "w") as f:
        n = 0
        for e, loss in enumerate(epoch_loss, start=1):
            for x in (loss + 1.0, loss):
                n += 1
                f.write(json.dumps({"loss": x, "num_updates": n,
                                    "epoch": e}) + "\n")
            if e % 4 == 0:
                m, ins, a, s = valids[e // 4 - 1]
                f.write(json.dumps({"valid": {
                    "loss": 5.0, "mcd_loss": m, "ins_rate": ins,
                    "asr_n_correct": a, "asr_total": 97,
                    "st_n_correct": s, "st_total": 97},
                    "num_updates": n, "epoch": e, "ms": {}}) + "\n")
    valid_recs, updates = gate.read_log(log)
    got = gate.gate(valid_recs, gate.epoch_losses(updates), fast,
                    12 if fast else 48)
    assert got == want
    assert got["passed"] == name.endswith("pass")


def test_epoch_loss_is_jax_epoch_line():
    """An epoch of 10 updates: JAX logs its 8th (log interval 8), and its
    epoch-end line holds that; an epoch of 3 holds its last."""
    updates = [{"loss": float(i), "epoch": 1} for i in range(10)] + \
              [{"loss": 10.0 + i, "epoch": 2} for i in range(3)]
    assert gate.epoch_losses(updates) == [7.0, 12.0]


def test_fast_gate_passes_through_the_port_on_the_cpu(tmp_path):
    out = tmp_path / "conv.json"
    out.write_text(json.dumps({"runs": {"elsewhere fp32": {"x": 1}}}))
    assert gate.main(["--fast", "--device", "cpu", "--json", str(out),
                      "--outdir", str(tmp_path / "work")]) == 0
    runs = json.loads(out.read_text())["runs"]
    assert set(runs) == {"elsewhere fp32", "cpu fp32 fast"}
    res = runs["cpu fp32 fast"]
    assert res["all_passed"] and res["fast"] and res["dtype"] == "fp32"
    (v,) = res["verticals"]
    assert v["passed"] and all(v["gates"].values())
    assert len(v["dev_mcd_trajectory"]) == 3
    assert len(v["train_loss_trajectory"]) == 12
    assert np.isfinite(v["wall_s"])
