"""The port's logging and diagnostics (``s2st_tpu_torch/logging_utils.py``,
``s2st_tpu_torch/utils/diagnostics.py``) against JAX's, on the CPU.

- the meters and their aggregation contexts give JAX's smoothed values,
  and ``ProgressLogger``'s ``simple`` and ``json`` lines (``log`` and
  ``print``, with and without an epoch) equal JAX's for the same stats,
  exactly;
- the optional sinks: TensorBoard writes event files with scalars, audio
  and an image; wandb and azureml, absent here, log JAX's warnings;
  ``tqdm`` wraps the iterable and closes on ``print``;
- ``find_nonfinite``/``report_nonfinite`` over named tensors give JAX's
  report over the same tree;
- ``HeartbeatWatchdog`` sends SIGINT, caught as ``KeyboardInterrupt`` in
  a subprocess, when no beat comes, and nothing while beats come;
- ``Profiler`` writes a Chrome trace of the host's operators.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from s2st_tpu import logging_utils as jlog
from s2st_tpu_torch import logging_utils as plog
from s2st_tpu_torch.utils import diagnostics as pdiag
from tests._torch_port import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _messages(fn, *loggers):
    handler, saved = _Collect(), []
    for name in loggers:
        lg = logging.getLogger(name)
        saved.append((lg, lg.level))
        lg.addHandler(handler)
        lg.setLevel(logging.DEBUG)
    try:
        fn()
    finally:
        for lg, level in saved:
            lg.removeHandler(handler)
            lg.setLevel(level)
    return [(r.levelname, r.getMessage()) for r in handler.records]


def _meter_values(mod):
    with mod.aggregate("t_test", new_root=True) as agg:
        for i, (loss, n) in enumerate([(2.5, 3), (1.25, 1), (float("nan"),
                                                             2)]):
            mod.log_scalar("loss", loss, n, round=3)
            mod.log_sum("ntokens", 10 * (i + 1))
            mod.log_speed("wps", 100)
        mod.log_derived("ppl", lambda m: 2 ** m["loss"].avg)
    vals = agg.get_smoothed_values()
    vals.pop("wps")
    mod.reset_meters("t_test")
    return vals


STATS = {"loss": 3.14159265, "gnorm": 0.000123456, "lr": 5e-4,
         "ntokens": 1234, "num_updates": 17, "name": "x"}


def test_meters_and_lines_match_jax():
    assert _meter_values(plog) == _meter_values(jlog)
    for fmt in ("simple", "json"):
        for epoch in (None, 3):
            lines = []
            for mod, name in ((jlog, "s2st_tpu.logging_utils"),
                              (plog, "s2st_tpu_torch.logging_utils")):
                prog = mod.ProgressLogger(log_format=fmt, epoch=epoch)

                def run():
                    prog.log(STATS, tag="train_inner", step=17)
                    prog.print({k: round(v, 4) if isinstance(v, float)
                                else v for k, v in STATS.items()},
                               tag="valid", step=17)
                lines.append(_messages(run, name))
            assert lines[0] == lines[1] and len(lines[0]) == 2, (fmt, epoch)
            if fmt == "json":
                assert json.loads(lines[1][0][1])["train_inner_gnorm"] == \
                    0.0001


def test_optional_sinks(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    tb = tmp_path / "tb"
    msgs = []
    for mod, name in ((jlog, "s2st_tpu.logging_utils"),
                      (plog, "s2st_tpu_torch.logging_utils")):
        box = {}

        def make():
            box["p"] = mod.ProgressLogger(
                wandb_project="proj", azureml_logging=True,
                tensorboard_logdir=str(tb / name) if mod is plog else None)
        msgs.append(_messages(make, name))
    assert msgs[0] == msgs[1]
    assert ("WARNING", "wandb not found, pip install wandb") in msgs[1]
    prog = box["p"]
    prog.log({"loss": 1.5, "num_updates": 3}, step=3)
    prog.log_audio("valid/pred_audio", np.sin(np.arange(800) / 5.0), 16000)
    prog.log_spectrogram("valid/spec", np.random.RandomState(0).rand(20, 8))
    events = list((tb / "s2st_tpu_torch.logging_utils").glob("events.*"))
    assert events and events[0].stat().st_size > 0
    pytest.importorskip("tqdm")
    bar = plog.ProgressLogger(log_format="tqdm")
    assert list(bar.wrap(iter(range(4)), prefix="epoch 001")) == \
        list(range(4))
    bar.log({"loss": 1.0})
    bar.print({"loss": 1.0}, tag="train")
    assert bar._bar is None


def test_nonfinite_report_matches_jax():
    import jax.numpy as jnp
    from s2st_tpu.utils import diagnostics as jdiag
    arrays = {"encoder": {"layer0": {"w": np.array([[1.0, np.nan],
                                                    [np.inf, 2.0]],
                                                   np.float32)},
                          "b": np.ones(3, np.float32)},
              "decoder": {"w": np.array([1.0, -np.inf, 0.0], np.float32)}}
    batch = {"src_speech": np.array([np.nan, 1.0], np.float32),
             "src_text": np.array([1, 2], np.int64)}
    want = jdiag.report_nonfinite(
        params={k: {kk: jnp.asarray(vv) if not isinstance(vv, dict) else
                    {a: jnp.asarray(b) for a, b in vv.items()}
                    for kk, vv in v.items()} for k, v in arrays.items()},
        batch={k: jnp.asarray(v) for k, v in batch.items()})
    as_t = {k: {kk: torch.from_numpy(vv) if not isinstance(vv, dict) else
                {a: torch.from_numpy(b) for a, b in vv.items()}
                for kk, vv in v.items()} for k, v in arrays.items()}
    got = pdiag.report_nonfinite(
        params=as_t, batch={**{k: torch.from_numpy(v)
                               for k, v in batch.items()}, "nsentences": 2})
    assert sorted(got.splitlines()) == sorted(want.splitlines())
    assert len(got.splitlines()) == 3
    assert pdiag.report_nonfinite(params={"w": torch.ones(2)}) == \
        jdiag.report_nonfinite(params={"w": jnp.ones(2)})


WATCHDOG = """
import sys, time
sys.path.insert(0, {repo!r})
from s2st_tpu_torch.utils.diagnostics import HeartbeatWatchdog
for beat in (True, False):
    dog = HeartbeatWatchdog(1.0).start()
    try:
        for _ in range(25):
            time.sleep(0.1)
            if beat:
                dog.beat()
        print("finished", flush=True)
    except KeyboardInterrupt:
        print("interrupted", flush=True)
    dog.stop()
"""


@pytest.fixture(scope="module")
def watchdog_runs():
    """One process (one import of torch): a second of timeout, first
    beating every 0.1 s for 2.5 s, then not beating."""
    res = subprocess.run([sys.executable, "-c",
                          WATCHDOG.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return dict(zip((True, False), res.stdout.split()))


@pytest.mark.parametrize("beat", [False, True])
def test_heartbeat_watchdog_sigint(beat, watchdog_runs):
    assert watchdog_runs[beat] == ("finished" if beat else "interrupted")


def test_profiler_writes_a_chrome_trace(tmp_path):
    prof = pdiag.Profiler(str(tmp_path / "prof")).start()
    torch.ones(64, 64) @ torch.ones(64, 64)
    path = prof.stop()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
