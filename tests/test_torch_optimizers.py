"""The port's optimizers, schedules and their checkpoint state against
JAX's (``s2st_tpu/train/optim.py``, optax) on the CPU.

- each schedule of ``SCHEDULE_REGISTRY`` at updates {0, 1, warmup - 1,
  warmup, 1e4, 1e5}: relative 1e-6 (JAX computes in float32, the port in
  float64);
- ``parse_manual_lr_dict`` and ``manual_lr_host`` on JAX's key grammar:
  equal;
- each of the 9 optimizers of ``OPTIMIZER_REGISTRY``: 3 updates with
  ``p -= lr * u`` (``s2st_tpu/train/trainer.py:231-235``) on a tree of a
  square Linear, a conv weight, a bias and a LayerNorm, against optax
  through JAX's ``build_optimizer``: parameters and every state leaf within
  an absolute 2e-6 plus a relative 2e-5 (fp32, a few ulps a step, scaled
  by the update);
- the state written by JAX's ``save_checkpoint_file`` restores into the
  port, and the port's ``state_flat`` restores into JAX's
  ``restore_state``: names and shapes equal to ``flatten_tree``'s, values
  bit for bit;
- the train CLI's ``TypeError`` for ``cosine`` (a required argument JAX's
  CLI does not pass).
"""

from __future__ import annotations

import argparse
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from s2st_tpu.train import checkpoint as jckpt
from s2st_tpu.train import optim as jopt
from s2st_tpu.train.trainer import create_train_state
from s2st_tpu_torch.models.jax_bridge import jax_variables
from tests._torch_port import one_thread  # noqa: F401
from s2st_tpu_torch.train import checkpoint as pckpt
from s2st_tpu_torch.train import optim as popt

OPTIMIZERS = sorted(popt.OPTIMIZER_REGISTRY)
LR = 3e-3
ATOL, RTOL = 2e-6, 2e-5


class Tiny(nn.Module):
    """A square Linear (factored by adafactor), a conv weight (factored
    along its two largest axes in JAX's (K, in, out) layout), biases and a
    LayerNorm (not factored)."""

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(130, 130)
        self.conv = nn.Conv1d(129, 136, 3)
        self.layer_norm = nn.LayerNorm(136)


def _model(seed=0):
    torch.manual_seed(seed)
    m = Tiny()
    with torch.no_grad():
        m.layer_norm.weight.normal_(1.0, 0.1)
        m.layer_norm.bias.normal_(0.0, 0.1)
    return m


def _grads(model, step):
    g = torch.Generator().manual_seed(100 + step)
    return [torch.randn(p.shape, generator=g) * 0.01
            for p in model.parameters()]


def _entries(model):
    return pckpt._param_entries(model)


def _jax_tree(flat_by_key):
    """{params::a::b: arr} -> the JAX params tree."""
    out = {}
    for key, arr in flat_by_key.items():
        node = out
        *parents, leaf = key.split("::")[1:]
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _jax_grads(model, grads):
    from s2st_tpu_torch.models.jax_bridge import _to_jax
    return _jax_tree({key: _to_jax(g, kind) for g, (_, key, kind)
                      in zip(grads, _entries(model))})


def _run_both(name, n=3):
    model = _model()
    trainer = types.SimpleNamespace(model=model, step=0)
    params = [p for p in model.parameters()]
    kinds = [kind for _, _, kind in _entries(model)]
    trainer.optimizer = popt.build_optimizer(name, params, kinds)
    variables = jax_variables(model)
    tx = jopt.build_optimizer(name)
    jparams = variables["params"]
    jstate = tx.init(jparams)
    for step in range(n):
        grads = _grads(model, step)
        jg = _jax_grads(model, grads)
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = jax.tree_util.tree_map(
            lambda p, u: p - jnp.float32(LR) * u, jparams, updates)
        with torch.no_grad():
            trainer.optimizer.step(grads, LR)
        trainer.step += 1
    return trainer, jparams, jstate, tx, variables


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_three_updates_match_optax(name):
    trainer, jparams, jstate, _, _ = _run_both(name)
    got = pckpt.state_flat(trainer)
    want = jckpt.flatten_tree(jparams, "params::")
    want.update(jckpt.flatten_tree(jstate, "opt::"))
    assert sorted(k for k in got if not k.startswith("stats")) == \
        sorted(want), name
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_state_round_trip_with_jax(name, tmp_path):
    trainer, jparams, jstate, tx, variables = _run_both(name, n=2)
    # JAX -> port
    jax_path = str(tmp_path / "jax.npz")
    state = create_train_state({"params": jparams, "stats": {}}, tx)
    state = type(state)(params=jparams, stats={}, opt_state=jstate,
                        step=jnp.asarray(2, jnp.int32))
    jckpt.save_checkpoint_file(jax_path, state, {"epoch": 1})
    fresh = types.SimpleNamespace(model=_model(seed=1), step=0)
    kinds = [kind for _, _, kind in _entries(fresh.model)]
    fresh.optimizer = popt.build_optimizer(
        name, list(fresh.model.parameters()), kinds)
    pckpt.restore_state(fresh, jax_path)
    assert fresh.step == 2 and fresh.optimizer.count == (
        2 if fresh.optimizer.has_count else 0)
    got = pckpt.state_flat(fresh)
    want = jckpt.load_checkpoint_file(jax_path)[0]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            np.array_equal(got[k], want[k]), k
    # port -> JAX
    port_path = str(tmp_path / "port.npz")
    pckpt.save_checkpoint_files([port_path], got, {"step": 2, "epoch": 1})
    template = create_train_state(
        {"params": variables["params"], "stats": {}}, tx)
    restored, meta = jckpt.restore_state(template, port_path)
    assert int(restored.step) == 2 and meta["epoch"] == 1
    back = jckpt.flatten_tree(restored.opt_state, "opt::")
    back.update(jckpt.flatten_tree(restored.params, "params::"))
    for k, v in back.items():
        assert np.array_equal(v, want[k]), k


def _sched_args(**kw):
    base = dict(lr="0.002", lr_scheduler="inverse_sqrt", warmup_updates=40,
                warmup_init_lr=-1.0, epoch2lr="{}", update2lr="{}")
    base.update(kw)
    return argparse.Namespace(**base)


SCHEDULES = [
    ("inverse_sqrt", dict(warmup_updates=40, warmup_init_lr=1e-5)),
    ("fixed", dict(warmup_updates=40)),
    ("polynomial_decay", dict(total_num_update=20000, warmup_updates=40,
                              end_learning_rate=1e-5, power=2.0)),
    ("cosine", dict(warmup_updates=40, max_update=50000, min_lr=1e-6)),
    ("tri_stage", dict(warmup_steps=40, hold_steps=100, decay_steps=30000)),
    ("step", dict(warmup_updates=40, decay_updates=3000, decay_factor=0.7)),
    ("triangular", dict(warmup_updates=40, period=700)),
    ("pass_through", dict(warmup_updates=40)),
    ("reduce_lr_on_plateau", dict(warmup_updates=40)),
    ("reduce_on_plateau", dict(warmup_updates=40)),
    ("manual", dict(update2lr={5: 1e-3, 39: 5e-4, 10000: 1e-4})),
]


@pytest.mark.parametrize("name,kw", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(name, kw):
    assert set(popt.SCHEDULE_REGISTRY) == {s[0] for s in SCHEDULES}
    port = popt.build_schedule(name, 2e-3, **kw)
    ref = jopt.build_schedule(name, 2e-3, **kw)
    for n in (0, 1, 39, 40, 10 ** 4, 10 ** 5):
        assert port(n) == pytest.approx(float(ref(n)), rel=1e-6,
                                        abs=1e-12), (name, n)


def test_manual_lr_grammar_matches_jax():
    for s in ("{}", "{'1,2,3': 0.5}", "{'3-10': 2e-4, 12: 1e-4}",
              '{"5": 1, "7-8": 0.25, "9,11": 3}'):
        assert popt.parse_manual_lr_dict(s) == jopt.parse_manual_lr_dict(s)
    e2l = jopt.parse_manual_lr_dict("{'1,2': 1e-3, '3-10': 2e-4}")
    u2l = jopt.parse_manual_lr_dict("{'50-60': 7e-4, 200: 1e-5}")
    port = popt.manual_lr_host(3e-3, e2l, u2l)
    ref = jopt.manual_lr_host(3e-3, e2l, u2l)
    for epoch in (0, 1, 2, 3, 10, 11):
        for n in (0, 49, 50, 60, 61, 199, 200, 5000):
            assert port(epoch, n) == ref(epoch, n), (epoch, n)
    with pytest.raises(ValueError):
        popt.manual_schedule(1e-3, epoch2lr={1: 1e-3})


@pytest.mark.parametrize("name", ["polynomial_decay", "cosine", "tri_stage"])
def test_cli_schedules_missing_arguments_raise_as_jax(name):
    args = _sched_args(lr_scheduler=name)
    with pytest.raises(TypeError) as port_err:
        popt.schedule_from_args(args)
    with pytest.raises(TypeError) as jax_err:
        jopt.build_schedule(name, 2e-3, warmup_updates=40)
    assert str(port_err.value).split("(")[-1] == \
        str(jax_err.value).split("(")[-1]


def test_manual_cli_drives_lr_scale_over_pass_through():
    args = _sched_args(lr_scheduler="manual", epoch2lr="{'2-3': 1e-3}",
                       update2lr="{'10': 5e-4}")
    sched = popt.schedule_from_args(args)
    manual = popt.manual_lr_from_args(args)
    assert sched(1) == sched(10 ** 5) == 2e-3
    assert manual(1, 0) == 2e-3 and manual(2, 3) == 1e-3
    assert manual(3, 10) == 5e-4
    assert popt.manual_lr_from_args(_sched_args()) is None
