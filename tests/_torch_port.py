"""Shared helpers of the tests that hold s2st_tpu_torch against s2st_tpu:
the same tiny config on both sides and the same weights, carried across by
the port's JAX bridge. Every comparison runs fp32 on the CPU."""

import atexit
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from s2st_tpu_torch.models.jax_bridge import load_jax_variables
from s2st_tpu_torch.models.s2st_transformer import S2STConfig, S2STTransformer

# The JAX package's CLIs, which these tests and the package's own call, put
# JAX's persistent compilation cache under ~/.cache/s2st_tpu, where it
# outlives the test run. Every process that imports this module (each pytest
# worker collects it) gets a cache of its own, removed at exit, so no test
# loads an executable that an earlier run compiled: the insertion
# transformer's 8-device CPU train step, loaded from that cache, stalls in
# XLA's collective rendezvous and aborts the process
# (tests/test_insertion.py::test_insertion_e2e).
JAX_CACHE_DIR = tempfile.mkdtemp(prefix="s2st_xla_cache_")
atexit.register(shutil.rmtree, JAX_CACHE_DIR, ignore_errors=True)
os.environ["S2ST_TPU_COMPILATION_CACHE_DIR"] = JAX_CACHE_DIR


def port_cfg(jax_cfg, **overrides) -> S2STConfig:
    """The port's config with every field the JAX config shares, fp32."""
    names = {f.name for f in dataclasses.fields(S2STConfig)} - {"dtype"}
    vals = {n: getattr(jax_cfg, n) for n in names if hasattr(jax_cfg, n)}
    return S2STConfig(dtype=torch.float32, **vals).replace(**overrides)


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_model(jax_cfg, variables, **overrides) -> S2STTransformer:
    """Port model on the CPU holding the JAX variables (strict load)."""
    model = S2STTransformer(port_cfg(jax_cfg, **overrides))
    load_jax_variables(model, numpy_tree(variables))
    return model.eval()


def t(x, dtype=None):
    """numpy -> torch (CPU)."""
    out = torch.from_numpy(np.array(x, order="C"))
    return out if dtype is None else out.to(dtype)
