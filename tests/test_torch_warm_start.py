"""s2st_tpu_torch's component warm start against s2st_tpu's, on the CPU.

``train/checkpoint.py::load_pretrained_component`` against JAX's
``load_pretrained_component`` (s2st_tpu/train/checkpoint.py:272-298) on
the tiny config of ``tests/conftest.py``, dropout off:

- an S2T checkpoint's encoder into an S2ST model without aux decoders
  (the mix-tuning recipe's second stage) from a ``.npz``;
- an S2ST checkpoint's encoder and decoder into another S2ST model (the
  pretraining recipe's second stage and prompt tuning) from a ``.npz`` and
  from a fairseq ``.pt`` (JAX's ``to_fairseq_state_dict``);

after which every parameter and statistic of the two models is equal, bit
for bit (a warm start copies: no arithmetic), the components not named
and the postnet's statistics as they were. JAX's raising cases raise the
same class in the port: a ``.npz`` without a leaf of the component
(``KeyError``: an S2T encoder lacks the aux norms and the speaker table
of an S2ST encoder with aux decoders or speakers), a leaf of another shape
(``ValueError``), a ``.pt`` whose component holds other entries or
shapes (``ValueError``) and an S2T ``.pt`` (``KeyError``: JAX reads every
``.pt`` as an S2ST checkpoint).
"""

import json

import jax
import numpy as np
import pytest
import torch

from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.models import s2t_transformer as js2t
from s2st_tpu.models.torch_import import to_fairseq_state_dict
from s2st_tpu.train import checkpoint as jckpt
from s2st_tpu_torch.models.jax_bridge import flatten_tree
from s2st_tpu_torch.train.checkpoint import load_pretrained_component
from tests._torch_port import numpy_tree, port_model
from tests.test_torch_s2t import DEC, port_s2t
from tests.test_torch_train import NO_DROPOUT, jax_leaves, port_leaves


@pytest.fixture(scope="module")
def cfgs(tiny_cfg):
    base = tiny_cfg.replace(**NO_DROPOUT)
    return {"aux": base,
            "noaux": base.replace(aux_asr=False, aux_st=False),
            "speakers": base.replace(aux_asr=False, aux_st=False,
                                     num_speakers=2, speaker_embed_dim=16,
                                     speaker_embed_dim_dec=8),
            "wide": base.replace(encoder_ffn_embed_dim=48),
            "s2t": js2t.S2TConfig(base=base.replace(aux_asr=False,
                                                    aux_st=False), **DEC)}


def init(cfg, seed):
    if isinstance(cfg, js2t.S2TConfig):
        return js2t.init_s2t(jax.random.PRNGKey(seed), cfg,
                             vocab_size=cfg.base.tgt_vocab_size)
    return jm.init_s2st(jax.random.PRNGKey(seed), cfg)


def save_npz(path, variables):
    flat = flatten_tree({"params": numpy_tree(variables["params"]),
                         "stats": numpy_tree(variables["stats"])})
    flat["__meta__"] = np.frombuffer(json.dumps({"step": 0}).encode(),
                                     np.uint8)
    np.savez(path, **flat)
    return str(path)


def save_pt(path, variables):
    sd = to_fairseq_state_dict(numpy_tree(variables))
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, str(path))
    return str(path)


def save_s2t_pt(path, jcfg, variables):
    """An S2T model's fairseq-named state dict (the port's modules carry
    fairseq's names)."""
    model = port_s2t(jcfg, variables, jcfg.base.tgt_vocab_size)
    torch.save({"model": model.state_dict()}, str(path))
    return str(path)


def jax_all(variables):
    return {**jax_leaves(variables["params"], "params"),
            **jax_leaves(variables["stats"], "stats")}


@pytest.mark.parametrize("case", ["s2t_encoder_npz", "s2st_npz", "s2st_pt"])
def test_warm_start_equals_jax(cfgs, case, tmp_path):
    if case == "s2t_encoder_npz":
        dst_cfg, comps = cfgs["noaux"], ("encoder",)
        path = save_npz(tmp_path / "src.npz", init(cfgs["s2t"], 1))
    else:
        dst_cfg, comps = cfgs["aux"], ("encoder", "decoder")
        src = init(cfgs["aux"], 1)
        path = save_npz(tmp_path / "src.npz", src) if case == "s2st_npz" \
            else save_pt(tmp_path / "src.pt", src)
    dst = init(dst_cfg, 0)
    ref = dst
    model = port_model(dst_cfg, dst)
    for comp in comps:
        ref = jckpt.load_pretrained_component(ref, path, comp)
        load_pretrained_component(model, path, comp)
    want, got, before = jax_all(ref), port_leaves(model), jax_all(dst)
    assert set(got) == set(want)
    for key, v in want.items():
        assert np.array_equal(got[key], v), key
    moved = {k for k in want if not np.array_equal(want[k], before[k])}
    assert moved and all(k.split("::")[1] in comps for k in moved)


def _raising(cfgs, case, tmp_path):
    """(path, the model's config, component) of a case JAX refuses."""
    if case == "s2t_npz_into_aux":
        return save_npz(tmp_path / "s.npz", init(cfgs["s2t"], 1)), \
            cfgs["aux"], "encoder"
    if case == "s2t_npz_into_speakers":
        return save_npz(tmp_path / "s.npz", init(cfgs["s2t"], 1)), \
            cfgs["speakers"], "encoder"
    if case == "npz_shape":
        return save_npz(tmp_path / "s.npz", init(cfgs["wide"], 1)), \
            cfgs["aux"], "encoder"
    if case == "pt_entries":
        return save_pt(tmp_path / "s.pt", init(cfgs["speakers"], 1)), \
            cfgs["noaux"], "decoder"
    if case == "pt_shape":
        return save_pt(tmp_path / "s.pt", init(cfgs["wide"], 1)), \
            cfgs["aux"], "encoder"
    assert case == "s2t_pt"
    return save_s2t_pt(tmp_path / "s.pt", cfgs["s2t"],
                       init(cfgs["s2t"], 1)), cfgs["noaux"], "encoder"


@pytest.mark.parametrize("case,error", [
    ("s2t_npz_into_aux", KeyError), ("s2t_npz_into_speakers", KeyError),
    ("npz_shape", ValueError), ("pt_entries", ValueError),
    ("pt_shape", ValueError), ("s2t_pt", KeyError)])
def test_refusals_raise_as_jax(cfgs, case, error, tmp_path):
    path, cfg, comp = _raising(cfgs, case, tmp_path)
    dst = init(cfg, 0)
    with pytest.raises(error):
        jckpt.load_pretrained_component(dst, path, comp)
    with pytest.raises(error):
        load_pretrained_component(port_model(cfg, dst), path, comp)
