"""fairseq ``.pt`` checkpoints: the tolerant reader and the S2ST model.

``read_torch_checkpoint`` loads a fairseq checkpoint with ``torch.load``
and needs neither fairseq nor omegaconf: classes of modules that are not
installed unpickle as plain records (``_Absent``), and ``plain`` turns a
config of such records into dicts and lists.

The S2ST model's modules carry fairseq's ``state_dict`` names, the names
``s2st_tpu/models/torch_import.py::to_fairseq_state_dict`` (:599) writes,
so a fairseq S2ST checkpoint loads into the model without a map, the MTL
variant's ``decoder.ctc_proj_tgt`` (:151-152) with it; so do the T2S
model's (``t2s_from_fairseq``, JAX's ``t2s_from_fairseq_state_dict``,
:242-277), and Tacotron2's and FastSpeech2's (``tacotron2_from_fairseq``,
``fs2_from_fairseq``, :503-558 and :304-337, for callers that ask for
them), whose BatchNorm counts are 0 where the file has none. As JAX's
``load_fairseq_checkpoint`` and ``from_fairseq_state_dict`` (:174-218) do,
``s2st_state_dict`` takes ``state["model"]`` (or the dict itself) as fp32
and drops ``hubert.*``; ``s2st_from_fairseq`` loads the rest into the
model of the command line's flags (JAX's ``model_args_from_checkpoint``
leaves the namespace as it is for a ``.pt``, options.py:2371-2400), with
the vocabularies, the speaker count and the heads (aux ASR and ST
decoders, CTC) the file's arrays give, and logs the keys the model has no
place for, ``_float_tensor`` and ``version`` entries aside. A key the
model needs and the file lacks raises.
"""

from __future__ import annotations

import argparse
import logging
import pickle
import types
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)


class _Absent:
    """Unpickles an instance of a class whose module is not installed
    (omegaconf's DictConfig and nodes, fairseq's dataclasses). Pickle may
    restore one without calling ``__init__``, hence the class defaults."""

    args: tuple = ()
    state: Any = None

    def __init__(self, *args, **kwargs):
        self.args, self.state = args, kwargs or None

    def __setstate__(self, state):
        self.state = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_Absent,), {"__module__": module})


_pickle = types.ModuleType("s2st_tpu_torch_pickle")
_pickle.Unpickler = _Unpickler
_pickle.load = lambda f, **kw: _Unpickler(f, **kw).load()


def plain(x):
    """Nested dicts and lists from a config that may hold unpickled
    omegaconf containers (``_content``) and value nodes (``_val``)."""
    if isinstance(x, _Absent):
        state = x.state
        if isinstance(state, tuple) and state and isinstance(state[-1], dict):
            state = state[-1]
        if isinstance(state, dict):
            if "_content" in state:
                return plain(state["_content"])
            if "_val" in state:
                return plain(state["_val"])
            return {k: plain(v) for k, v in state.items()}
        return plain(x.args[0]) if x.args else None
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def read_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A fairseq ``.pt`` as a dict, with or without omegaconf installed."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_pickle)


def is_torch_checkpoint(path: str) -> bool:
    return path.endswith((".pt", ".bin"))


def s2st_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The S2ST model's entries of a fairseq checkpoint: ``state["model"]``
    or the dict itself, floats as fp32, without ``hubert.*``."""
    state = read_torch_checkpoint(path)
    sd = state.get("model", state)
    hub = [k for k in sd if k.startswith("hubert.")]
    if hub:
        logger.info(f"{len(hub)} hubert.* keys present; the frontend loads "
                    f"from its own checkpoint")
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            for k, v in sd.items()
            if torch.is_tensor(v) and not k.startswith("hubert.")}


def s2st_config(sd: Dict[str, torch.Tensor], args: argparse.Namespace,
                input_feat_per_channel: int,
                speakers: Optional[int] = None):
    """The model config of the flags in ``args`` with the vocabularies,
    speaker count (unless ``speakers`` is given) and heads of ``sd``."""
    from .config_from_args import model_config

    def rows(key: str, default: int = 0) -> int:
        return int(sd[key].shape[0]) if key in sd else default

    src = rows("aux_asr_decoder.embed_tokens.weight") \
        or rows("decoder.ctc_proj.weight", 100)
    tgt = rows("aux_st_decoder.embed_tokens.weight") \
        or rows("decoder.ctc_proj_tgt.weight", 100)
    if speakers is None:
        speakers = rows("encoder.embed_speaker.weight")
    return model_config(args, src, tgt, input_feat_per_channel,
                        num_speakers=speakers).replace(
        aux_asr="aux_asr_decoder.embed_tokens.weight" in sd,
        aux_st="aux_st_decoder.embed_tokens.weight" in sd,
        ctc="decoder.ctc_proj.weight" in sd,
        ctc_tgt="decoder.ctc_proj_tgt.weight" in sd)


def s2st_from_fairseq(cfg, sd: Dict[str, torch.Tensor]):
    """A model of ``cfg`` holding the fairseq entries ``sd``."""
    from .s2st_transformer import S2STTransformer
    model = S2STTransformer(cfg)
    if model.encoder.hubert is not None:
        pre = "encoder.hubert."
        model.encoder.hubert.carry_pretraining(
            {k[len(pre):]: tuple(v.shape) for k, v in sd.items()
             if k.startswith(pre)})
    return _load(model, sd)


def t2s_from_fairseq(cfg, sd: Dict[str, torch.Tensor]):
    """A T2S model of ``cfg`` (a ``T2SConfig``) holding the fork's
    ``t2s_transformer`` entries ``sd``; a BatchNorm without
    ``num_batches_tracked`` counts 0."""
    from .t2s_transformer import T2STransformer
    return _load_counting(T2STransformer(cfg), sd)


def tacotron2_from_fairseq(cfg, sd: Dict[str, torch.Tensor]):
    """A Tacotron2 of ``cfg`` holding fairseq ``tacotron2`` entries ``sd``
    (JAX's ``tacotron2_from_fairseq_state_dict``, :503-558): the
    never-applied ``decoder.ctc_proj`` is dropped, a BatchNorm without
    ``num_batches_tracked`` counts 0."""
    from .tacotron2 import Tacotron2
    sd = {k: v for k, v in sd.items() if not k.startswith("decoder.ctc_proj.")}
    return _load_counting(Tacotron2(cfg), sd)


def fs2_from_fairseq(cfg, sd: Dict[str, torch.Tensor]):
    """A FastSpeech2 of ``cfg`` holding fairseq ``fastspeech2`` entries
    ``sd`` (JAX's ``fs2_from_fairseq_state_dict``, :304-337); the alphas
    keep fairseq's (1,) shape, a BatchNorm without
    ``num_batches_tracked`` counts 0."""
    from .fastspeech2 import FastSpeech2
    return _load_counting(FastSpeech2(cfg), sd)


def _load_counting(model, sd: Dict[str, torch.Tensor]):
    """``_load`` with a count of 0 for each BatchNorm the file gives
    none."""
    counts = {k: torch.zeros((), dtype=torch.long)
              for k in model.state_dict()
              if k.endswith("num_batches_tracked") and k not in sd}
    return _load(model, {**sd, **counts})


def _load(model, sd: Dict[str, torch.Tensor]):
    """``model`` with the entries of ``sd`` loaded strictly; a missing
    entry raises, one the model has no place for is logged."""
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"the checkpoint lacks {missing[:6]}"
                       f"{'...' if len(missing) > 6 else ''}")
    leftover = [k for k in sd if k not in own
                and not k.endswith("_float_tensor") and "version" not in k]
    if leftover:
        logger.warning(f"unmapped checkpoint keys: {leftover[:10]}"
                       f"{'...' if len(leftover) > 10 else ''}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    return model


__all__ = ["read_torch_checkpoint", "plain", "is_torch_checkpoint",
           "s2st_state_dict", "s2st_config", "s2st_from_fairseq",
           "t2s_from_fairseq", "tacotron2_from_fairseq", "fs2_from_fairseq"]
