"""Read a Hugging Face model directory without any HF package.

- ``resolve_model_dir``: a directory as given, else a hub id (``org/name``)
  looked up in the local hub cache, as ``from_pretrained`` resolves it
  offline: ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
  ``$XDG_CACHE_HOME/huggingface/hub`` (``~/.cache`` without it); inside it
  ``models--<org>--<name>/snapshots/<the commit in refs/main>/``. Nothing
  is downloaded.
- ``read_config``: ``config.json``.
- ``read_state_dict``: the weights, from ``model.safetensors`` (read here:
  an 8-byte little-endian header length, a JSON header of ``{name:
  {dtype, shape, data_offsets}}`` and ``__metadata__``, then the raw
  little-endian data, memory-mapped; F32, F16 and BF16), else
  ``pytorch_model.bin`` (``torch.load(weights_only=True)``, memory-mapped),
  as ``from_pretrained`` prefers them. Every tensor comes back in fp32.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict

import numpy as np
import torch

_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2"}


def hub_cache() -> Path:
    """The hub cache directory ``huggingface_hub`` reads."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"]).expanduser()
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME")
        or os.path.join(os.path.expanduser("~"), ".cache"), "huggingface")
    return Path(home).expanduser() / "hub"


def resolve_model_dir(path_or_id: str) -> Path:
    """The directory holding a model's files: ``path_or_id`` itself, or the
    snapshot of hub id ``path_or_id`` that ``refs/main`` names in the
    cache. Raises FileNotFoundError when neither exists."""
    path = Path(path_or_id).expanduser()
    if path.is_dir():
        return path
    repo = hub_cache() / ("models--" + str(path_or_id).replace("/", "--"))
    ref = repo / "refs" / "main"
    if ref.is_file():
        snapshot = repo / "snapshots" / ref.read_text().strip()
        if snapshot.is_dir():
            return snapshot
    raise FileNotFoundError(f"{path_or_id} is neither a directory nor a "
                            f"model in the hub cache {hub_cache()}")


def read_config(model_dir: Path) -> dict:
    with open(Path(model_dir) / "config.json", encoding="utf-8") as f:
        return json.load(f)


def read_safetensors(path: Path) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, in fp32: each converted
    once from a memory map of the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, rec in header.items():
        if name == "__metadata__":
            continue
        if rec["dtype"] not in _SAFETENSORS_DTYPES:
            raise NotImplementedError(f"{path}: {name} is {rec['dtype']}; "
                                      f"F32, F16 and BF16 are read")
        start, end = rec["data_offsets"]
        raw = data[start:end].view(_SAFETENSORS_DTYPES[rec["dtype"]])
        if rec["dtype"] == "BF16":      # a bf16 is an fp32's upper half
            arr = (raw.astype("<u4") << 16).view("<f4")
        else:
            arr = raw.astype(np.float32)
        out[name] = torch.from_numpy(arr.reshape(rec["shape"]))
    return out


def read_state_dict(model_dir: Path) -> Dict[str, torch.Tensor]:
    """The model's weights in fp32, by ``from_pretrained``'s order of
    preference: safetensors, then the PyTorch pickle."""
    root = Path(model_dir)
    if (root / "model.safetensors").is_file():
        return read_safetensors(root / "model.safetensors")
    if (root / "pytorch_model.bin").is_file():
        sd = torch.load(root / "pytorch_model.bin", map_location="cpu",
                        weights_only=True, mmap=True)
        return {k: v.float() for k, v in sd.items()}
    raise FileNotFoundError(f"{root} holds neither model.safetensors nor "
                            f"pytorch_model.bin")


__all__ = ["hub_cache", "resolve_model_dir", "read_config",
           "read_safetensors", "read_state_dict"]
