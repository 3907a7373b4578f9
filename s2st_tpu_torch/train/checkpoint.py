"""Training checkpoints in the JAX package's layout.

The port's own copy of ``s2st_tpu/train/checkpoint.py``:

- one ``.npz`` a checkpoint, its keys the ``::``-joined tree paths of the
  parameters (``params::``), the postnet's running statistics
  (``stats::``) and Adam's state (``opt::0::.count``, ``opt::0::.mu::<the
  parameter's path>``, ``opt::0::.nu::...``; bf16 moments as 2-byte void,
  as numpy writes ml_dtypes' bfloat16), with a ``__meta__`` member of JSON
  bytes (``_flatten_state``, :102-122); ``models/jax_bridge.py`` maps the
  names and layouts;
- ``save_checkpoint_files`` (:125-152): one write under a temporary name
  and ``os.replace``, then a hard link (or a copy) for each other name;
- ``load_checkpoint_file`` / ``peek_meta`` (:164-180) and
  ``restore_state`` (:182-224): the parameters always, the statistics
  where the file has them, Adam's state and the step unless
  ``reset_optimizer``;
- ``CheckpointManager`` (:368-496), synchronous: ``checkpoint{epoch}``,
  ``checkpoint_{epoch}_{updates}``, ``checkpoint_last``, the best files
  when a validation metric is given, and the retention of
  ``keep_last_epochs``, ``keep_interval_updates`` and
  ``keep_best_checkpoints``;
- ``average_checkpoints`` (:498-522): the parameters' mean accumulated in
  fp64 and cast to the last file's dtypes, with the last file's
  statistics, optimizer state and meta.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.jax_bridge import SEP, flatten_tree, jax_layout, jax_variables

logger = logging.getLogger(__name__)

OPT = "opt" + SEP + "0" + SEP + "."
OPT_COUNT = OPT + "count"
_BF16_BITS = np.dtype("V2")


def _to_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return t.t()
    if kind == "conv":
        return t.permute(2, 1, 0)
    if kind == "heads_k":
        return t[:, 0, :]
    return t


def _from_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "heads_k":
        return t[:, None, :]
    return _to_jax_layout(t, kind)


def _host(t: torch.Tensor, kind: str) -> np.ndarray:
    """A moment in the JAX layout on the host; bf16 as 2-byte void."""
    t = _to_jax_layout(t.detach(), kind).contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _tensor(arr: np.ndarray, kind: str) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return _from_jax_layout(t, kind)


def _param_entries(model) -> List[Tuple[str, str, str]]:
    """(name, JAX key, kind) of each trained parameter, in the order of
    ``model.parameters()`` (the optimizer's)."""
    layout = {name: (key, kind) for name, key, kind in jax_layout(model)}
    return [(name,) + layout[name] for name, p in model.named_parameters()
            if p.requires_grad]


def opt_key(moment: str, param_key: str) -> str:
    """``params::a::b`` -> ``opt::0::.mu::a::b``."""
    return OPT + moment + SEP + param_key.split(SEP, 1)[1]


def state_flat(trainer) -> Dict[str, np.ndarray]:
    """The trainer's parameters, statistics and Adam state as flat host
    arrays in the JAX layout."""
    flat = flatten_tree(jax_variables(trainer.model))
    opt = trainer.optimizer
    flat[OPT_COUNT] = np.asarray(opt.count, np.int32)
    for i, (_, key, kind) in enumerate(_param_entries(trainer.model)):
        flat[opt_key("mu", key)] = _host(opt.mu[i], kind)
        flat[opt_key("nu", key)] = _host(opt.nu[i], kind)
    return flat


def ema_flat(trainer, ema: Sequence[torch.Tensor]) -> Dict[str, np.ndarray]:
    """An evaluation checkpoint of the EMA shadow: its parameters and the
    model's current statistics (``cli/train.py::save_ema``, :409-421)."""
    flat = flatten_tree({"stats": jax_variables(trainer.model)["stats"]})
    for t, (_, key, kind) in zip(ema, _param_entries(trainer.model)):
        flat[key] = _host(t, kind)
    return flat


def load_ema(trainer, ema: Sequence[torch.Tensor], path: str) -> None:
    flat, _ = load_checkpoint_file(path)
    with torch.no_grad():
        for t, (_, key, kind) in zip(ema, _param_entries(trainer.model)):
            if key not in flat:
                raise KeyError(f"{path} lacks {key}")
            t.copy_(_tensor(flat[key], kind))


def write_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """np.savez under a temporary name, then os.replace."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_checkpoint_files(paths: Sequence[str], flat: Dict[str, np.ndarray],
                          meta: Dict) -> None:
    """Write one state under several names: one write, then a link (or a
    copy where the file system refuses links) for each other name."""
    flat = dict(flat)
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                     dtype=np.uint8)
    first = paths[0]
    write_npz(first, flat)
    logger.info(f"saved checkpoint to {first} (step {meta.get('step')})")
    for path in paths[1:]:
        tmp = path + ".tmp.npz"
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
            os.link(first, tmp)
        except OSError:
            shutil.copyfile(first, tmp)
        os.replace(tmp, path)
        logger.info(f"saved checkpoint to {path} (step {meta.get('step')})")


def _meta(z) -> Dict:
    return json.loads(bytes(z["__meta__"].tobytes()).decode("utf-8")) \
        if "__meta__" in z.files else {}


def peek_meta(path: str) -> Dict:
    with np.load(path, allow_pickle=False) as z:
        return _meta(z)


def load_checkpoint_file(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}, _meta(z)


@torch.no_grad()
def restore_state(trainer, path: str, reset_optimizer: bool = False
                  ) -> Dict:
    """Load a checkpoint into the trainer's model and optimizer; returns
    its meta. Every parameter must be in the file; statistics and moments
    it lacks keep their values. ``reset_optimizer`` keeps the optimizer's
    state and the step as they are."""
    flat, meta = load_checkpoint_file(path)
    model = trainer.model
    current = model.state_dict()
    sd = {}
    for name, key, kind in jax_layout(model):
        if key in flat:
            sd[name] = _tensor(flat[key], kind).to(current[name].dtype)
        elif key.startswith("params" + SEP):
            raise KeyError(f"checkpoint missing {key}")
    model.load_state_dict(sd, strict=False)
    if not reset_optimizer:
        opt = trainer.optimizer
        for i, (_, key, kind) in enumerate(_param_entries(model)):
            for moment, dst in (("mu", opt.mu[i]), ("nu", opt.nu[i])):
                arr = flat.get(opt_key(moment, key))
                if arr is not None:
                    dst.copy_(_tensor(arr, kind))
        if OPT_COUNT in flat:
            opt.count = int(flat[OPT_COUNT])
        trainer.step = int(meta.get("step", 0))
    return meta


class CheckpointManager:
    """The save dir's files and their retention, written synchronously."""

    def __init__(self, save_dir: str, best_checkpoint_metric: str = "loss",
                 maximize_best_checkpoint_metric: bool = False,
                 keep_best_checkpoints: int = -1, keep_last_epochs: int = -1,
                 keep_interval_updates: int = -1,
                 no_epoch_checkpoints: bool = False):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.metric = best_checkpoint_metric
        self.maximize = maximize_best_checkpoint_metric
        self.keep_best = keep_best_checkpoints
        self.keep_last_epochs = keep_last_epochs
        self.keep_interval_updates = keep_interval_updates
        self.no_epoch_checkpoints = no_epoch_checkpoints
        self.best: Optional[float] = None
        probe = self.save_dir / ".writability_probe"
        probe.write_text("ok")
        probe.unlink()

    def save(self, flat: Dict[str, np.ndarray], step: int, epoch: int,
             val_metric: Optional[float] = None, end_of_epoch: bool = True,
             num_updates: Optional[int] = None,
             extra_meta: Optional[Dict] = None) -> List[str]:
        """Write one state under every name it takes; returns the paths."""
        meta = dict(extra_meta or {})
        meta["epoch"] = epoch
        targets = []
        if val_metric is not None:
            meta["val_metric"] = float(val_metric)
            if self.best is None or (val_metric > self.best if self.maximize
                                     else val_metric < self.best):
                self.best = float(val_metric)
                targets.append("checkpoint_best.npz")
        wrote_epoch = end_of_epoch and not self.no_epoch_checkpoints
        if wrote_epoch:
            targets.append(f"checkpoint{epoch}.npz")
        wrote_interval = not end_of_epoch and num_updates is not None
        if wrote_interval:
            targets.append(f"checkpoint_{epoch}_{num_updates}.npz")
        if val_metric is not None and self.keep_best > 0:
            targets.append(f"checkpoint.best_{self.metric}_"
                           f"{val_metric:.3f}.{step}.npz")
        targets.append("checkpoint_last.npz")
        meta["step"] = step
        paths = [str(self.save_dir / t) for t in targets]
        save_checkpoint_files(paths, flat, meta)
        if wrote_epoch:
            self._gc(r"checkpoint(\d+)\.npz", 1, self.keep_last_epochs)
        if wrote_interval:
            self._gc(r"checkpoint_(\d+)_(\d+)\.npz", 2,
                     self.keep_interval_updates)
        if val_metric is not None and self.keep_best > 0:
            self._gc_best()
        return paths

    def _gc(self, pattern: str, group: int, keep: int) -> None:
        """Keep the ``keep`` files of the pattern with the highest number
        in ``group``."""
        if keep <= 0:
            return
        found = []
        for p in self.save_dir.iterdir():
            mt = re.fullmatch(pattern, p.name)
            if mt:
                found.append((int(mt.group(group)), p))
        for _, p in sorted(found)[:-keep]:
            p.unlink()

    def _gc_best(self) -> None:
        pat = re.compile(rf"checkpoint\.best_{re.escape(self.metric)}_"
                         rf"(-?[\d.]+)\.(\d+)\.npz")
        scored = []
        for p in self.save_dir.iterdir():
            mt = pat.fullmatch(p.name)
            if mt:
                scored.append((float(mt.group(1)), p))
        scored.sort(key=lambda x: x[0], reverse=self.maximize)
        for _, p in scored[self.keep_best:]:
            p.unlink()

    def last_checkpoint(self) -> Optional[str]:
        p = self.save_dir / "checkpoint_last.npz"
        return str(p) if p.is_file() else None


def average_checkpoints(paths: Sequence[str]) -> Dict[str, np.ndarray]:
    """The mean of the files' parameters (fp64 sums of each over n, cast
    to the last file's dtype); every other member, and the meta, from the
    last file."""
    acc: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, np.dtype] = {}
    meta: Dict = {}
    n = len(paths)
    for path in paths:
        flat, meta = load_checkpoint_file(path)
        for k, v in flat.items():
            if k.startswith("params" + SEP) and \
                    np.issubdtype(v.dtype, np.floating):
                acc[k] = acc.get(k, 0) + v.astype(np.float64) / n
                dtypes[k] = v.dtype
            else:
                acc[k] = v
    out = {k: np.asarray(v, dtype=dtypes[k]) if k in dtypes
           else np.asarray(v) for k, v in acc.items()}
    out["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                    dtype=np.uint8)
    return out
