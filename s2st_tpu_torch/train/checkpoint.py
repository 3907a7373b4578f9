"""Training checkpoints in the JAX package's layout.

The port's own copy of ``s2st_tpu/train/checkpoint.py``:

- one ``.npz`` a checkpoint, its keys the ``::``-joined tree paths of the
  parameters (``params::``), the postnet's running statistics
  (``stats::``) and the optimizer's state under the names ``flatten_tree``
  gives optax's (Adam's ``opt::0::.count``, ``opt::0::.mu::<the
  parameter's path>``, ``opt::0::.nu::...``, bf16 moments as 2-byte void,
  as numpy writes ml_dtypes' bfloat16; adafactor's ``opt::0::.v_row::...``
  in JAX's shapes; ``opt::.trace::...`` of ``nag``; see
  ``train/optim.py``), with a ``__meta__`` member of JSON bytes
  (``_flatten_state``, :102-122); ``models/jax_bridge.py`` maps the names
  and layouts;
- ``save_checkpoint_files`` (:125-152): one write under a temporary name
  and ``os.replace``, then a hard link (or a copy) for each other name;
- ``load_checkpoint_file`` / ``peek_meta`` (:164-180) and
  ``restore_state`` (:182-224): the parameters always, the statistics
  where the file has them, the optimizer's state and the step unless
  ``reset_optimizer``;
- ``CheckpointManager`` (:368-496): ``checkpoint{epoch}``,
  ``checkpoint_{epoch}_{updates}``, ``checkpoint_last``, the best files
  when a validation metric is given, and the retention of
  ``keep_last_epochs``, ``keep_interval_updates`` and
  ``keep_best_checkpoints``; with ``write_asynchronously`` each save's
  host copy, write and retention run in one background worker
  (``AsyncWriter``, :305-342) in submission order, so ``checkpoint_last``
  is always the newest state; a worker's error is raised at the next save
  or ``wait()``, which the trainer calls before it reads the save dir and
  before it exits;
- ``StateSnapshot``: what a save reads (the model's variables, the
  optimizer's state and count, the EMA shadow). For an asynchronous save
  it holds copies on the device, made on the training stream after the
  update and fenced by an event (``_snapshot_state``, :345-361): the next
  update changes the live tensors in place (``torch._foreach_*``), never
  the copies. The worker copies them to the host on a stream of its own,
  which waits for that event only, so the copy does not queue behind the
  next update; the copies are freed once that copy is done;
- ``load_pretrained_component`` (:272-298): the warm start of one
  component from a ``.npz`` or a fairseq ``.pt``, JAX's errors included;
- ``average_checkpoints`` (:498-522): the parameters' mean accumulated in
  fp64 and cast to the last file's dtypes, with the last file's
  statistics, optimizer state and meta.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import re
import shutil
import threading
import weakref
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.jax_bridge import (SEP, _to_jax, flatten_tree, jax_layout,
                                 unflatten_tree)

logger = logging.getLogger(__name__)

OPT = "opt" + SEP + "0" + SEP + "."
OPT_COUNT = OPT + "count"
_BF16_BITS = np.dtype("V2")


def _to_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return t.t()
    if kind == "conv":
        return t.permute(2, 1, 0)
    if kind == "conv2d":
        return t.permute(2, 3, 1, 0)
    if kind == "heads_k":
        return t[:, 0, :]
    if kind == "scalar":
        return t.reshape(())
    return t


def _from_jax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "heads_k":
        return t[:, None, :]
    if kind == "conv2d":
        return t.permute(3, 2, 0, 1)
    if kind == "scalar":
        return t.reshape(1)
    return _to_jax_layout(t, kind)


def _host(t: torch.Tensor, kind: str) -> np.ndarray:
    """A moment in the JAX layout on the host; bf16 as 2-byte void."""
    t = _to_jax_layout(t.detach(), kind).contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def _tensor(arr: np.ndarray, kind: str) -> torch.Tensor:
    # ascontiguousarray makes a 0-d array 1-d: keep the file's shape
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return _from_jax_layout(t, kind)


def _param_entries(model, layout=None) -> List[Tuple[str, str, str]]:
    """(name, JAX key, kind) of each trained parameter, in the order of
    ``model.parameters()`` (the optimizer's)."""
    layout = {name: (key, kind)
              for name, key, kind in layout or jax_layout(model)}
    return [(name,) + layout[name] for name, p in model.named_parameters()
            if p.requires_grad]


# a model's layout and trained entries, taken once: the walk costs tens of
# ms, which a save would otherwise add to the training loop's stall
_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _layouts(model):
    if model not in _LAYOUTS:
        layout = jax_layout(model)
        _LAYOUTS[model] = (layout, _param_entries(model, layout))
    return _LAYOUTS[model]


def _device_copies(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Copies of ``tensors`` that later in-place updates cannot touch: one
    buffer a (device, dtype), filled by ``torch._foreach_copy_`` in a few
    launches however many tensors there are."""
    groups: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for (dev, dtype), idx in groups.items():
        sizes = [tensors[i].numel() for i in idx]
        flat = torch.empty(sum(sizes), dtype=dtype, device=dev)
        views = [v.view(tensors[i].shape)
                 for v, i in zip(flat.split(sizes), idx)]
        torch._foreach_copy_(views, [tensors[i].detach() for i in idx])
        for v, i in zip(views, idx):
            out[i] = v
    return out


def opt_key(moment: str, param_key: str, prefix: str = OPT) -> str:
    """``params::a::b`` -> ``opt::0::.mu::a::b`` (``prefix`` the
    optimizer's, ``opt::0::.`` for Adam)."""
    return prefix + moment + SEP + param_key.split(SEP, 1)[1]


def opt_entries(opt, entries) -> List[Tuple[str, torch.Tensor, str]]:
    """(checkpoint key, tensor, layout kind) of each state tensor of the
    optimizer, ``entries`` the trained parameters' (name, key, kind)."""
    same = set(opt.JAX_LAYOUT_FIELDS)
    return [(opt_key(field, key, opt.PREFIX), t,
             "same" if field in same else kind)
            for field, tensors in opt.state()
            for t, (_, key, kind) in zip(tensors, entries)]


class StateSnapshot:
    """The tensors a save reads: the model's variables (JAX key, tensor,
    layout kind), the optimizer's state and count, and, with ``ema``, the EMA
    shadow. With ``copy`` every tensor is a copy on its device that later
    updates cannot touch, and on a CUDA device an event marks where the
    copies end on the training stream."""

    def __init__(self, trainer, ema: Optional[Sequence[torch.Tensor]] = None,
                 copy: bool = False):
        model, opt = trainer.model, trainer.optimizer
        sd = model.state_dict()
        layout, entries = _layouts(model)
        self.variables = [(key, sd[name], kind)
                          for name, key, kind in layout]
        self.moments = opt_entries(opt, entries)
        self.ema = None if ema is None else [
            (key, t, kind) for t, (_, key, kind) in zip(ema, entries)]
        self.count_key = opt.PREFIX + "count" if opt.has_count else None
        self.count = int(opt.count)
        self.event = None
        if copy:
            parts = [p for p in ("variables", "moments", "ema")
                     if getattr(self, p) is not None]
            with torch.no_grad():
                copies = iter(_device_copies(
                    [t for p in parts for _, t, _ in getattr(self, p)]))
            for p in parts:
                setattr(self, p, [(k, next(copies), kind)
                                  for k, _, kind in getattr(self, p)])
            dev = self.variables[0][1].device
            if dev.type == "cuda":
                self.event = torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(dev))

    def flat(self) -> Dict[str, np.ndarray]:
        """The parameters, statistics and optimizer state as flat host
        arrays in the JAX layout."""
        flat = flatten_tree(unflatten_tree(
            {key: _to_jax(t, kind) for key, t, kind in self.variables}))
        if self.count_key is not None:
            flat[self.count_key] = np.asarray(self.count, np.int32)
        for key, t, kind in self.moments:
            flat[key] = _host(t, kind)
        return flat

    def ema_flat(self) -> Dict[str, np.ndarray]:
        """An evaluation checkpoint of the EMA shadow: its parameters and
        the model's statistics (``cli/train.py::save_ema``, :409-421)."""
        flat = flatten_tree({"stats": unflatten_tree(
            {key: _to_jax(t, kind) for key, t, kind in self.variables
             if key.startswith("stats" + SEP)}).get("stats", {})})
        for key, t, kind in self.ema:
            flat[key] = _host(t, kind)
        return flat


def state_flat(trainer) -> Dict[str, np.ndarray]:
    """The trainer's parameters, statistics and optimizer state as flat
    host arrays in the JAX layout."""
    return StateSnapshot(trainer).flat()


class AsyncWriter:
    """One background worker draining a FIFO of checkpoint writes. An
    error in a write is raised by the next ``submit`` or ``wait``. On a
    CUDA device the writes run on a stream of the worker's own."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._stream = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="checkpoint-writer")
        self._thread.start()

    def _run(self):
        while True:
            fn = self._q.get()
            try:
                fn()
            except BaseException as e:  # raised at the next submit/wait
                self._err = e
            finally:
                fn = None           # the snapshot's copies go now
                self._q.task_done()

    def _reraise(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def stream_for(self, event):
        """A context in which the worker's copies wait for ``event`` (the
        snapshot's end on the training stream) and nothing else."""
        if event is None:
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        self._stream.wait_event(event)
        return torch.cuda.stream(self._stream)

    def submit(self, fn) -> None:
        self._reraise()
        self._q.put(fn)

    def wait(self) -> None:
        self._q.join()
        self._reraise()


def load_ema(trainer, ema: Sequence[torch.Tensor], path: str) -> None:
    flat, _ = load_checkpoint_file(path)
    with torch.no_grad():
        for t, (_, key, kind) in zip(ema, _param_entries(trainer.model)):
            if key not in flat:
                raise KeyError(f"{path} lacks {key}")
            t.copy_(_tensor(flat[key], kind))


def write_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """An uncompressed ``.npz`` in np.savez's layout (a ``<key>.npy``
    member a key, version 1.0 headers) under a temporary name, then
    os.replace. Each member's data goes out in one write from the array's
    own buffer: no copy, and the interpreter lock is free while it is
    checksummed and written, so that a training loop in another thread
    keeps running (np.savez copies 16 MiB chunks under the lock)."""
    tmp = path + ".tmp.npz"
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            arr = np.asarray(arr, order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(arr.reshape(-1).view(np.uint8))
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


# what JAX's fairseq reader takes from a .pt whatever the component: it
# maps the whole file as an S2ST checkpoint and these entries without a
# default (models/torch_import.py:131-156), so a file without them (an S2T
# checkpoint) raises KeyError before any component is taken
_S2ST_PT_ENTRIES = ("decoder.prenet.1.weight", "decoder.prenet.1.bias",
                    "decoder.pos_emb_alpha", "decoder.feat_proj.weight",
                    "decoder.feat_proj.bias", "decoder.eos_proj.weight",
                    "decoder.eos_proj.bias")


def _component_names(names, component: str) -> set:
    """The entries of a component in fairseq's names, as JAX's trees hold
    them: the frontend (``params::hubert``), the postnet's batch counts
    (optional in a file) and position buffers left out."""
    return {n for n in names if n.startswith(component + ".")
            and not n.startswith("encoder.hubert.")
            and not n.endswith(("num_batches_tracked", "_float_tensor"))
            and "version" not in n}


@torch.no_grad()
def load_pretrained_component(model, path: str, component: str
                              ) -> List[str]:
    """Warm-start the parameters of one component (``encoder`` or
    ``decoder``) from a checkpoint (``load_pretrained_component``,
    s2st_tpu/train/checkpoint.py:272-298); returns the names loaded. The
    statistics, the other components and the HuBERT frontend
    (``params::hubert``) stay as they are.

    A JAX ``.npz``: every parameter of the component must be in the file,
    else KeyError (``checkpoint missing <path>``); a shape that differs
    raises ValueError; leaves of the file the model lacks are ignored
    (``unflatten_into(strict=True)``, :73-98). A fairseq ``.pt`` is read
    as an S2ST checkpoint, as JAX's reader reads it (KeyError without the
    spectrogram decoder's entries), and its entries of the component must
    be the model's, with the same shapes, else ValueError (JAX's
    ``tree_map`` over the two trees)."""
    prefix = "params" + SEP + component + SEP
    entries = sorted(((name, key, kind) for name, key, kind
                      in jax_layout(model) if key.startswith(prefix)),
                     key=lambda e: e[1])
    current = model.state_dict()
    sd = {}
    if path.endswith((".pt", ".bin")):
        from ..models.fairseq_checkpoint import s2st_state_dict
        file_sd = s2st_state_dict(path)
        for k in _S2ST_PT_ENTRIES:
            if k not in file_sd:
                raise KeyError(k)
        ours = _component_names(current, component)
        theirs = _component_names(file_sd, component)
        if ours != theirs:
            raise ValueError(
                f"{path}: the {component}'s entries differ from the model's: "
                f"missing {sorted(ours - theirs)[:4]}, extra "
                f"{sorted(theirs - ours)[:4]}")
        for name, _, _ in entries:
            sd[name] = file_sd[name]
            if tuple(sd[name].shape) != tuple(current[name].shape):
                raise ValueError(f"shape mismatch {tuple(sd[name].shape)} "
                                 f"vs {tuple(current[name].shape)}")
    else:
        flat, _ = load_checkpoint_file(path)
        for name, key, kind in entries:
            rel = key[len(prefix):]
            if key not in flat:
                raise KeyError(f"checkpoint missing {rel}")
            sd[name] = _tensor(flat[key], kind)
            if tuple(sd[name].shape) != tuple(current[name].shape):
                raise ValueError(
                    f"shape mismatch for {rel}: ckpt {tuple(flat[key].shape)}"
                    f" vs model {tuple(current[name].shape)}")
    model.load_state_dict({n: t.to(current[n].dtype) for n, t in sd.items()},
                          strict=False)
    return list(sd)


@torch.no_grad()
def restore_state(trainer, path: str, reset_optimizer: bool = False
                  ) -> Dict:
    """Load a checkpoint into the trainer's model and optimizer; returns
    its meta. Every parameter must be in the file; statistics and
    optimizer state it lacks keep their values (JAX's ``strict=False``),
    and a state tensor of another shape raises ValueError.
    ``reset_optimizer`` keeps the optimizer's state and the step as they
    are."""
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
        for key, dst, kind in opt_entries(opt, _param_entries(model)):
            arr = flat.get(key)
            if arr is not None:
                src = _tensor(arr, kind)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"shape mismatch for {key}: ckpt "
                                     f"{tuple(arr.shape)} vs optimizer "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
        if opt.has_count and opt.PREFIX + "count" in flat:
            opt.count = int(flat[opt.PREFIX + "count"])
        trainer.step = int(meta.get("step", 0))
    return meta


class CheckpointManager:
    """The save dir's files and their retention, written in the caller's
    thread or, with ``write_asynchronously``, by an ``AsyncWriter``."""

    def __init__(self, save_dir: str, best_checkpoint_metric: str = "loss",
                 maximize_best_checkpoint_metric: bool = False,
                 keep_best_checkpoints: int = -1, keep_last_epochs: int = -1,
                 keep_interval_updates: int = -1,
                 no_epoch_checkpoints: bool = False,
                 write_asynchronously: bool = False):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.metric = best_checkpoint_metric
        self.maximize = maximize_best_checkpoint_metric
        self.keep_best = keep_best_checkpoints
        self.keep_last_epochs = keep_last_epochs
        self.keep_interval_updates = keep_interval_updates
        self.no_epoch_checkpoints = no_epoch_checkpoints
        self.best: Optional[float] = None
        self.writer = AsyncWriter() if write_asynchronously else None
        probe = self.save_dir / ".writability_probe"
        probe.write_text("ok")
        probe.unlink()

    def save(self, state, step: int, epoch: int,
             val_metric: Optional[float] = None, end_of_epoch: bool = True,
             num_updates: Optional[int] = None,
             extra_meta: Optional[Dict] = None) -> List[str]:
        """Write one state under every name it takes; returns the paths.
        ``state``: flat host arrays, or a ``StateSnapshot``, whose arrays
        are made where the files are written, with
        ``checkpoint_last_ema.npz`` after them where it holds an EMA
        shadow. Asynchronously, the files exist once ``wait()`` returns."""
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
        gc_best = val_metric is not None and self.keep_best > 0
        if gc_best:
            targets.append(f"checkpoint.best_{self.metric}_"
                           f"{val_metric:.3f}.{step}.npz")
        targets.append("checkpoint_last.npz")
        meta["step"] = step
        paths = [str(self.save_dir / t) for t in targets]
        snap = state if isinstance(state, StateSnapshot) else None

        def write():
            with (self.writer.stream_for(snap.event) if self.writer and snap
                  else contextlib.nullcontext()):
                save_checkpoint_files(paths, snap.flat() if snap else state,
                                      meta)
                if wrote_epoch:
                    self._gc(r"checkpoint(\d+)\.npz", 1,
                             self.keep_last_epochs)
                if wrote_interval:
                    self._gc(r"checkpoint_(\d+)_(\d+)\.npz", 2,
                             self.keep_interval_updates)
                if gc_best:
                    self._gc_best()
                if snap is not None and snap.ema is not None:
                    write_npz(str(self.save_dir / "checkpoint_last_ema.npz"),
                              snap.ema_flat())

        if self.writer is not None:
            self.writer.submit(write)
        else:
            write()
        return paths

    def wait(self) -> None:
        """Block until every submitted write is on disk (nothing to wait
        for when writes are synchronous); raises a write's error."""
        if self.writer is not None:
            self.writer.wait()

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
        self.wait()
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
