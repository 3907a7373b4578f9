"""Binarized token datasets in fairseq's ``mmap`` format: the port's own copy
of the reader and builder of ``s2st_tpu/data/indexed_dataset.py`` (:51-173).

``<prefix>.bin`` is the raw concatenation of each item's array bytes;
``<prefix>.idx`` is the ``MMIDIDX\\x00\\x00`` magic, u64 version 1, u8 dtype
code, u64 item count, int32 sizes[count] and int64 byte pointers[count].
Files written by fairseq-preprocess or the JAX package's preprocess CLI load
here unchanged, and the builder writes files they read.
"""

from __future__ import annotations

import os
import struct
from typing import List

import numpy as np

_MAGIC = b"MMIDIDX\x00\x00"
# dtype header codes; 6 and 7 both mean float64, and float64 writes 6
_CODE_TO_DTYPE = {
    1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
    6: np.float64, 7: np.float64, 8: np.uint16, 9: np.uint32, 10: np.uint64,
}
_DTYPE_TO_CODE: dict = {}
for _code, _dt in _CODE_TO_DTYPE.items():
    _DTYPE_TO_CODE.setdefault(np.dtype(_dt), _code)


def best_fitting_int_dtype(max_int_to_represent: int):
    """Smallest safe dtype for token ids: uint16 under 65500, uint32 under
    2^32 - 1, else int64."""
    if max_int_to_represent < 65500:
        return np.uint16
    if max_int_to_represent < 4294967295:
        return np.uint32
    return np.int64


class MMapIndexedDataset:
    """Zero-copy reader. ``ds[i]`` is an int64 array."""

    def __init__(self, prefix: str):
        with open(prefix + ".idx", "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(f"{prefix}.idx: not an MMIDIDX index")
            (version,) = struct.unpack("<Q", f.read(8))
            if version != 1:
                raise ValueError(f"{prefix}.idx: version {version}, not 1")
            (code,) = struct.unpack("<B", f.read(1))
            self.dtype = np.dtype(_CODE_TO_DTYPE[code])
            (self._len,) = struct.unpack("<Q", f.read(8))
            header_end = f.tell()
        idx = np.memmap(prefix + ".idx", mode="r")
        self.sizes = np.frombuffer(idx, dtype=np.int32, count=self._len,
                                   offset=header_end)
        self._pointers = np.frombuffer(idx, dtype=np.int64, count=self._len,
                                       offset=header_end + self.sizes.nbytes)
        self._data = np.memmap(prefix + ".bin", mode="r")

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int) -> np.ndarray:
        out = np.frombuffer(self._data, dtype=self.dtype,
                            count=int(self.sizes[i]),
                            offset=int(self._pointers[i]))
        return out.astype(np.int64)

    @staticmethod
    def exists(prefix: str) -> bool:
        return os.path.exists(prefix + ".idx") and \
            os.path.exists(prefix + ".bin")


class MMapIndexedDatasetBuilder:
    """Writes ``<prefix>.bin`` item by item; ``finalize`` writes the index."""

    def __init__(self, bin_path: str, dtype=np.int64):
        self._out = open(bin_path, "wb")
        self._dtype = np.dtype(dtype)
        self._sizes: List[int] = []

    def add_item(self, array) -> None:
        arr = np.ascontiguousarray(np.asarray(array), dtype=self._dtype)
        self._out.write(arr.tobytes())
        self._sizes.append(arr.size)

    def finalize(self, idx_path: str) -> None:
        self._out.close()
        sizes = np.asarray(self._sizes, dtype=np.int32)
        pointers = np.zeros(len(sizes), dtype=np.int64)
        if len(sizes) > 1:
            pointers[1:] = np.cumsum(sizes[:-1].astype(np.int64)
                                     * self._dtype.itemsize)
        with open(idx_path, "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", _DTYPE_TO_CODE[self._dtype]))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(sizes.tobytes())
            f.write(pointers.tobytes())


def write_dataset(prefix: str, items, vocab_size: int) -> None:
    """Write a list of token-id arrays as ``<prefix>.bin/.idx`` with the
    dtype fairseq-preprocess picks for the vocabulary."""
    builder = MMapIndexedDatasetBuilder(
        prefix + ".bin", dtype=best_fitting_int_dtype(vocab_size))
    for item in items:
        builder.add_item(item)
    builder.finalize(prefix + ".idx")
