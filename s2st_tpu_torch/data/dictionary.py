"""fairseq symbol dictionary: the port's own copy of what training reads of
``s2st_tpu/data/dictionary.py``.

Text format: one ``<symbol> <count>`` pair per line. The special symbols
come first and are implicit: bos=0 ``<s>``, pad=1 ``<pad>``, eos=2
``</s>``, unk=3 ``<unk>``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class Dictionary:
    def __init__(self):
        self.symbols: List[str] = []
        self.indices: Dict[str, int] = {}
        self.bos_index = self.add_symbol("<s>")
        self.pad_index = self.add_symbol("<pad>")
        self.eos_index = self.add_symbol("</s>")
        self.unk_index = self.add_symbol("<unk>")

    def __len__(self) -> int:
        return len(self.symbols)

    def add_symbol(self, word: str) -> int:
        if word not in self.indices:
            self.indices[word] = len(self.symbols)
            self.symbols.append(word)
        return self.indices[word]

    def index(self, sym: str) -> int:
        return self.indices.get(sym, self.unk_index)

    def encode_line(self, line: str, append_eos: bool = True) -> np.ndarray:
        """Whitespace tokens -> int32 ids (unk for unknown), eos appended."""
        ids = [self.index(w) for w in line.split()]
        if append_eos:
            ids.append(self.eos_index)
        return np.asarray(ids, dtype=np.int32)

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        d = cls()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                try:
                    field, count = line.rsplit(" ", 1)
                    int(count)
                except ValueError:
                    raise ValueError(f"Incorrect dictionary format: {line!r}. "
                                     "Expected '<token> <cnt>'.")
                if field != "#fairseq:overwrite":
                    d.add_symbol(field)
        return d
