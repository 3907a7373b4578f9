"""fairseq symbol dictionary: the port's own copy of what training and text
generation read of ``s2st_tpu/data/dictionary.py``.

Text format: one ``<symbol> <count>`` pair per line. The special symbols
come first and are implicit: bos=0 ``<s>``, pad=1 ``<pad>``, eos=2
``</s>``, unk=3 ``<unk>``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Dictionary:
    def __init__(self):
        self.symbols: List[str] = []
        self.indices: Dict[str, int] = {}
        self.unk_word = "<unk>"
        self.bos_index = self.add_symbol("<s>")
        self.pad_index = self.add_symbol("<pad>")
        self.eos_index = self.add_symbol("</s>")
        self.unk_index = self.add_symbol(self.unk_word)
        self.nspecial = len(self.symbols)

    def __len__(self) -> int:
        return len(self.symbols)

    def __getitem__(self, idx: int) -> str:
        return self.symbols[idx] if idx < len(self.symbols) else self.unk_word

    def bos(self) -> int:
        return self.bos_index

    def pad(self) -> int:
        return self.pad_index

    def eos(self) -> int:
        return self.eos_index

    def unk(self) -> int:
        return self.unk_index

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

    def string(self, tokens, bpe_symbol: Optional[str] = None,
               escape_unk: bool = False) -> str:
        """Ids -> text, eos and pad dropped; ``bpe_symbol`` ("@@ " for
        ``--remove-bpe``, or "sentencepiece") joins subwords. Like the JAX
        package's ``Dictionary.string``, ``escape_unk`` is accepted and
        leaves ``<unk>`` as it is."""
        ignore = {self.eos_index, self.pad_index}
        s = " ".join(self[int(i)] for i in np.asarray(tokens).reshape(-1)
                     if int(i) not in ignore)
        if bpe_symbol == "sentencepiece":
            s = s.replace(" ", "").replace("▁", " ").strip()
        elif bpe_symbol is not None:
            s = (s + " ").replace(bpe_symbol, "").rstrip()
        return s

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
