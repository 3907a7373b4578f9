"""The parts of the data ``config.yaml`` that generation reads.

Counterpart of ``s2st_tpu/data/data_cfg.py``: the ``features`` block, the
src/tgt transform lists with their split wildcards, the global CMVN stats
paths, ``audio_root``, ``input_feat_per_channel`` and ``use_hubert``
(:24, :35-36). The file is read
with a small reader for the block-style YAML that ``yaml.dump`` and the
recipe write (nested maps, ``- item`` lists, scalars, flow lists), so the
port needs no YAML package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


def _scalar(s: str) -> Any:
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        return body.replace("''", "'") if s[0] == "'" else body
    if s.startswith("[") and s.endswith("]"):
        return [_scalar(x.strip()) for x in s[1:-1].split(",") if x.strip()]
    if s == "{}":
        return {}
    low = s.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def _block(lines: List[Tuple[int, str]], i: int, indent: int):
    """Parse the map or list whose entries sit at ``indent`` from line i;
    returns (value, index of the first line after it)."""
    if lines[i][1].startswith("-"):
        out_list = []
        while i < len(lines) and lines[i][0] == indent \
                and lines[i][1].startswith("-"):
            item = lines[i][1][1:].strip()
            i += 1
            if item:
                out_list.append(_scalar(item))
            elif i < len(lines) and lines[i][0] > indent:
                value, i = _block(lines, i, lines[i][0])
                out_list.append(value)
            else:
                out_list.append(None)
        return out_list, i
    out: Dict[str, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        key, sep, rest = lines[i][1].partition(":")
        if not sep:
            raise ValueError(f"cannot parse YAML line: {lines[i][1]!r}")
        key, rest = _scalar(key.strip()), rest.strip()
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def parse_yaml(text: str) -> Dict[str, Any]:
    lines = []
    for raw in text.splitlines():
        body = raw.rstrip()
        if not body.strip() or body.lstrip().startswith("#") \
                or body.strip() == "---":
            continue
        lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return {}
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"cannot parse YAML from line {lines[i][1]!r}")
    return value


class S2STDataConfig:
    def __init__(self, yaml_path):
        yaml_path = Path(yaml_path)
        if not yaml_path.is_file():
            raise FileNotFoundError(f"{yaml_path.as_posix()} not found")
        self.config = parse_yaml(yaml_path.read_text()) or {}
        self.root = yaml_path.parent
        self.use_hubert = False

    def set_use_hubert(self, use_hubert: bool) -> None:
        """Raw-waveform sources for the HuBERT frontend (the task sets it
        from ``--use-hubert``, tasks/s2s_translation.py:49)."""
        self.use_hubert = bool(use_hubert)

    def abs_path(self, x: Optional[str]) -> Optional[str]:
        """A relative path that does not exist as given is taken from the
        config's directory (data_cfg.py:27-33)."""
        if isinstance(x, str) and not Path(x).exists() \
                and (self.root / x).exists():
            return (self.root / x).as_posix()
        return x

    @property
    def input_feat_per_channel(self) -> int:
        return self.config.get("input_feat_per_channel", 80)

    @property
    def audio_root(self) -> str:
        return self.config.get("audio_root", "")

    def transforms_for(self, key: str, split: str, is_train: bool
                       ) -> Optional[List[str]]:
        """Transform names for a split: the split's own entry, else
        ``_train``/``_eval``, else ``*`` (data_cfg.py:97-103)."""
        cur = self.config.get(key) or {}
        names = cur.get(split)
        if names is None:
            names = cur.get("_train" if is_train else "_eval")
        if names is None:
            names = cur.get("*")
        return names

    def cmvn_stats_path(self, name: str) -> Optional[str]:
        """stats_npz_path of a ``*global_cmvn`` block, or None."""
        return self.abs_path((self.config.get(name) or {}).get(
            "stats_npz_path"))

    @property
    def features(self) -> Optional[Dict]:
        return self.config.get("features")
