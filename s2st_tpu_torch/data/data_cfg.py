"""The parts of the data ``config.yaml`` that generation reads.

Counterpart of ``s2st_tpu/data/data_cfg.py``: the ``features`` block, the
src/tgt transform lists with their split wildcards, the global CMVN stats
paths, ``audio_root``, ``input_feat_per_channel`` and ``use_hubert``
(:24, :35-36), ``vocoder`` (:129) and ``speaker_set_filename`` (:50).
The file is read with a small reader for the block-style YAML that
``yaml.dump`` and the recipe write (nested maps, ``- item`` lists,
scalars, flow lists), and stage 3 writes it with ``dump_yaml``, so the
port needs no YAML package.
"""

from __future__ import annotations

import re
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


# plain scalars that PyYAML's resolver reads as another type than str
# (yaml/resolver.py: bool, float, int, merge, null, timestamp, value, yaml)
_NOT_STR = re.compile(r"""^(?:
    yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF
  | [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
  | \.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
  | [-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
  | [-+]?\.(?:inf|Inf|INF) | \.(?:nan|NaN|NAN)
  | [-+]?0b[0-1_]+ | [-+]?0[0-7_]+ | [-+]?(?:0|[1-9][0-9_]*)
  | [-+]?0x[0-9a-fA-F_]+ | [-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
  | << | ~ | null|Null|NULL | = | ! | & | \*
  | [0-9]{4}-[0-9]{2}-[0-9]{2}
  | [0-9]{4}-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[\ \t]+)[0-9][0-9]?:[0-9]{2}
    :[0-9]{2}(?:\.[0-9]*)?(?:[\ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9]{2})?))?
)$""", re.X)
_WIDTH = 80   # PyYAML folds a plain scalar with spaces past this column


def _plain_ok(s: str) -> bool:
    """Whether PyYAML writes s unquoted in block context."""
    if not s or s[0] == " " or s[-1] == " " or _NOT_STR.match(s):
        return False
    if s[0] in "#,[]{}&*!|>'\"%@`":
        return False
    if s[0] in "-?:" and (len(s) == 1 or s[1] == " "):
        return False
    return ": " not in s and " #" not in s and not s.endswith(":")


def _dump_str(s: str, column: int) -> str:
    if not s.isascii() or not s.isprintable():
        raise ValueError(f"dump_yaml writes printable ASCII only: {s!r}")
    if " " in s and column + len(s) > _WIDTH:
        raise ValueError(f"dump_yaml does not fold long lines: {s!r}")
    return s if _plain_ok(s) else "'" + s.replace("'", "''") + "'"


def _dump_scalar(v: Any, column: int) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return _dump_str(v, column)
    raise ValueError(f"dump_yaml cannot write a {type(v).__name__}: {v!r}")


def _dump_block(value: Dict[str, Any], indent: int, out: List[str]) -> None:
    for key in sorted(value):
        if not isinstance(key, str) or len(key) > 128:
            raise ValueError(f"dump_yaml takes string keys: {key!r}")
        head = " " * indent + _dump_str(key, indent) + ":"
        v = value[key]
        if isinstance(v, dict) and v:
            out.append(head)
            _dump_block(v, indent + 2, out)
        elif isinstance(v, list) and v:
            out.append(head)
            for item in v:
                if isinstance(item, (dict, list)):
                    raise ValueError("dump_yaml writes lists of scalars only")
                out.append(" " * indent + "- "
                           + _dump_scalar(item, indent + 2))
        elif isinstance(v, (dict, list)):
            out.append(head + (" {}" if isinstance(v, dict) else " []"))
        else:
            out.append(head + " " + _dump_scalar(v, len(head) + 1))


def dump_yaml(config: Dict[str, Any]) -> str:
    """What ``yaml.dump(config, default_flow_style=False)`` writes for
    nested maps of string keys over None, bool, int, float, printable
    ASCII strings and lists of those: keys sorted, two spaces a level,
    ``- item`` at the key's indent, PyYAML's float spelling (``1.0e-05``)
    and its quoting; ``parse_yaml`` reads it back. Raises on any other
    value."""
    if not isinstance(config, dict):
        raise ValueError("dump_yaml writes a map at the top level")
    if not config:
        return "{}\n"
    out: List[str] = []
    _dump_block(config, 0, out)
    return "\n".join(out) + "\n"


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

    @property
    def sampling_alpha(self) -> float:
        """The temperature of a multi-corpus train split's resampling
        (data_cfg.py:82); 1.0 keeps the corpora as they are."""
        return self.config.get("sampling_alpha", 1.0)

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

    @property
    def vocoder(self) -> Optional[Dict]:
        """The ``vocoder:`` block (type, checkpoint, config), or None."""
        return self.config.get("vocoder")
