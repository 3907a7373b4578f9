"""Chinese non-standard-word (NSW) text normalization.

The port's own copy of ``s2st_tpu/preprocessing/cn_text_norm.py``, which
mirrors the reference's pure-python normalizer
(``examples/s2s_trans/preprocessing/cn_tn.py``): Arabic-digit dates, money,
phone numbers, fractions, percentages, quantified cardinals, long digit
strings and bare cardinals are rewritten to their spoken Chinese form, then
CJK + ASCII punctuation is replaced by spaces. Its output equals the JAX
package's character for character (tests/test_torch_preprocessing.py).
"""

from __future__ import annotations

import argparse
import re
import string
import sys
from typing import List, Optional, Tuple

# --------------------------------------------------------------------------
# character tables (behavioral data, shared with the reference)
# --------------------------------------------------------------------------

DIGITS = "零一二三四五六七八九"
LIANG = "两"
POINT = "点"
# (power, glyph) — 万-based ("mid") system (cn_tn.py:196-198):
# 亿 = 10^8, 兆 = 亿*万 = 10^12, 京 = 兆*万 = 10^16, 垓 = 10^20
UNITS: Tuple[Tuple[int, str], ...] = (
    (20, "垓"), (16, "京"), (12, "兆"),
    (8, "亿"), (4, "万"), (3, "千"), (2, "百"), (1, "十"))

CURRENCY_UNITS = (r"((亿|千万|百万|万|千|百)|(亿|千万|百万|万|千|百|)元|"
                  r"(亿|千万|百万|万|千|百|)块|角|毛|分)")
QUANTIFIERS = (
    "(匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|担|颗|壳|窠|曲|墙|群|腔|"
    "砣|座|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|单|双|对|出|口|头|脚|板|跳|枝|件|贴|"
    "针|线|管|名|位|身|堂|课|本|页|家|户|层|丝|毫|厘|分|钱|两|斤|担|铢|石|钧|锱|忽|(千|毫|微)克|"
    "毫|厘|分|寸|尺|丈|里|寻|常|铺|程|(千|分|厘|毫|微)米|撮|勺|合|升|斗|石|盘|碗|碟|叠|桶|笼|盆|"
    "盒|杯|钟|斛|锅|簋|篮|盘|桶|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|分|旬|"
    "纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|颗|幢|堆|条|根|支|道|面|片|张|颗|块)")

# CJK punctuation (Zhon project tables, same set as the reference)
_PUNC = ("！？｡。"
         "＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃《》「」『』"
         "【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏"
         "·〈〉-")


# --------------------------------------------------------------------------
# number readers
# --------------------------------------------------------------------------

def read_verbatim(digit_string: str) -> str:
    """Digit-wise reading: '2019' -> 二零一九 (years, phone numbers, IDs)."""
    return "".join(DIGITS[int(c)] for c in digit_string if c.isdigit())


def _int_tokens(s: str) -> List[Tuple[str, int]]:
    """Recursive positional reading of an integer string into tokens
    ('d', digit) / ('u', power). Mirrors the largest-unit recursion so
    zero-collapsing matches (cn_tn.py num2chn/get_value)."""
    stripped = s.lstrip("0")
    if not stripped:
        return []
    if len(stripped) == 1:
        toks: List[Tuple[str, int]] = []
        if len(s) != len(stripped):       # swallowed zeros -> one 零
            toks.append(("d", 0))
        toks.append(("d", int(stripped)))
        return toks
    power = next(p for p, _ in UNITS if p < len(stripped))
    head, tail = s[:-power], stripped[-power:]
    return _int_tokens(head) + [("u", power)] + _int_tokens(tail)


def int_to_hanzi(s: str, liang: bool = True) -> str:
    """Cardinal reading of an integer string ('2938' -> 两千九百三十八)."""
    if len(s) <= 1:
        return DIGITS[int(s)] if s else ""
    toks = _int_tokens(s)
    out = []
    unit_glyph = dict((p, g) for p, g in UNITS)
    for i, (kind, val) in enumerate(toks):
        if kind == "u":
            out.append(unit_glyph[val])
            continue
        glyph = DIGITS[val]
        if liang and val == 2:
            # 2 reads 两 before 百/千/万/亿 when not following a 十
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            prv = toks[i - 1] if i > 0 else None
            if (nxt is not None and nxt[0] == "u" and nxt[1] != 1
                    and (prv is None or (prv[0] == "u" and prv[1] != 1))):
                glyph = LIANG
        out.append(glyph)
    result = "".join(out)
    # leading 一十X reads 十X (10..19)
    if result.startswith(DIGITS[1] + "十"):
        result = result[1:]
    return result


def number_to_hanzi(s: str, liang: bool = True) -> str:
    """Cardinal with optional decimal part: '34.5' -> 三十四点五."""
    if "." in s:
        int_part, dec_part = s.split(".", 1)
        left = int_to_hanzi(int_part, liang) if len(int_part) > 1 \
            else (DIGITS[int(int_part)] if int_part else "")
        right = read_verbatim(dec_part)
        out = left + POINT + right
        return DIGITS[0] + out if out.startswith(POINT) else out
    return int_to_hanzi(s, liang)


# --------------------------------------------------------------------------
# context rewriters (cn_tn.py Date/Money/TelePhone/Fraction/Percentage)
# --------------------------------------------------------------------------

def _date(text: str) -> str:
    """'1999年2月20日' -> 一九九九年二月二十日 (year verbatim, month/day
    cardinal, trailing 日/号 kept)."""
    if "年" in text:
        year, rest = text.split("年", 1)
        year = read_verbatim(year) + "年"
    else:
        year, rest = "", text
    month = day = ""
    if rest:
        if "月" in rest:
            mo, day_part = rest.split("月", 1)
            month = number_to_hanzi(mo) + "月"
        else:
            day_part = text
        if day_part:
            day = number_to_hanzi(day_part[:-1]) + day_part[-1]
    return year + month + day


def _money(text: str) -> str:
    return re.sub(r"\d+(\.\d+)?",
                  lambda m: number_to_hanzi(m.group(0)), text)


def _phone(text: str, fixed: bool = False) -> str:
    parts = text.split("-") if fixed else text.strip("+").split()
    return "".join(read_verbatim(p) for p in parts)


def _fraction(text: str) -> str:
    num, den = text.split("/")
    return number_to_hanzi(den) + "分之" + number_to_hanzi(num)


def _percent(text: str) -> str:
    return "百分之" + number_to_hanzi(text.strip().strip("%"))


# --------------------------------------------------------------------------
# the normalizer pipeline (rule order = cn_tn.py NSWNormalizer.normalize)
# --------------------------------------------------------------------------

_RE_DATE = re.compile(
    r"\D+((([089]\d|(19|20)\d{2})年)?(\d{1,2}月(\d{1,2}[日号])?)?)")
_RE_MONEY = re.compile(
    r"\D+((\d+(\.\d+)?)[多余几]?" + CURRENCY_UNITS
    + r"(\d" + CURRENCY_UNITS + r"?)?)")
_RE_MOBILE = re.compile(
    r"\D((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})\D")
_RE_FIXED = re.compile(r"\D((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7})\D")
_RE_FRACTION = re.compile(r"(\d+/\d+)")
_RE_PERCENT = re.compile(r"(\d+(\.\d+)?%)")
_RE_QUANT = re.compile(r"(\d+(\.\d+)?)[多余几]?" + QUANTIFIERS)
_RE_LONG_DIGITS = re.compile(r"(\d{4,32})")
_RE_CARDINAL = re.compile(r"(\d+(\.\d+)?)")
_RE_LETTER2 = re.compile(r"(([a-zA-Z]+)二([a-zA-Z]+))")


def normalize(raw_text: str) -> str:
    """Rewrite every non-standard word in `raw_text` to spoken Chinese.

    NOTE on replace semantics: rewrites use str.replace(match, ..., 1) —
    value-based, not span-based — exactly like the reference
    (cn_tn.py:625-706). When a matched digit string also occurs EARLIER
    inside a longer number, the earlier occurrence is rewritten instead
    (e.g. '有250以及2个' -> '有二五十以及二个' in BOTH implementations;
    fuzz-verified over 4000 cases). Kept bug-compatible: downstream vocab/
    text artifacts must match the reference's preprocessing byte-for-byte.
    """
    text = "^" + raw_text + "$"   # sentinels so \D+ anchors at the edges

    for m in _RE_DATE.findall(text):
        if m[0]:
            text = text.replace(m[0], _date(m[0]), 1)
    for m in _RE_MONEY.findall(text):
        text = text.replace(m[0], _money(m[0]), 1)
    for m in _RE_MOBILE.findall(text):
        text = text.replace(m[0], _phone(m[0]), 1)
    for m in _RE_FIXED.findall(text):
        text = text.replace(m[0], _phone(m[0], fixed=True), 1)
    for m in _RE_FRACTION.findall(text):
        text = text.replace(m, _fraction(m), 1)
    text = text.replace("％", "%")
    for m in _RE_PERCENT.findall(text):
        text = text.replace(m[0], _percent(m[0]), 1)
    for m in _RE_QUANT.findall(text):
        text = text.replace(m[0], number_to_hanzi(m[0]), 1)
    for m in _RE_LONG_DIGITS.findall(text):
        text = text.replace(m, read_verbatim(m), 1)
    for m in _RE_CARDINAL.findall(text):
        text = text.replace(m[0], number_to_hanzi(m[0]), 1)
    # letters二letters -> letters2letters (O2O / B2C survive)
    for m in _RE_LETTER2.findall(text):
        text = text.replace(m[0], m[1] + "2" + m[2], 1)

    # exactly one sentinel was added on each side and no rewrite touches
    # them (all replacements are digit-anchored), so strip exactly one char
    # — lstrip/rstrip (what the reference does, cn_tn.py:728) would also
    # delete user-authored leading '^' / trailing '$' characters
    return text[1:-1]


_PUNC_TABLE = str.maketrans(_PUNC + string.punctuation,
                            " " * (len(_PUNC) + len(string.punctuation)))


def strip_punctuation(text: str) -> str:
    """CJK + ASCII punctuation -> spaces (cn_tn.py main loop)."""
    return text.translate(_PUNC_TABLE)


def normalize_line(line: str, has_key: bool = False, to_upper: bool = False,
                   to_lower: bool = False, punct: bool = True) -> str:
    key, text = "", line.strip()
    if has_key:
        cols = line.split(maxsplit=1)
        key = cols[0]
        text = cols[1].strip() if len(cols) == 2 else ""
    if to_upper:
        text = text.upper()
    if to_lower:
        text = text.lower()
    text = normalize(text)
    if punct:
        text = strip_punctuation(text)
    return (key + "\t" + text) if has_key else text


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Chinese NSW text normalization (cn_tn.py parity)")
    p.add_argument("ifile")
    p.add_argument("ofile")
    p.add_argument("--to_upper", action="store_true")
    p.add_argument("--to_lower", action="store_true")
    p.add_argument("--has_key", action="store_true")
    p.add_argument("--log_interval", type=int, default=100000)
    args = p.parse_args(argv)
    if args.to_upper and args.to_lower:
        sys.stderr.write("cn_text_norm: to_upper OR to_lower?\n")
        return 1
    n = 0
    with open(args.ifile, encoding="utf-8") as fin, \
            open(args.ofile, "w", encoding="utf-8") as fout:
        for line in fin:
            out = normalize_line(line, has_key=args.has_key,
                                 to_upper=args.to_upper,
                                 to_lower=args.to_lower)
            if args.has_key or out.strip():
                fout.write(out + "\n")
            n += 1
            if n % args.log_interval == 0:
                sys.stderr.write(f"cn_text_norm: {n} lines done.\n")
    sys.stderr.write(f"cn_text_norm: {n} lines done in total.\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
