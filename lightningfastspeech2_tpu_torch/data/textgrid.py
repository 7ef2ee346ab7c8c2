"""The port's own copy of ``lightningfastspeech2_tpu/data/textgrid.py``.

Minimal Praat TextGrid parser (long and short text formats).

The reference pulls TextGrids in through the external ``alignments`` package
plus the ``tgt``/``textgrid`` libraries (reference ``litfass/train.py:21``,
``litfass/dataset/snr.py:4``); none of those are available here, so this is
a small self-contained parser covering the Montreal-Forced-Aligner output
that LibriTTS-style corpora use: IntervalTiers (typically "words" and
"phones") with (xmin, xmax, text) intervals.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union


@dataclass(frozen=True)
class Interval:
    start: float
    end: float
    text: str


@dataclass(frozen=True)
class Tier:
    name: str
    intervals: Tuple[Interval, ...]


@dataclass(frozen=True)
class TextGrid:
    xmin: float
    xmax: float
    tiers: Tuple[Tier, ...]

    def tier(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r}; have {[t.name for t in self.tiers]}")


_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")


def _unquote(s: str) -> str:
    return s.replace('""', '"')


def parse(text: str) -> TextGrid:
    """Parse TextGrid file contents (auto-detects long/short form)."""
    # long-form index brackets ("item [1]:", "intervals [12]:") would read
    # as numbers — strip them first (quoted phone labels never contain
    # bracketed digits)
    text = re.sub(r"\[[0-9]*\]", "", text)
    # tokenize: quoted strings and numbers, in order
    tokens: List[Union[float, str]] = []
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == '"':
            m = _QUOTED.match(text, i)
            if not m:
                raise ValueError(f"unterminated string at offset {i}")
            tokens.append(_unquote(m.group(1)))
            i = m.end()
        elif ch.isdigit() or (ch == "-" and i + 1 < len(text) and text[i + 1].isdigit()):
            m = _NUM.match(text, i)
            tokens.append(float(m.group(0)))
            i = m.end()
        else:
            i += 1

    # layout (both forms reduce to the same token stream):
    # "ooTextFile" "TextGrid" xmin xmax ["exists"] size
    #   then per tier: "IntervalTier" name tmin tmax n
    #     then per interval: xmin xmax "text"
    it = iter(tokens)

    def next_num() -> float:
        for tok in it:
            if isinstance(tok, float):
                return tok
        raise ValueError("unexpected end of TextGrid")

    def next_str() -> str:
        for tok in it:
            if isinstance(tok, str):
                return tok
        raise ValueError("unexpected end of TextGrid")

    header = next_str()
    if "ooTextFile" not in header:
        raise ValueError("not a TextGrid file")
    kind = next_str()
    if kind != "TextGrid":
        raise ValueError(f"unsupported Praat object {kind!r}")
    xmin = next_num()
    xmax = next_num()
    n_tiers = int(next_num())

    tiers = []
    for _ in range(n_tiers):
        tier_class = next_str()
        name = next_str()
        t_min = next_num()
        t_max = next_num()
        n_int = int(next_num())
        intervals = []
        if tier_class == "IntervalTier":
            for _ in range(n_int):
                a = next_num()
                b = next_num()
                label = next_str()
                intervals.append(Interval(a, b, label))
        else:  # TextTier / PointTier: (number, mark) pairs
            for _ in range(n_int):
                a = next_num()
                label = next_str()
                intervals.append(Interval(a, a, label))
        tiers.append(Tier(name, tuple(intervals)))
    return TextGrid(xmin, xmax, tuple(tiers))


def load(path: Union[str, Path]) -> TextGrid:
    raw = Path(path).read_bytes()
    for enc in ("utf-8", "utf-16", "latin-1"):
        try:
            return parse(raw.decode(enc))
        except UnicodeDecodeError:
            continue
    raise ValueError(f"cannot decode {path}")


def _quote(s: str) -> str:
    return s.replace('"', '""')


def dump(tg: TextGrid) -> str:
    """Serialize to long-form TextGrid (used by tests/synthetic corpora)."""
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {tg.xmin}",
        f"xmax = {tg.xmax}",
        "tiers? <exists>",
        f"size = {len(tg.tiers)}",
        "item []:",
    ]
    for ti, tier in enumerate(tg.tiers, 1):
        lines += [
            f"    item [{ti}]:",
            '        class = "IntervalTier"',
            f'        name = "{_quote(tier.name)}"',
            f"        xmin = {tg.xmin}",
            f"        xmax = {tg.xmax}",
            f"        intervals: size = {len(tier.intervals)}",
        ]
        for ii, iv in enumerate(tier.intervals, 1):
            lines += [
                f"        intervals [{ii}]:",
                f"            xmin = {iv.start}",
                f"            xmax = {iv.end}",
                f'            text = "{_quote(iv.text)}"',
            ]
    return "\n".join(lines) + "\n"
