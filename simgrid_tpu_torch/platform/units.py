"""Unit-suffixed value parsing for platform files.

The port's copy of ``simgrid_tpu/platform/units.py``.

Same unit grammar as the reference parser
(src/surf/xml/surfxml_sax_cb.cpp:138-260): SI prefixes
(k/M/G/...) on base 1000, binary prefixes (Ki/Mi/Gi/...) on base 1024;
times in w/d/h/m/s/ms/us/ns/ps; bandwidths in Bps (bytes) or bps (bits,
1 Bps = 8 bps); speeds in f/flops.
"""

from __future__ import annotations

import re
from typing import Dict

from ..exceptions import ParseError

_NUM_RE = re.compile(r"^\s*([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*(.*)$")


def _gen(units: Dict[str, float], unit: str, value: float, base: int,
         abbrev: bool) -> None:
    if base == 2:
        mult = 1024.0
        prefixes = (["Ki", "Mi", "Gi", "Ti", "Pi", "Ei", "Zi", "Yi"] if abbrev
                    else ["kibi", "mebi", "gibi", "tebi", "pebi", "exbi",
                          "zebi", "yobi"])
    else:
        mult = 1000.0
        prefixes = (["k", "M", "G", "T", "P", "E", "Z", "Y"] if abbrev
                    else ["kilo", "mega", "giga", "tera", "peta", "exa",
                          "zeta", "yotta"])
    units.setdefault(unit, value)
    for prefix in prefixes:
        value *= mult
        units.setdefault(prefix + unit, value)


_TIME_UNITS = {"w": 7 * 24 * 60 * 60.0, "d": 24 * 60 * 60.0, "h": 3600.0,
               "m": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9,
               "ps": 1e-12}

_BW_UNITS: Dict[str, float] = {}
_gen(_BW_UNITS, "bps", 0.125, 2, True)
_gen(_BW_UNITS, "bps", 0.125, 10, True)
_gen(_BW_UNITS, "Bps", 1.0, 2, True)
_gen(_BW_UNITS, "Bps", 1.0, 10, True)

_SIZE_UNITS: Dict[str, float] = {}
_gen(_SIZE_UNITS, "b", 0.125, 2, True)
_gen(_SIZE_UNITS, "b", 0.125, 10, True)
_gen(_SIZE_UNITS, "B", 1.0, 2, True)
_gen(_SIZE_UNITS, "B", 1.0, 10, True)

_SPEED_UNITS: Dict[str, float] = {}
_gen(_SPEED_UNITS, "f", 1.0, 10, True)
_gen(_SPEED_UNITS, "flops", 1.0, 10, False)


def _parse(text: str, units: Dict[str, float], default_unit: str) -> float:
    m = _NUM_RE.match(text)
    if m is None:
        raise ParseError(f"Cannot parse number: {text!r}")
    value = float(m.group(1))
    unit = m.group(2).strip() or default_unit
    if unit not in units:
        raise ParseError(f"Unknown unit {unit!r} in {text!r}")
    return value * units[unit]


def parse_time(text: str) -> float:
    return _parse(text, _TIME_UNITS, "s")


def parse_bandwidth(text: str) -> float:
    return _parse(text, _BW_UNITS, "Bps")


def parse_size(text: str) -> float:
    return _parse(text, _SIZE_UNITS, "B")


def parse_speed(text: str) -> float:
    return _parse(text, _SPEED_UNITS, "f")


def parse_speeds(text: str) -> list:
    """Comma-separated pstate list."""
    return [parse_speed(part) for part in text.split(",")]
