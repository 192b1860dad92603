"""Human-readable formatting for stats lines.

Equivalent of reference src/wtf/human.{h,cc} (BytesToHuman / NumberToHuman /
SecondsToHuman) used by server/client status lines.
"""

from __future__ import annotations

_BYTE_UNITS = ["b", "kb", "mb", "gb", "tb"]
_NUM_UNITS = ["", "k", "m", "g", "t"]


def _scale(value: float, units, base: float) -> str:
    for unit in units[:-1]:
        if abs(value) < base:
            return f"{value:.1f}{unit}"
        value /= base
    return f"{value:.1f}{units[-1]}"


def bytes_to_human(n: float) -> str:
    return _scale(float(n), _BYTE_UNITS, 1024.0)


def number_to_human(n: float) -> str:
    return _scale(float(n), _NUM_UNITS, 1000.0)


def seconds_to_human(seconds: float) -> str:
    seconds = float(seconds)
    if seconds < 60:
        return f"{seconds:.1f}s"
    minutes, seconds = divmod(seconds, 60)
    if minutes < 60:
        return f"{int(minutes)}min{int(seconds)}s"
    hours, minutes = divmod(minutes, 60)
    if hours < 24:
        return f"{int(hours)}hr{int(minutes)}min"
    days, hours = divmod(hours, 24)
    return f"{int(days)}d{int(hours)}hr"
