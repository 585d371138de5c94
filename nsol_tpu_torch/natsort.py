"""Natural-order sorting (replacement for the external ``natsort`` package
used by the reference's study reader, nsol/reader_parameter_study.py:253)."""

import re

__all__ = ["natsort_key", "natsorted"]

_CHUNK = re.compile(r"(\d+\.?\d*|\D+)")


def natsort_key(s):
    parts = _CHUNK.findall(str(s))
    key = []
    for p in parts:
        try:
            key.append((0, float(p), ""))
        except ValueError:
            key.append((1, 0.0, p))
    return key


def natsorted(seq, key=None):
    if key is None:
        return sorted(seq, key=natsort_key)
    return sorted(seq, key=lambda v: natsort_key(key(v)))
