"""Readers of the window's host clock: each call's wall time from call to
return, as the harness recorded it (``run.py`` ``Call``)."""

from __future__ import annotations

import numpy as np


def mb_per_s(run, kind: str, restored: bool) -> "float | None":
    """10^6 bytes over the summed wall times of ``kind``'s calls: the input
    bytes of compress calls, the restored bytes of decompress calls."""
    cs = [c for c in run.calls if c.kind == kind]
    if not cs:
        return None
    nbytes = sum(c.out_bytes if restored else c.in_bytes for c in cs)
    return nbytes / sum(c.seconds for c in cs) / 1e6


def p95_ms(run, kind: str) -> "float | None":
    """The 95th percentile (linear between ranks) of ``kind``'s calls'
    wall times, in ms."""
    cs = [c.seconds for c in run.calls if c.kind == kind]
    if not cs:
        return None
    return float(np.percentile(cs, 95)) * 1e3
