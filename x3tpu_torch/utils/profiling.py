"""Profiling helpers (``x3tpu.utils.profiling``; reference analogue: the
-pg / PGO build flavours, Makefile:16-28): a ``torch.profiler`` trace of
the host and, where there is one, the card."""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Record a ``torch.profiler`` trace around a codec run and write it to
    ``logdir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto).  The card's activity is recorded when CUDA is available.
    No-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """A named span in the trace (``torch.profiler.record_function``)."""
    import torch

    return torch.profiler.record_function(name)
