"""Readers of the traced window's device activity inside the
benchmark's spans (``lib/trace.py``)."""

from __future__ import annotations

from portbench.lib.trace import is_program_kernel


def launches_per_call(run, kind: str) -> "float | None":
    """The program's kernel launches inside ``kind``'s spans, a call: every
    kernel that is not one of PyTorch's own (fills, copies), retries and
    launch splits counted."""
    if run.view is None or not run.view.device:
        return None
    spans = run.view.calls(kind)
    if not spans:
        return None
    n = sum(1 for s in spans for _, name, _, _ in
            run.view.within(s, ("kernel",)) if is_program_kernel(name))
    return n / len(spans)


def idle_pct(run, kind: str) -> "float | None":
    """The share of ``kind``'s spans' wall time in which no kernel, copy or
    fill runs on the card."""
    if run.view is None or not run.view.device:
        return None
    spans = run.view.calls(kind)
    total = sum(s["t1"] - s["t0"] for s in spans)
    if total <= 0:
        return None
    busy = sum(run.view.busy(s) for s in spans)
    return 100.0 * (1.0 - busy / total)
