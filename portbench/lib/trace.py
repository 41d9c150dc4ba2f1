"""The traced run's view of the card: the benchmark's own spans around
each call (``torch.profiler.record_function``) and the device's kernels,
copies and fills, read from a ``torch.profiler`` Chrome trace (CPU and
CUDA activities).  Times are in seconds.

The card's timestamps can drift from the host's by a few milliseconds
over a window, enough to put a kernel into the span before its own.  So
each device activity belongs to the span in which the host issued it:
the runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that
shares its ``correlation`` id, on the host's clock.  A call waits for
its device work, so that work runs inside the call; a span's busy time
is the union of its own activities' intervals on each card, averaged
over the cards the run used."""

from __future__ import annotations

import bisect
import collections
import json

SPAN_PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
# PyTorch's own kernels (fills, copies, elementwise): not the program's
TORCH_KERNEL = "at::native::"


class TraceView:
    """``spans``: one dict a call, ``{"kind", "t0", "t1", "call"}`` (the
    harness's record of the call); ``device``: ``(cat, name, t0, t1)`` of
    each device activity, with ``issued``, the host time of the call that
    issued each (its own start where the trace has none); ``host``:
    ``(name, t0, t1)`` of each host op; ``cards``, the card each device
    activity ran on (all on one where not given), and ``chips``, the
    number of cards the run used."""

    def __init__(self, spans: list, device: list, host: list = (),
                 issued: list = None, cards: list = None, chips: int = 1):
        self.spans = sorted(spans, key=lambda s: s["t0"])
        self.chips = chips
        self._card = {id(d): (cards[i] if cards else 0)
                      for i, d in enumerate(device)}
        if issued is None:
            issued = [d[2] for d in device]
        order = sorted(range(len(device)), key=lambda i: device[i][2])
        self.device = [device[i] for i in order]
        self.host = sorted(host, key=lambda h: h[1])
        self._hstarts = [h[1] for h in self.host]
        # each span's own activities, by the time they were issued
        starts = [s["t0"] for s in self.spans]
        self._own = [[] for _ in self.spans]
        for i in order:
            k = bisect.bisect_right(starts, issued[i]) - 1
            if k >= 0 and issued[i] <= self.spans[k]["t1"]:
                self._own[k].append(device[i])
        self._index = {id(s): k for k, s in enumerate(self.spans)}
        self.tied = (0, len(device))

    @classmethod
    def from_chrome(cls, path, calls: list, chips: int = 1) -> "TraceView":
        """Read a Chrome trace of a run on ``chips`` cards; the spans
        named ``portbench.<kind>`` are paired in order with ``calls`` of
        that kind."""
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        spans, device, host, corr, launch, cards = [], [], [], [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            t0 = float(e["ts"]) * 1e-6
            t1 = t0 + float(e.get("dur", 0)) * 1e-6
            name = e.get("name", "")
            cid = e.get("args", {}).get("correlation")
            if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                spans.append({"kind": name[len(SPAN_PREFIX):], "t0": t0,
                              "t1": t1})
            elif cat in DEVICE_CATS:
                device.append((cat, name, t0, t1))
                corr.append(cid)
                cards.append(e.get("args", {}).get("device", 0))
            elif cat in HOST_CATS:
                host.append((name, t0, t1))
                if cid is not None and cat != "cpu_op":
                    launch[cid] = t0
        issued = [launch.get(c, d[2]) for c, d in zip(corr, device)]
        tied = sum(c in launch for c in corr)
        spans.sort(key=lambda s: s["t0"])
        by_kind = collections.defaultdict(list)
        for c in calls:
            by_kind[c.kind].append(c)
        for kind, cs in by_kind.items():
            ks = [s for s in spans if s["kind"] == kind]
            if len(ks) != len(cs):
                raise ValueError(f"trace holds {len(ks)} {kind} spans for "
                                 f"{len(cs)} calls")
            for s, c in zip(ks, cs):
                s["call"] = c
        view = cls(spans, device, host, issued, cards, chips)
        view.tied = (tied, len(device))
        return view

    def calls(self, kind: str) -> list:
        return [s for s in self.spans if s["kind"] == kind]

    def within(self, span: dict, cats=DEVICE_CATS) -> list:
        """The device activities of ``cats`` issued inside ``span``, in
        the order they ran."""
        return [d for d in self._own[self._index[id(span)]] if d[0] in cats]

    def busy(self, span: dict) -> float:
        """Seconds in which a card copies, fills or runs a kernel for
        ``span`` (the union of its activities' intervals on each card),
        averaged over the run's cards."""
        total, end = 0.0, collections.defaultdict(lambda: float("-inf"))
        for d in self.within(span):
            card, (_, _, a, b) = self._card[id(d)], d
            a = max(a, end[card])
            if b > a:
                total += b - a
                end[card] = b
        return total / self.chips

    def window(self) -> tuple:
        """(first span's start, last span's end)."""
        return self.spans[0]["t0"], max(s["t1"] for s in self.spans)

    def gaps(self, span: dict) -> list:
        """``(t0, t1)`` of each stretch of ``span`` in which the card is
        idle for it (on the card's clock, which may be off by a few ms)."""
        out, at = [], span["t0"]
        for _, _, a, b in self.within(span):
            if a > at:
                out.append((at, min(a, span["t1"])))
            at = max(at, b)
        if span["t1"] > at:
            out.append((at, span["t1"]))
        return [(a, b) for a, b in out if b > a]

    def host_at(self, t: float) -> str:
        """The innermost host op running at ``t``, or ``"python"``."""
        i = bisect.bisect_right(self._hstarts, t)
        for name, a, b in reversed(self.host[max(0, i - 256) : i]):
            if a <= t < b:
                return name
        return "python"


def is_program_kernel(name: str) -> bool:
    return TORCH_KERNEL not in name


def is_copy_kernel(name: str) -> bool:
    return TORCH_KERNEL in name and "copy" in name.lower()


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    stretches of the calls by what the host was doing then."""
    ops = collections.Counter()
    for s in view.spans:
        for _, name, a, b in view.within(s):
            ops[name[:160]] += b - a
    idle = collections.Counter()
    for s in view.spans:
        for a, b in view.gaps(s):
            idle[f"{s['kind']}: {view.host_at((a + b) / 2)[:120]}"] += b - a
    return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}
