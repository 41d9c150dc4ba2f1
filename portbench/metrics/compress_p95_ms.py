"""compress_p95_ms (ms): the 95th percentile of the compress calls'
latencies in the window, host clock."""

from portbench.lib.host import p95_ms


def read(run):
    return p95_ms(run, "compress")
