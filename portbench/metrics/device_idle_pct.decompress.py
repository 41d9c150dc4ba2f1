"""device_idle_pct.decompress (%): the share of the decompress spans'
wall time in which no kernel, copy or fill runs on the card."""

from portbench.lib.device import idle_pct


def read(run):
    return idle_pct(run, "decompress")
