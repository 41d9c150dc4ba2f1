"""device_idle_pct.compress (%): the share of the compress spans' wall time in
which no kernel, copy or fill runs on the card."""

from portbench.lib.device import idle_pct


def read(run):
    return idle_pct(run, "compress")
