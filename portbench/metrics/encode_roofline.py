"""encode_roofline (%): the least time of the compress calls (each input
byte read once, each stream byte written once, 52 B a lane, at the card's
peak memory rate) over the device time of every kernel inside the compress
spans (K1 today)."""

from portbench.lib.roofline import encode_bytes, share_pct


def read(run):
    return share_pct(run, "compress", encode_bytes)
