"""decode_roofline (%): the least time of the decompress calls (each
stream byte read once, each output byte written once, 52 B a lane, at the
card's peak memory rate) over the device time of every kernel inside the
decompress spans (K2 today)."""

from portbench.lib.roofline import decode_bytes, share_pct


def read(run):
    return share_pct(run, "decompress", decode_bytes)
