"""The bytes a call must move at the least, for the kernels' roofline
shares.  The codec does no arithmetic worth counting, so a call is bound
by bytes: each input byte read once and each output byte written once,
plus each lane's lengths, event counts, size estimates and flags."""

from __future__ import annotations

# a lane's input length and output length (4 + 4), its 5 event counts and
# 5 size estimates (20 + 20), its overflow flags (4)
LANE_IO_BYTES = 4 + 4 + 20 + 20 + 4


def encode_bytes(call) -> int:
    """A compress call: the blocks read, the streams written."""
    return call.in_bytes + call.stream_bytes + LANE_IO_BYTES * call.lanes


def decode_bytes(call) -> int:
    """A decompress call: the streams read, the blocks written."""
    return call.stream_bytes + call.out_bytes + LANE_IO_BYTES * call.lanes


def share_pct(run, kind: str, nbytes) -> "float | None":
    """100 x the least time of ``kind``'s calls at the card's peak memory
    rate (``peaks.json``) over the device time of every kernel inside
    their spans, whatever its name, fills included and PyTorch's copy
    kernels left out.  None where the card or its kernels are unknown."""
    from portbench.lib.trace import is_copy_kernel

    if run.view is None:
        return None
    peak = run.peaks.get(run.device_kind, {}).get("hbm_bytes_per_s")
    if not peak:
        return None
    least = kernel_s = 0.0
    for s in run.view.calls(kind):
        least += nbytes(s["call"]) / peak
        kernel_s += sum(b - a for _, name, a, b in
                        run.view.within(s, ("kernel",))
                        if not is_copy_kernel(name))
    return 100.0 * least / kernel_s if kernel_s > 0 else None
