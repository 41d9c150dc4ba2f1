"""decompress_MBps (MB/s): restored bytes of every decompress call in the
window over the sum of those calls' wall times, host clock."""

from portbench.lib.host import mb_per_s


def read(run):
    return mb_per_s(run, "decompress", restored=True)
