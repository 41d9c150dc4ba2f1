"""compress_MBps (MB/s): input bytes of every compress call in the window
over the sum of those calls' wall times, host clock."""

from portbench.lib.host import mb_per_s


def read(run):
    return mb_per_s(run, "compress", restored=False)
