"""launches_per_call.compress (launches/call): the program's kernel launches
inside the compress spans of the traced window, a call; PyTorch's own fill
and copy kernels are not counted, retries and launch splits are."""

from portbench.lib.device import launches_per_call


def read(run):
    return launches_per_call(run, "compress")
