"""Several processes (the port of ``x3tpu.parallel.distributed``; no
reference counterpart: the reference is one process, one thread).

Topology: every process runs the same program on its own local devices.
x3tpu's ``jax.distributed`` gives it a global device view, over which
``global_mesh`` shards the blocks; torch has none.  Here each process
makes its mesh of its local devices (``mesh.make_mesh``), and process
``rank`` of ``world`` takes the lanes from ``rank * lanes`` on, ``lanes``
= total / world; only the in-order gather of the variable-length payloads
on process 0 crosses processes, over ``torch.distributed`` with the
``gloo`` backend: the payloads are host bytes, and NCCL refuses two ranks
on one card.

Failures are per block: a lost process loses its in-flight waves, and the
wave journal (``runtime.WaveJournal``) lets a restarted job resume after
the last completed wave.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# how long init_multihost waits for every process to join
JOIN_TIMEOUT = datetime.timedelta(minutes=5)
_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> int:
    """Join the process group (idempotent) and return this process's rank.
    With ``coordinator_address`` (``host:port``, or ``tcp://host:port``),
    ``num_processes`` and ``process_id``, the group is made there: a
    failure, or a process that does not join within JOIN_TIMEOUT, raises;
    nothing goes on alone.  With no arguments, the ``torchrun`` environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) where it is set, and
    otherwise one process (rank 0, no group)."""
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_multihost: a coordinator needs "
                             "num_processes and process_id")
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        dist.init_process_group("gloo", init_method=coordinator_address,
                                world_size=num_processes, rank=process_id,
                                timeout=JOIN_TIMEOUT)
        return dist.get_rank()
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group("gloo", init_method="env://",
                                timeout=JOIN_TIMEOUT)
        return dist.get_rank()
    return 0


def gather_payloads_in_order(local_payloads: Sequence[bytes],
                             lane_offset: int,
                             total_lanes: int) -> Optional[List[bytes]]:
    """Collect every process's payloads on process 0 in global lane order:
    this process's are lanes ``lane_offset`` on.  Lengths first (summed
    over the processes), then the bytes padded to the longest (summed on
    process 0: each lane is zero on every process but its own).  Returns
    the ordered list on process 0 and None on the others; the payloads as
    they are in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return list(local_payloads)
    lens = torch.zeros((total_lanes,), dtype=torch.int64)
    for i, p in enumerate(local_payloads):
        lens[lane_offset + i] = len(p)
    dist.all_reduce(lens)
    width = max(int(lens.max()), 1) if total_lanes else 1
    buf = torch.zeros((total_lanes, width), dtype=torch.uint8)
    for i, p in enumerate(local_payloads):
        if p:
            buf[lane_offset + i, : len(p)] = torch.frombuffer(
                bytearray(p), dtype=torch.uint8)
    dist.reduce(buf, dst=0)
    if dist.get_rank() != 0:
        return None
    data = buf.numpy()
    return [data[i, : int(lens[i])].tobytes() for i in range(total_lanes)]
