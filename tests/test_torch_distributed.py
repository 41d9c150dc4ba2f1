"""The port's processes (``x3tpu_torch.parallel.distributed``) on the CPU,
mirroring tests/test_parallel.py's distributed tests: one process is the
identity; two real processes on ``gloo`` (this file run as a script, one
process a rank) each encode their own lanes with the plain codec, and
rank 0's in-order gather is ``x3tpu.host.encode`` of every block and
decodes back."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch.distributed as tdist

from x3tpu_torch.config import CodecCaps, X3Params
from x3tpu_torch.parallel import distributed as dist
from x3tpu_torch.parallel import runtime

ROOT = pathlib.Path(__file__).resolve().parent.parent

PARAMS = X3Params(max_match_count=4, window=256)
CAPS = CodecCaps(dict_cap=256, pair_cap=1024, ctx_items_cap=64,
                 block_bytes=256)
LANES_PER_PROC = 2
WORLD = 2
BLOCKS = [f"process lane {i} payload ".encode() * (3 + 2 * i)
          for i in range(WORLD * LANES_PER_PROC)]


def test_single_process_is_the_identity(monkeypatch):
    """No coordinator and no torchrun environment: one process, rank 0,
    and the gather returns the payloads as they are."""
    for k in dist._TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert dist.init_multihost() == 0
    assert not tdist.is_initialized()
    payloads = [b"alpha", b"", b"gamma-payload"]
    assert dist.gather_payloads_in_order(payloads, 0, 3) == payloads
    with pytest.raises(ValueError, match="num_processes"):
        dist.init_multihost("localhost:1")


def test_two_processes_gather_in_order(tmp_path):
    """Two processes on localhost, each encoding its two lanes: rank 0
    gathers the four payloads in lane order, each x3tpu.host.encode's,
    and they decode back; rank 1 gets None."""
    from x3tpu import host
    from test_torch_codec import jax_twin

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(port), str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(WORLD)]
    outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank}:\n{outs[rank][-3000:]}"
    gathered = [(tmp_path / f"lane{i}.x3").read_bytes()
                for i in range(len(BLOCKS))]
    assert gathered == [host.encode(b, jax_twin(PARAMS)) for b in BLOCKS]
    back = runtime.decode_wave(gathered, [len(b) for b in BLOCKS], CAPS,
                               device="cpu")
    assert back.payloads == BLOCKS


def _worker(rank: int, port: int, outdir: pathlib.Path) -> int:
    """One rank: join the group, encode lanes rank * LANES_PER_PROC on,
    gather on rank 0, which writes each lane's payload to ``outdir``."""
    import torch

    torch.set_num_threads(1)
    assert dist.init_multihost(f"localhost:{port}", WORLD, rank) == rank
    assert dist.init_multihost() == rank   # idempotent
    lo = rank * LANES_PER_PROC
    res = runtime.encode_wave(BLOCKS[lo : lo + LANES_PER_PROC], PARAMS, CAPS,
                              device="cpu")
    gathered = dist.gather_payloads_in_order(res.payloads, lo, len(BLOCKS))
    tdist.destroy_process_group()
    if rank != 0:
        return 0 if gathered is None else 1
    for i, p in enumerate(gathered):
        (outdir / f"lane{i}.x3").write_bytes(p)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]),
                     pathlib.Path(sys.argv[3])))
