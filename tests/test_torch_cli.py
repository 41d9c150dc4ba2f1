"""The port's command line, ``python -m x3tpu_torch`` (``x3tpu_torch.cli``),
on the CPU (``--cpu``: the plain PyTorch codec), mirroring
tests/test_cli.py: the round trip through files, the overwrite guard, the
refusal of a suffixless input, stdin/stdout, container mode with
``--dict-seed``, the stats block against x3tpu.spec's counters, the
refusal of more devices than there are, and ``--devices 2`` over CPU
entries; and the profiler trace (``x3tpu_torch.utils.profiling``)."""

import io
import os
import pathlib
import re
import subprocess
import sys

import pytest

from x3tpu import spec
from x3tpu.config import X3Params as JX3Params
from x3tpu.parallel import blocks as jblk
from x3tpu_torch import cli
from x3tpu_torch.utils import profiling, timing

from conftest import GOLDEN
from test_torch_codec import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EVENTS = re.compile(
    r"number of events: ctx0 (\d+), ctx1 (\d+), miss1 (\d+), new (\d+)")


def test_cli_roundtrip_files(tmp_path, capsys):
    """-z adds .x3, a second -z hits the overwrite guard, -d strips .x3;
    the stats block's event counts are x3tpu.spec's for the same params."""
    data = (GOLDEN / "text_tiny.bin").read_bytes()
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    assert cli.main(["--cpu", "-z", "-t", "4", "-w", "1", str(src)]) == 0
    err = capsys.readouterr().err
    packed = (tmp_path / "in.bin.x3").read_bytes()
    assert packed == spec.encode(data, JX3Params(max_match_count=4,
                                                 window=1024))
    want = spec.encode.last_stats.events
    assert EVENTS.search(err).groups() == tuple(str(int(n))
                                                for n in want[:4])
    assert "phase timings:" in err and "max match count: 4" in err
    with pytest.raises(SystemExit) as e:
        cli.main(["--cpu", "-z", "-t", "4", "-w", "1", str(src)])
    assert e.value.code == 1
    assert "already exists" in capsys.readouterr().err
    os.unlink(src)
    assert cli.main(["--cpu", "-d", "-q", str(tmp_path / "in.bin.x3")]) == 0
    assert src.read_bytes() == data


def test_cli_decompress_suffixless_refuses(tmp_path, capsys):
    """-d on an input without a suffix refuses rather than derive the
    output name as the input itself (which would truncate it)."""
    src = tmp_path / "noext"
    src.write_bytes(b"precious original bytes")
    assert cli.main(["--cpu", "-d", "-f", str(src)]) == 1
    assert "no suffix" in capsys.readouterr().err
    assert src.read_bytes() == b"precious original bytes"


def test_cli_stdin_stdout(monkeypatch, capsysbinary):
    """python -m x3tpu_torch --cpu -q from stdin to stdout, and -d back
    the same way in this process."""
    data = b"stdin roundtrip payload " * 8
    r = subprocess.run([sys.executable, "-m", "x3tpu_torch", "--cpu", "-q",
                        "-z", "-t", "4", "-w", "1"], input=data,
                       capture_output=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout == spec.encode(data, JX3Params(max_match_count=4,
                                                   window=1024))
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(r.stdout)))
    assert cli.main(["--cpu", "-q", "-d"]) == 0
    assert capsysbinary.readouterr().out == data


def test_cli_container_mode_dict_seed(tmp_path):
    """--block-size with --dict-seed writes a seeded container (x3tpu's
    format) and -d gives the input back."""
    data = ((GOLDEN / "text_tiny.bin").read_bytes() * 8)[:1300]
    src, packed, back = (tmp_path / n for n in ("c.bin", "c.x3c", "c.out"))
    src.write_bytes(data)
    assert cli.main(["--cpu", "-q", "-z", "-f", "-t", "4", "-w", "1",
                     "--block-size", "1", "--dict-seed", "--devices", "1",
                     str(src), str(packed)]) == 0
    payloads, lens, block, _seeds, _tape = jblk.unpack_container(
        packed.read_bytes())
    assert len(payloads) == 2 and block == 1024 and _seeds
    assert cli.main(["--cpu", "-q", "-d", "-f", str(packed), str(back)]) == 0
    assert back.read_bytes() == data


def test_cli_more_than_one_device_refused(tmp_path):
    """--devices beyond the machine's card count is refused before any
    output is written; nothing runs on fewer cards or on the CPU."""
    import torch

    src = tmp_path / "a.bin"
    src.write_bytes(b"abc")
    for argv in (["--devices", str(torch.cuda.device_count() + 1)],
                 ["--cpu", "--devices", "-1"]):
        with pytest.raises(SystemExit) as e:
            cli.main([*argv, str(src)])
        assert e.value.code == 2
        assert not (tmp_path / "a.bin.x3").exists()


def test_cli_cpu_devices_round_trip(tmp_path):
    """--cpu --devices 2 --block-size 1 runs 1 KiB blocks over two CPU
    entries: x3tpu's container of x3tpu.spec's streams, and -d over the
    same mesh gives the input back."""
    data = ((GOLDEN / "text_tiny.bin").read_bytes() * 8)[:1100]
    src, packed, back = (tmp_path / n for n in ("m.bin", "m.x3", "m.out"))
    src.write_bytes(data)
    mesh = ["--cpu", "-q", "--devices", "2", "--block-size", "1"]
    assert cli.main([*mesh, "-z", "-t", "4", "-w", "1", str(src),
                     str(packed)]) == 0
    params = JX3Params(max_match_count=4, window=1024)
    parts = [data[:1024], data[1024:]]
    assert packed.read_bytes() == jblk.pack_container(
        [spec.encode(p, params) for p in parts], [1024, 76], 1024)
    assert cli.main([*mesh, "-d", str(packed), str(back)]) == 0
    assert back.read_bytes() == data


def test_profiling_trace_and_timers(tmp_path):
    """profiling.trace writes a Chrome trace with the annotated span; the
    phase timers report every phase."""
    import torch

    timers = timing.PhaseTimers()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("x3tpu_torch.codec"), timers.phase("codec"):
            torch.ones(64).cumsum(0)
    trace = (tmp_path / profiling.TRACE_FILE).read_text()
    assert "x3tpu_torch.codec" in trace
    assert "codec" in timers.report()
    assert timing.wall_clock_ns() > 0
    with profiling.trace(None):
        pass
