"""Whole runs: the refusals, and on the CPU a run of a tiny cell (added
in a temporary checkout by files and entries alone) with the program's
timed path sound, broken in each way a compressor can be, and replaced
by the reference's control."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import run as runmod
from portbench.lib.bench import Benchmark
from portbench.reference import container, x3ref
from portbench.tests.helpers import REPO, tiny_checkout


def run_script(root, *args, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", *args], cwd=root,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_refuses_without_a_card():
    """No card (none here; hidden on a card machine): a non-zero exit and
    no result, never a CPU run."""
    out = run_script(REPO, "--workload", "c16k-text", "--seed", "1",
                     "--seconds", "1", "--trace", "0",
                     env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/: no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_script(tmp_path, "--workload", "c16k-text", "--seed", "1",
                     "--seconds", "1", "--trace", "0",
                     env={"PYTHONPATH": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Benchmark(tiny_checkout(tmp_path_factory.mktemp("tiny")))


def tiny_run(bench, program=None, seed=2**31 + 3, cell="tiny-text"):
    return runmod.run_cell(bench, bench.cell(cell), seed, 0.05,
                           False, device="cpu", program=program)


def test_added_cell_runs(tiny):
    """The cell, configuration, traffic mix and metric that exist only as
    new files and entries are found by name, and the run is correct."""
    res = tiny_run(tiny)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert res["metrics"]["calls"]["value"] >= 1
    assert set(res["metrics"]) == {"compress_MBps", "decompress_MBps",
                                   "compress_p95_ms", "decompress_p95_ms",
                                   "setup_s", "calls"}
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_added_mesh_cell_runs(tiny):
    """A cell on four chips, with a traffic mix of a recipe that exists
    only as a new file: its waves run over a mesh of four devices (on the
    CPU, four "cpu" entries), and the run reports the devices it used."""
    res = tiny_run(tiny, cell="tiny-mesh")
    assert res["correct"] is True
    assert res["device"]["count"] == 4
    assert res["metrics"]["calls"]["value"] >= 1


def test_added_cell_passes_its_options(tiny):
    """A configuration's compress keywords reach every call: with
    dictionary seeds on, the containers carry seeds, which the reference
    does not train, so the run is not correct (a seeded cell needs a
    reference trainer first)."""
    seen = []

    def compress(data, **kw):
        import x3tpu_torch

        seen.append(kw.get("dict_seed"))
        return x3tpu_torch.compress(data, **kw)

    import x3tpu_torch

    res = tiny_run(tiny, runmod.Program(compress, x3tpu_torch.decompress),
                   cell="tiny-seeded")
    assert seen and all(seen)
    assert res["checks"]["decode_mismatch"]["value"] == 0
    assert res["checks"]["framing_mismatch"]["value"] >= 1
    assert res["correct"] is False


def test_added_per_layer_metric(tiny, tmp_path):
    """The per-layer metric that exists only as a new file and entry is
    listed for its cell and read from a trace."""
    from portbench.lib.trace import TraceView

    assert [m["name"] for m in tiny.metrics("tiny-text", "per_layer")] == \
        ["spans.compress"]
    assert tiny.metrics("c16k-text", "per_layer") == \
        Benchmark().metrics("c16k-text", "per_layer")
    view = TraceView([{"kind": "compress", "t0": 0.0, "t1": 1.0}], [])
    run = runmod.Run(1.0, [], view, "cpu", {})
    assert tiny.reader("spans.compress")(run) == 1.0


def broken(fault):
    """The program with one fault in its timed path (the warm-up's calls,
    the first each way, are left sound)."""
    import x3tpu_torch

    last = {"compress": 0, "decompress": 0}

    def compress(data, **kw):
        blob = x3tpu_torch.compress(data, **kw)
        last["compress"] += 1
        if fault == "stale":
            # the answer of the call before (the warm-up's, first)
            blob, last["out"] = last.get("out", blob), blob
            return blob
        if last["compress"] == 1:
            return blob
        if fault == "half":
            (_, block), blocks = container.parse(blob)
            half = blocks[: len(blocks) // 2]
            return container.pack([s for _, s in half],
                                  [o for o, _ in half], block)
        if fault == "stream_byte":
            b = bytearray(blob)
            b[-3] ^= 0x10
            return bytes(b)
        return blob

    def decompress(blob, **kw):
        out = x3tpu_torch.decompress(blob, **kw)
        last["decompress"] += 1
        if fault == "output_byte" and last["decompress"] > 1:
            b = bytearray(out)
            b[len(b) // 2] ^= 1
            return bytes(b)
        return out

    return runmod.Program(compress, decompress)


@pytest.mark.parametrize("fault", ["stale", "half", "stream_byte",
                                   "output_byte"])
def test_faults_are_not_correct(tiny, fault):
    res = tiny_run(tiny, broken(fault))
    assert res["correct"] is False


def reference_program(precision):
    """The reference in the program's place, its mode choice computed in
    ``precision``."""
    def compress(data, params, block_bytes, **kw):
        p = x3ref.Params(params.max_match_count, params.window,
                         params.magic_factor1, params.magic_factor2,
                         params.nl_remap)
        blocks = [data[i : i + block_bytes]
                  for i in range(0, len(data), block_bytes)]
        return container.pack([x3ref.encode(b, p, precision)
                               for b in blocks],
                              [len(b) for b in blocks], block_bytes)

    def decompress(blob, **kw):
        _, blocks = container.parse(blob)
        return b"".join(x3ref.decode(s) for _, s in blocks)

    return runmod.Program(compress, decompress)


def test_reference_in_the_programs_place_is_correct(tiny):
    assert tiny_run(tiny, reference_program("f32"))["correct"] is True


def test_control_is_not_correct(tmp_path):
    """The control (the reference with its mode choice in bfloat16) on
    16 KiB text blocks: its streams decode, and the comparison fails."""
    root = tiny_checkout(tmp_path)
    cfg = json.loads((root / "portbench/configs/x3-tiny.json").read_text())
    cfg.update(block_bytes=16384, warmup_block_bytes=1024, check_blocks=2,
               params={**cfg["params"], "window": 8192})
    (root / "portbench/configs/x3-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "portbench/traffic/text.json").read_text())
    traffic["pool_bytes"] = 2 * 16384
    (root / "portbench/traffic/tinytext.json").write_text(
        json.dumps(traffic))
    res = tiny_run(Benchmark(root), reference_program("bf16"), seed=3)
    assert res["checks"]["decode_mismatch"]["value"] == 0
    assert res["checks"]["stream_mismatch"]["value"] >= 1
    assert res["correct"] is False


def test_control_script_readings(tmp_path):
    """``control.py``'s readings on 16 KiB text blocks: the control fails
    the stream comparison on every seed, the reference passes it."""
    from portbench import control

    root = tiny_checkout(tmp_path)
    cfg = json.loads((root / "portbench/configs/x3-tiny.json").read_text())
    cfg.update(block_bytes=16384, check_blocks=2,
               params={**cfg["params"], "window": 8192})
    (root / "portbench/configs/x3-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "portbench/traffic/text.json").read_text())
    traffic["pool_bytes"] = 4 * 16384
    (root / "portbench/traffic/tinytext.json").write_text(
        json.dumps(traffic))
    bench = Benchmark(root)
    cell = bench.cell("tiny-text")
    for seed in (1, 2, 2**31 + 3):
        assert control.readings(bench, cell, seed)["stream_mismatch"] >= 1
        assert not any(control.readings(bench, cell, seed, "f32").values())


@pytest.mark.card
def test_cell_on_the_card(card):
    out = run_script(REPO, "--workload", "c16k-text", "--seed",
                     str(2**31 + 77), "--seconds", "3", "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) >= {"compress_MBps", "setup_s"}
