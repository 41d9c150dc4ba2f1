"""The plain reference: the 20 golden streams both ways, the window
counts against a direct count, the control's lower precision, and the
program's CPU path against it."""

import pathlib

import numpy as np
import pytest

from portbench.reference import container, x3ref

GOLDEN = pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden"
# the paramset in each golden file's name: -t, -w (KiB), -m 0, -x
PARAMSETS = {
    "t15_w8": x3ref.Params(max_match_count=15, window=8192),
    "t4_w1": x3ref.Params(max_match_count=4, window=1024),
    "t2_w1_x": x3ref.Params(max_match_count=2, window=1024, nl_remap=True),
    "t8_w2_m0": x3ref.Params(max_match_count=8, window=2048,
                             magic_factor1=0),
}
CASES = sorted(p.name for p in GOLDEN.glob("*.x3"))


def test_twenty_golden_streams():
    assert len(CASES) == 20


@pytest.mark.parametrize("name", CASES)
def test_golden(name):
    base, pset = name[: -len(".x3")].rsplit(".", 1)
    data = (GOLDEN / f"{base}.bin").read_bytes()
    stream = (GOLDEN / name).read_bytes()
    assert x3ref.encode(data, PARAMSETS[pset]) == stream
    assert x3ref.decode(stream) == data


def direct_counts(buf, p, window):
    """backend.c's window counts at ``p``, position by position."""
    counts = [0] * x3ref.MAX_MATCH
    for s in range(p + 1, p + window - x3ref.MAX_MATCH):
        n = 0
        while n < x3ref.MAX_MATCH and buf[s + n] == buf[p + n]:
            n += 1
        for i in range(n):
            counts[i] += 1
    return counts


@pytest.mark.parametrize("window,t", [(64, 2), (128, 15), (200, 4)])
def test_candidates(window, t):
    rng = np.random.default_rng(window)
    data = bytes(rng.choice(np.frombuffer(b"abcab ", np.uint8), 700))
    buf = data + bytes(max(window, x3ref.MAX_MATCH))
    k = x3ref.candidates(np.frombuffer(buf, np.uint8), len(data), window, t)
    for p in range(len(data)):
        c = direct_counts(buf, p, window)
        tc = min(t, c[0] - 1)
        want = sum(x > tc for x in c) if tc >= 1 else 0
        assert k[p] == want, p


def test_control_differs_and_decodes():
    """The control: the mode choice in bfloat16 gives another stream of
    the same data."""
    import json

    from portbench.lib import generate

    p = json.loads((GOLDEN.parents[1] / "portbench" / "traffic" /
                    "text.json").read_text())
    text = generate.generate(p, 16384, 3)
    f32 = x3ref.encode(text)
    bf16 = x3ref.encode(text, precision="bf16")
    assert bf16 != f32
    assert x3ref.decode(bf16) == text


def test_rounding():
    assert x3ref.f32(1 / 3) == float(np.float32(1 / 3))
    assert x3ref.bf16(1 / 3) == 0.333984375
    assert x3ref.bf16(1.0) == 1.0


def test_container_roundtrip():
    blob = container.pack([b"abcd", b"xyzw1234"], [10, 20], 16)
    (count, block), blocks = container.parse(blob)
    assert (count, block) == (2, 16)
    assert blocks == [(10, b"abcd"), (20, b"xyzw1234")]
    with pytest.raises(ValueError):
        container.parse(blob[:-1])
    with pytest.raises(ValueError):
        container.parse(b"X3TC\x01\x01" + blob[6:])   # a seeded one


@pytest.mark.parametrize("traffic", ["text", "records"])
def test_program_cpu_path_matches(traffic):
    """The program's plain codec on the CPU gives the reference's streams
    (the card's kernels are held to them by the benchmark's runs)."""
    import json

    import x3tpu_torch
    from portbench.lib import generate

    p = json.loads((GOLDEN.parents[1] / "portbench" / "traffic" /
                    f"{traffic}.json").read_text())
    data = generate.generate(p, 1536, 5)
    blob = x3tpu_torch.compress(data, x3tpu_torch.X3Params(window=1024),
                                block_bytes=768, device="cpu")
    _, blocks = container.parse(blob)
    want = [x3ref.encode(data[i : i + 768], x3ref.Params(window=1024))
            for i in (0, 768)]
    assert [s for _, s in blocks] == want


def live_children() -> list:
    """This process's children that are still there (zombies too)."""
    pids = []
    for task in pathlib.Path("/proc/self/task").iterdir():
        pids += (task / "children").read_text().split()
    return pids


def test_reference_processes_all_end():
    """The reference's processes give the streams of one process, and
    none of them, nor any helper, is left when the call returns."""
    from portbench.lib import check

    rng = np.random.default_rng(7)
    blocks = [bytes(rng.choice(np.frombuffer(b"abc d", np.uint8), n))
              for n in (900, 300, 600, 450, 200)]
    params = {"window": 1024}
    before = live_children()
    assert check.reference_streams(blocks, params, workers=3) == \
        check.reference_streams(blocks, params, workers=1)
    assert live_children() == before
