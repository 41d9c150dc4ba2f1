"""The port's runtime (``x3tpu_torch.parallel.runtime``) on the CPU:
compress to raw streams and containers equal to the reference-format
oracles, decompress of the port's and x3tpu's output, the capacity
retries, x3tpu's capacity heuristic, no jax in the import, and no silent
CPU fallback for ``device="cuda"``."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from x3tpu import host, spec
from x3tpu.parallel import blocks as blk
from x3tpu.parallel import runtime as jruntime
import x3tpu_torch
from x3tpu_torch import codec
from x3tpu_torch.config import CodecCaps, X3Params
from x3tpu_torch.parallel import mesh as meshmod
from x3tpu_torch.parallel import runtime

from conftest import GOLDEN
from test_torch_codec import jax_twin
from test_torch_codec import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_compress_one_block_is_raw_stream():
    data = (GOLDEN / "text_tiny.bin").read_bytes()
    assert x3tpu_torch.compress(data, device="cpu") == spec.encode(data)


def test_compress_force_container():
    """force_container frames a single unseeded block as an X3TC container
    of one payload, byte for byte x3tpu's (x3tpu.host's stream in
    x3tpu's framing, block_bytes the input's length), and it decodes
    back."""
    data = (GOLDEN / "text_tiny.bin").read_bytes()
    params = X3Params(max_match_count=4, window=1024)
    out = x3tpu_torch.compress(data, params, force_container=True,
                               device="cpu")
    assert out == blk.pack_container([host.encode(data, jax_twin(params))],
                                     [len(data)], len(data))
    assert x3tpu_torch.decompress(out, device="cpu") == data


def test_compress_container_matches_host():
    """Three blocks in one wave: the container holds per-block streams equal
    to the native host codec's, and decodes back."""
    data = (GOLDEN / "text_small.bin").read_bytes()[:1100]
    params = X3Params(max_match_count=4, window=1024)
    stats = []
    out = x3tpu_torch.compress(data, params, block_bytes=512,
                               stats_out=stats, device="cpu")
    parts = blk.split_blocks(data, 512)
    assert len(parts) == 3
    payloads = [host.encode(p, jax_twin(params)) for p in parts]
    assert out == blk.pack_container(payloads, [len(p) for p in parts], 512)
    assert b"".join(host.decode(p) for p in payloads) == data
    assert stats[0].events.sum() > 0


def test_overflow_retry_gives_same_bytes(monkeypatch):
    """Capacities that overflow: the wave is re-run at doubled capacities
    and the output is the exact stream."""
    data = (GOLDEN / "text_small.bin").read_bytes()[:300]
    params = X3Params(max_match_count=4, window=256)
    caps = CodecCaps(dict_cap=48, pair_cap=96, ctx_items_cap=32,
                     ctx0_items_cap=32, block_bytes=1024)
    flagged = _flags_of_each_attempt(monkeypatch)
    out = x3tpu_torch.compress(data, params, caps=caps, device="cpu")
    assert flagged[0] and not flagged[-1], flagged
    assert out == host.encode(data, jax_twin(params))


def test_out_overflow_retry_gives_same_bytes(monkeypatch):
    """A stream longer than the output buffer: its words past the buffer
    are dropped and flagged, and the retry doubles the buffer's headroom
    (scaling the state capacities alone would not) and gives the exact
    stream."""
    data = np.random.default_rng(9).integers(0, 256, 180, np.uint8).tobytes()
    params = X3Params(max_match_count=4, window=256)
    caps = CodecCaps(dict_cap=256, pair_cap=1024, ctx_items_cap=64,
                     block_bytes=256, out_words_factor=1)
    assert len(host.encode(data, jax_twin(params))) > 4 * caps.out_words
    flagged = _flags_of_each_attempt(monkeypatch)
    out = x3tpu_torch.compress(data, params, caps=caps, device="cpu")
    assert flagged == [["out"], []], flagged
    assert out == host.encode(data, jax_twin(params))


def _flags_of_each_attempt(monkeypatch, name="encode_sharded"):
    """The overflow flags that fired on each attempt of a wave, recorded
    as the runtime encodes (or, with ``name="decode_sharded"``,
    decodes)."""
    flagged = []
    run = getattr(meshmod, name)

    def recording(*args):
        out = run(*args)
        flagged.append([f for f in out[4]._fields
                        if bool(getattr(out[4], f).any())])
        return out

    monkeypatch.setattr(meshmod, name, recording)
    return flagged


@pytest.mark.parametrize("kind", ["raw", "container"])
def test_decompress_round_trip(kind):
    """decompress(compress(x)) == x on the plain codec, for one block (a
    raw stream) and for three (a container)."""
    data = (GOLDEN / "text_small.bin").read_bytes()[:300]
    params = X3Params(max_match_count=4, window=256)
    block = None if kind == "raw" else 128
    out = x3tpu_torch.compress(data, params, block_bytes=block, device="cpu")
    assert blk.is_container(out) == (kind == "container")
    stats = []
    assert x3tpu_torch.decompress(out, stats_out=stats, device="cpu") == data
    assert stats[0].events.sum() > 0


def test_decompress_container_of_host_payloads():
    """A container whose payloads x3tpu's native host codec wrote, framed
    by x3tpu: the port reads both the framing and the streams."""
    data = (GOLDEN / "c_source.bin").read_bytes()[:900]
    params = jax_twin(X3Params(max_match_count=2, window=1024,
                               nl_remap=True))
    parts = blk.split_blocks(data, 300)
    payloads = [host.encode(p, params) for p in parts]
    container = blk.pack_container(payloads, [len(p) for p in parts], 300)
    assert x3tpu_torch.decompress(container, device="cpu") == data


def test_decompress_raw_out_retry(monkeypatch):
    """A raw stream whose output outgrows the guessed buffer: the lane is
    flagged, and the retry doubles block_bytes until it fits."""
    data = (GOLDEN / "text_tiny.bin").read_bytes()
    stream = host.encode(data)
    flagged = _flags_of_each_attempt(monkeypatch, "decode_sharded")
    caps = dataclasses.replace(runtime.caps_for_block(1024), block_bytes=64)
    assert x3tpu_torch.decompress(stream, caps=caps, max_output=64,
                                  device="cpu") == data
    assert flagged == [["out"], ["out"], []], flagged


@pytest.mark.parametrize("blob", [b"", b"\0", b"\0\0", b"\0\0\0", bytes(4)],
                         ids=["0", "1", "2", "3", "4"])
def test_decompress_short_streams_raise(blob):
    """x3tpu.host.decode calls each of these corrupt; so does the port: a
    raw stream under 4 bytes (the shortest valid one, an empty block's)
    raises at once, and bytes(4) decodes an event symbol past its model's
    total (the corrupt flag), where the decoder used to clamp."""
    with pytest.raises(RuntimeError, match="corrupt"):
        host.decode(blob)
    with pytest.raises(ValueError, match="malformed stream"):
        runtime.decompress(blob, device="cpu")


def test_caps_for_block_matches_x3tpu():
    for block in (1, 1000, 1 << 14, 100_000, 1 << 20, 3 << 20, 5 << 20,
                  16 << 20):
        for window in (1024, 8192, 32768):
            ours = runtime.caps_for_block(block, window=window)
            assert jax_twin(ours) == jruntime.caps_for_block(
                block, window=window), (block, window)


def test_import_and_compress_without_jax():
    code = (
        "import sys\n"
        "import x3tpu_torch\n"
        "import x3tpu_torch.__main__, x3tpu_torch.cli, x3tpu_torch.host\n"
        "import x3tpu_torch.utils.profiling, x3tpu_torch.utils.timing\n"
        "data = b'abracadabra ' * 20\n"
        "blob = x3tpu_torch.compress(data, device='cpu')\n"
        "assert x3tpu_torch.decompress(blob, device='cpu') == data\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'x3tpu'], "
        "'the JAX package was imported'\n"
        "from x3tpu import spec\n"
        "assert blob == spec.encode(data)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_cuda_without_a_card_raises():
    """device="cuda" never falls back to the plain codec."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        x3tpu_torch.compress(b"abc", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        x3tpu_torch.decompress((GOLDEN / "empty.t4_w1.x3").read_bytes(),
                               device="cuda")
    from x3tpu_torch.vm import driver

    caps = CodecCaps(block_bytes=1024)
    text, tlen = codec.pack_blocks([b"abc"], X3Params(), caps)
    with pytest.raises(ValueError, match="CUDA tensor"):
        driver.encode_blocks_cuda(torch.from_numpy(text),
                                  torch.from_numpy(tlen), X3Params(), caps)
    words = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        driver.decode_blocks_cuda(words, torch.tensor([4], dtype=torch.int32),
                                  caps)
