"""The port's plain PyTorch decoder (``x3tpu_torch.codec``
``decode_blocks_chunked``, the plain version of the CUDA kernel K2) against
the golden streams of the reference binary, the plain encoder's streams
and counts, and x3tpu's XLA decoder; and what it does with corrupt streams
and at the output buffer's edge.  Out, lengths, counts and overflow flags
must be equal; the f32 size estimates agree within rtol 1e-5, atol 1e-3
(x3tpu's own tolerance between its engines, tests/test_vm.py)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x3tpu import codec as jcodec
from x3tpu import host
from x3tpu_torch import codec
from x3tpu_torch.config import CodecCaps

from conftest import GOLDEN, golden_cases
from test_torch_codec import (OVERFLOW_FLAGS, SMALL_CAPS, SMALL_PARAMS,
                              TINY_CAPS, TINY_CHUNK, TINY_PARAMS, jax_twin,
                              plain_t4, plain_tiny)
from test_torch_codec import one_thread  # noqa: F401  (autouse)

# chip_smoke.py's corrupt streams, decoded here at a small block so that
# the event bound (block_bytes + 1 events) comes soon
CORRUPT_CAPS = dataclasses.replace(TINY_CAPS, block_bytes=128)


def corrupt_streams():
    """name -> stream: 4 KiB of random bytes, a golden stream cut in half,
    and 64 zero bytes (which decode to zero-length hits forever)."""
    half = (GOLDEN / "text_small.t15_w8.x3").read_bytes()
    return {
        "random": np.random.default_rng(11).integers(
            0, 256, 4096, np.uint8).tobytes(),
        "half": half[: len(half) // 2],
        "zeros": bytes(64),
    }


def pack_streams(streams):
    """(words u32 [L, IW], byte_lens i32 [L]) of byte streams."""
    iw = max(1, max((len(s) + 3) // 4 for s in streams))
    words = np.zeros((len(streams), iw), np.uint32)
    for i, s in enumerate(streams):
        arr = np.frombuffer(s + b"\0" * (-len(s) % 4), "<u4")
        words[i, : len(arr)] = arr
    return words, np.array([len(s) for s in streams], np.int32)


def plain_decode(words, byte_lens, caps):
    return codec.decode_blocks_chunked(
        torch.from_numpy(np.asarray(words).astype(np.int64)),
        torch.from_numpy(np.asarray(byte_lens).astype(np.int64)), caps)


def outcome(run):
    """What a decode comes to: "malformed" (the event bound), the overflow
    flags that fired, or the decoded length; a corrupt stream must not end
    clean with its block's length."""
    try:
        out = run()
    except ValueError as e:
        assert "malformed" in str(e)
        return "malformed"
    fired = [f for f in OVERFLOW_FLAGS if bool(getattr(out[4], f).any())]
    return tuple(fired) or int(out[1][0])


@functools.lru_cache(maxsize=None)
def plain_corrupt(name):
    return outcome(lambda: plain_decode(
        *pack_streams([corrupt_streams()[name]]), CORRUPT_CAPS))


@functools.lru_cache(maxsize=None)
def golden_decoded():
    """One plain batch: the 20 golden streams, then the plain encoder's
    streams of tests/test_codec_jax.py's batch (plain_t4() lanes 0-5;
    lanes are independent, so sharing the batch changes no lane's
    result).  Returns (golden cases, result)."""
    cases = golden_cases()
    streams = [(GOLDEN / f"{n}.{p}.x3").read_bytes() for n, p in cases]
    words, byte_lens = plain_t4()[2][:2]
    streams += codec.streams_from_words(words, byte_lens, 6)
    return cases, plain_decode(*pack_streams(streams), SMALL_CAPS)


@functools.lru_cache(maxsize=None)
def plain_tiny_decoded():
    """The plain decoder on plain_tiny()'s streams at TINY_CAPS."""
    words, byte_lens = plain_tiny()[:2]
    return plain_decode(words, byte_lens, TINY_CAPS)


@pytest.mark.parametrize("name,pname", golden_cases())
def test_golden_decode(name, pname):
    """Each golden stream decodes to its input, batched in one run."""
    cases, (out, lens, _, _, of) = golden_decoded()
    i = cases.index((name, pname))
    assert out[i, : lens[i]].numpy().tobytes() == (
        GOLDEN / f"{name}.bin").read_bytes()
    assert not of.any_flag()[i]


def test_decode_plain_encoder_streams():
    """The plain encoder's streams of tests/test_codec_jax.py's batch decode
    back, with the decoder's event counts equal to the encoder's."""
    blocks, _, (_, _, counts, _, _) = plain_t4()
    cases, (out, lens, dcounts, _, of) = golden_decoded()
    for i in range(6):
        j = len(cases) + i
        assert out[j, : lens[j]].numpy().tobytes() == blocks[i], f"block {i}"
    np.testing.assert_array_equal(dcounts.numpy()[len(cases):],
                                  counts[:6].numpy())
    assert not of.any_flag()[len(cases):].any()


def test_decode_matches_xla_tiny_caps():
    """plain_tiny()'s streams at TINY_CAPS, where the dictionary, both
    context families and the pair map overflow while decoding: out,
    lengths, counts and flags equal x3tpu's XLA decoder exactly.  Lane 3's
    stream lost its tail to the encoder's output overflow, so its decode
    reads past the end; there a payload of span 0 logs -log2(1e-38) bits,
    which XLA on the CPU flushes to zero (inf bits), so lane 3's sizes are
    left out of the size comparison."""
    words, byte_lens = plain_tiny()[:2]
    ours = plain_tiny_decoded()
    ref = jcodec.decode_blocks_chunked(
        jnp.asarray(words.numpy().astype(np.uint32)),
        jnp.asarray(byte_lens.numpy().astype(np.int32)),
        jax_twin(TINY_PARAMS), jax_twin(TINY_CAPS), chunk_steps=TINY_CHUNK)
    for what, a, b in zip(("out", "lens", "counts"), ours[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)
    keep = np.arange(len(byte_lens)) != 3
    np.testing.assert_allclose(ours[3].numpy()[keep], np.asarray(ref[3])[keep],
                               rtol=1e-5, atol=1e-3)
    for name in OVERFLOW_FLAGS:
        np.testing.assert_array_equal(getattr(ours[4], name).numpy(),
                                      np.asarray(getattr(ref[4], name)),
                                      err_msg=name)
    for name in ("dict", "ctx0", "ctx1", "pairs"):
        assert getattr(ours[4], name).any(), name


@pytest.mark.parametrize("name,want", [("half", ("out",)),
                                       ("random", "malformed"),
                                       ("zeros", "malformed")])
def test_corrupt_stream_ends(name, want):
    """A corrupt stream ends with an error to raise, never a hang: random
    bytes and zeros run into the event bound (ValueError "malformed"), the
    cut golden stream decodes past the 128-byte buffer (the out flag, an
    X3CapacityError once the retries are spent)."""
    assert plain_corrupt(name) == want


@pytest.mark.parametrize("block", [256, 255])
def test_decode_write_at_buffer_edge(block):
    """A fragment write that ends exactly at the output buffer's end keeps
    its last byte (tests/test_codec_jax.py); one byte less of buffer sets
    the out flag and ends the lane without a partial write."""
    data = (b"edge case payload " * 16)[:256]
    words, byte_lens = pack_streams([host.encode(data,
                                                 jax_twin(SMALL_PARAMS))])
    caps = CodecCaps(dict_cap=256, pair_cap=1024, ctx_items_cap=64,
                     block_bytes=block)
    out, lens, _, _, of = plain_decode(words, byte_lens, caps)
    if block == len(data):
        assert out[0, : lens[0]].numpy().tobytes() == data
        assert not of.any_flag().any()
    else:
        assert of.out.all() and lens[0] < block
        assert out[0, : lens[0]].numpy().tobytes() == data[: lens[0]]
        assert not out[0, lens[0]:].any()
