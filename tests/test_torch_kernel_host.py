"""The CUDA kernels' per-lane cores (``x3tpu_torch/csrc/x3_core.cuh`` for
the encoder K1, ``x3_dec_core.cuh`` for the decoder K2) built for the host
with g++, one thread per lane, and held against the golden streams and the
plain PyTorch encoder and decoder.  This is the only route to the kernels'
logic without a GPU; no module of the package uses this build."""

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from x3tpu import host
from x3tpu_torch import codec
from x3tpu_torch.config import X3Params

from conftest import GOLDEN, PARAMSETS, golden_cases
from test_torch_codec import (OVERFLOW_FLAGS, SMALL_CAPS, SMALL_PARAMS,
                              TINY_CAPS, TINY_PARAMS, _tiny_blocks, jax_twin,
                              plain_tiny)
from test_torch_codec import one_thread  # noqa: F401  (autouse)
from test_torch_decode import (CORRUPT_CAPS, corrupt_streams, pack_streams,
                               plain_corrupt, plain_decode,
                               plain_tiny_decoded)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "x3tpu_torch" / "csrc"
FLAGS = ["-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"]


@pytest.fixture(scope="module")
def core():
    """The host build, made once per source hash and renamed into place."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    src = CSRC / "x3_core_host.cpp"
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = ROOT / "build" / "x3tpu_torch" / f"libx3core_host_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(src)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.x3h_encode.argtypes = [p, p, i, ctypes.c_longlong] + [i] * 12 + [p] * 5
    lib.x3h_encode.restype = i
    lib.x3h_decode.argtypes = [p, p] + [i] * 9 + [p] * 5
    lib.x3h_decode.restype = i
    return lib


def _encode(lib, blocks, params, caps):
    """The host core's (words, byte_lens, counts, sizes, flags) as arrays."""
    text, tlen = codec.pack_blocks(blocks, params, caps)
    lanes = len(blocks)
    words = np.zeros((lanes, caps.out_words), np.uint32)
    lens = np.zeros(lanes, np.int32)
    counts = np.zeros((lanes, 5), np.int32)
    sizes = np.zeros((lanes, 5), np.float32)
    flags = np.zeros(lanes, np.int32)
    rc = lib.x3h_encode(
        text.ctypes.data, tlen.ctypes.data, lanes, text.shape[1],
        params.max_match_count, params.window, params.magic_factor1,
        params.magic_factor2, int(params.nl_remap), caps.dict_cap,
        caps.pair_cap, caps.ctx_items_cap, caps.ctx0_items_cap,
        caps.ctx_small_cap, caps.ctx_promo_rows, caps.out_words,
        words.ctypes.data, lens.ctypes.data, counts.ctypes.data,
        sizes.ctypes.data, flags.ctypes.data)
    assert rc == 0
    return words, lens, counts, sizes, flags


@pytest.mark.parametrize("pname", sorted(PARAMSETS))
def test_core_golden_streams(core, pname):
    names = [n for n, p in golden_cases() if p == pname]
    blocks = [(GOLDEN / f"{n}.bin").read_bytes() for n in names]
    words, lens, _, _, flags = _encode(core, blocks, X3Params(**PARAMSETS[pname]),
                                       SMALL_CAPS)
    assert not flags.any()
    for i, name in enumerate(names):
        got = words[i].tobytes()[: lens[i]]
        assert got == (GOLDEN / f"{name}.{pname}.x3").read_bytes(), name


def test_core_matches_plain_with_overflow(core):
    """Every output against the plain encoder, at capacities where the
    dictionary, both context families, the pair map and the output buffer
    overflow: the kernel's flag bits (x3_core.cuh OF_*) are x3tpu's
    Overflow fields, and the words of the lanes beside the one that
    overflows its buffer are untouched."""
    plain = plain_tiny()
    words, lens, counts, sizes, flags = _encode(core, _tiny_blocks(),
                                                TINY_PARAMS, TINY_CAPS)
    np.testing.assert_array_equal(words.astype(np.int64), plain[0].numpy())
    np.testing.assert_array_equal(lens, plain[1].numpy())
    np.testing.assert_array_equal(counts, plain[2].numpy())
    np.testing.assert_allclose(sizes, plain[3].numpy(), rtol=1e-5, atol=1e-3)
    for bit, name in enumerate(OVERFLOW_FLAGS):
        fired = (flags >> bit) & 1 == 1
        np.testing.assert_array_equal(fired, getattr(plain[4], name).numpy(),
                                      err_msg=name)
        assert fired.any(), name


def _decode(lib, words, byte_lens, caps):
    """The host decoder core's (out, out_lens, counts, sizes, flags)."""
    words = np.ascontiguousarray(words, np.uint32)
    byte_lens = np.ascontiguousarray(byte_lens, np.int32)
    lanes, iw = words.shape
    out = np.zeros((lanes, caps.block_bytes), np.uint8)
    lens = np.zeros(lanes, np.int32)
    counts = np.zeros((lanes, 5), np.int32)
    sizes = np.zeros((lanes, 5), np.float32)
    flags = np.zeros(lanes, np.int32)
    rc = lib.x3h_decode(
        words.ctypes.data, byte_lens.ctypes.data, lanes, iw, caps.block_bytes,
        caps.dict_cap, caps.pair_cap, caps.ctx_items_cap, caps.ctx0_items_cap,
        caps.ctx_small_cap, caps.ctx_promo_rows, out.ctypes.data,
        lens.ctypes.data, counts.ctypes.data, sizes.ctypes.data,
        flags.ctypes.data)
    assert rc == 0
    return out, lens, counts, sizes, flags


OF_STEPS = 32  # x3_core.cuh: a lane past the event bound


@pytest.mark.parametrize("pname", sorted(PARAMSETS))
def test_core_decodes_golden_streams(core, pname):
    names = [n for n, p in golden_cases() if p == pname]
    words, byte_lens = pack_streams(
        [(GOLDEN / f"{n}.{pname}.x3").read_bytes() for n in names])
    out, lens, _, _, flags = _decode(core, words, byte_lens, SMALL_CAPS)
    assert not flags.any()
    for i, name in enumerate(names):
        assert out[i, : lens[i]].tobytes() == (
            GOLDEN / f"{name}.bin").read_bytes(), name


def test_core_decode_matches_plain_with_overflow(core):
    """plain_tiny()'s streams at TINY_CAPS (the dictionary, both context
    families and the pair map overflow; lane 3's stream is cut short):
    every output equals the plain decoder's, flag bits included."""
    words, byte_lens = plain_tiny()[:2]
    plain = plain_tiny_decoded()
    out, lens, counts, sizes, flags = _decode(core, words.numpy(),
                                              byte_lens.numpy(), TINY_CAPS)
    np.testing.assert_array_equal(out, plain[0].numpy())
    np.testing.assert_array_equal(lens, plain[1].numpy())
    np.testing.assert_array_equal(counts, plain[2].numpy())
    np.testing.assert_allclose(sizes, plain[3].numpy(), rtol=1e-5, atol=1e-3)
    for bit, name in enumerate(OVERFLOW_FLAGS):
        np.testing.assert_array_equal((flags >> bit) & 1 == 1,
                                      getattr(plain[4], name).numpy(),
                                      err_msg=name)
    assert not (flags & OF_STEPS).any()


@pytest.mark.parametrize("name", sorted(corrupt_streams()))
def test_core_corrupt_stream_matches_plain(core, name):
    """The corrupt streams end as they do in the plain decoder: the event
    bound (OF_STEPS, "malformed"), or the same flags or length."""
    words, byte_lens = pack_streams([corrupt_streams()[name]])
    _, lens, _, _, flags = _decode(core, words, byte_lens, CORRUPT_CAPS)
    if flags[0] & OF_STEPS:
        got = "malformed"
    else:
        got = tuple(n for b, n in enumerate(OVERFLOW_FLAGS)
                    if flags[0] >> b & 1) or int(lens[0])
    assert got == plain_corrupt(name)


@pytest.mark.parametrize("block", [256, 255])
def test_core_decode_write_at_buffer_edge(core, block):
    """As tests/test_torch_decode.py: the core keeps the last byte of a
    write that ends at the buffer's end, and equals the plain decoder
    one byte short of it."""
    data = (b"edge case payload " * 16)[:256]
    words, byte_lens = pack_streams([host.encode(data,
                                                 jax_twin(SMALL_PARAMS))])
    caps = dataclasses.replace(CORRUPT_CAPS, block_bytes=block)
    out, lens, _, _, flags = _decode(core, words, byte_lens, caps)
    plain = plain_decode(words, byte_lens, caps)
    np.testing.assert_array_equal(out, plain[0].numpy())
    assert lens[0] == plain[1][0] and bool(flags[0] & 16) == bool(plain[4].out[0])
    if block == len(data):
        assert out[0].tobytes() == data
